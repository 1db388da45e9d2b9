"""A YAML reader for the subset Polyaxonfiles use, in place of PyYAML's
`safe_load_all` (the port does not depend on PyYAML).

What it reads:
- block mappings and sequences (a sequence may sit at its key's
  indentation, as PyYAML writes them), flow mappings and sequences, which
  may span lines;
- plain scalars (folded across lines), single- and double-quoted scalars
  with their escapes and folding;
- `#` comments, `---` between documents and `...` after one;
- `|` and `>` block scalars with their chomping (`-`, `+`) and
  indentation indicators.

Plain scalars resolve as PyYAML's YAML 1.1 resolver resolves them: `1e-3`
stays the string '1e-3' (its float pattern needs a dot and a signed
exponent), `2.0e-4` is a float, `yes`/`on`/`off` are booleans, `0x1F`,
`0o17`-less octals (`017`), `1_000` and sexagesimal `1:30` are ints,
`2024-01-02` is a `datetime.date`, and `~`, `null` and the empty value are
None. Keys resolve the same way.

Anchors, aliases, tags, merge keys, complex (`?`) keys and directives
raise `YAMLError` (a `PolyaxonfileError`) naming the construct and its
line.
"""

from __future__ import annotations

import datetime
import re
from typing import Any


class PolyaxonfileError(Exception):
    pass


class YAMLError(PolyaxonfileError):
    def __init__(self, message: str, line: int | None = None):
        super().__init__(f"{message} (line {line})" if line is not None else message)


# ------------------------------------------------------------ the resolver
_BOOL_RE = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                      r"|on|On|ON|off|Off|OFF)$")
_FLOAT_RE = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT_RE = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP_RE = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_TIMESTAMP_PARTS = re.compile(r"""^(?P<year>[0-9][0-9][0-9][0-9])
                -(?P<month>[0-9][0-9]?)
                -(?P<day>[0-9][0-9]?)
                (?:(?:[Tt]|[ \t]+)
                (?P<hour>[0-9][0-9]?)
                :(?P<minute>[0-9][0-9])
                :(?P<second>[0-9][0-9])
                (?:\.(?P<fraction>[0-9]*))?
                (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
                (?::(?P<tz_minute>[0-9][0-9]))?))?)?$""", re.X)

# PyYAML's implicit resolvers, in the order it registers them, each with
# the first characters it is tried for
_RESOLVERS = (
    ("bool", _BOOL_RE, "yYnNtTfFoO"),
    ("float", _FLOAT_RE, "-+0123456789."),
    ("int", _INT_RE, "-+0123456789"),
    ("merge", re.compile(r"^(?:<<)$"), "<"),
    ("null", _NULL_RE, "~nN"),
    ("timestamp", _TIMESTAMP_RE, "0123456789"),
    ("value", re.compile(r"^(?:=)$"), "="),
)


def _sexagesimal(value: str, conv):
    out = conv(0)
    base = 1
    for part in reversed(value.split(":")):
        out += conv(part) * base
        base *= 60
    return out


def _to_int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _to_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def _to_timestamp(value: str):
    v = _TIMESTAMP_PARTS.match(value).groupdict()
    year, month, day = int(v["year"]), int(v["month"]), int(v["day"])
    if not v["hour"]:
        return datetime.date(year, month, day)
    fraction = 0
    if v["fraction"]:
        fraction = int(v["fraction"][:6].ljust(6, "0"))
    tzinfo = None
    if v["tz_sign"]:
        delta = datetime.timedelta(hours=int(v["tz_hour"]), minutes=int(v["tz_minute"] or 0))
        tzinfo = datetime.timezone(-delta if v["tz_sign"] == "-" else delta)
    elif v["tz"]:
        tzinfo = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(v["hour"]), int(v["minute"]),
                             int(v["second"]), fraction, tzinfo=tzinfo)


def resolve_plain(value: str, line: int | None = None) -> Any:
    """A plain scalar's value under PyYAML's YAML 1.1 resolver."""
    first = value[:1]
    for kind, pattern, firsts in _RESOLVERS:
        if (first in firsts if first else kind == "null") and pattern.match(value):
            if kind == "bool":
                return value.lower() in ("yes", "true", "on")
            if kind == "float":
                return _to_float(value)
            if kind == "int":
                return _to_int(value)
            if kind == "null":
                return None
            if kind == "timestamp":
                return _to_timestamp(value)
            if kind == "merge":
                raise YAMLError("merge keys (<<) are not supported", line)
            raise YAMLError("the value key (=) is not supported", line)
    return value


# ---------------------------------------------------------------- the loader
_NON_PRINTABLE = re.compile(
    "[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\uD7FF\uE000-\uFFFD\U00010000-\U0010ffff]"
)
_ESCAPES = {
    "0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
    "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
    "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029",
}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_FLOW_INDICATORS = ",[]{}"
_CONSTRUCTS = {"&": "anchors (&)", "*": "aliases (*)", "!": "tags (!)"}


def _indent(line: str) -> int:
    return len(line) - len(line.lstrip(" "))


def _blank(line: str) -> bool:
    s = line.strip(" \t")
    return not s or s.startswith("#")


def _is_entry(content: str) -> bool:
    """A block sequence entry: `-` then a space or the end of the line."""
    return content == "-" or content.startswith(("- ", "-\t"))


def _comment_at(text: str, start: int = 0) -> int:
    """Index of a `#` that starts a comment (after whitespace or at the
    start), or len(text)."""
    for i in range(start, len(text)):
        if text[i] == "#" and (i == 0 or text[i - 1] in " \t"):
            return i
    return len(text)


class _Loader:
    def __init__(self, lines: list[str], first_line: int):
        self.lines = lines
        self.base = first_line  # 1-based number of lines[0]
        self.i = 0

    # ----------------------------------------------------------- helpers
    def lineno(self, i: int | None = None) -> int:
        return self.base + (self.i if i is None else i)

    def fail(self, message: str, i: int | None = None):
        raise YAMLError(message, self.lineno(i))

    def eof(self) -> bool:
        return self.i >= len(self.lines)

    def skip_blank(self) -> None:
        while not self.eof() and _blank(self.lines[self.i]):
            self.i += 1

    def check_indent(self, line: str) -> None:
        head = line[: len(line) - len(line.lstrip(" \t"))]
        if "\t" in head:
            self.fail("tabs are not allowed in indentation")

    def expect_end(self, rest: str, what: str) -> None:
        s = rest.strip(" \t")
        if s and not s.startswith("#"):
            self.fail(f"unexpected {s[:20]!r} after {what}")

    # -------------------------------------------------------- documents
    def document(self) -> Any:
        self.skip_blank()
        if self.eof():
            return None
        node = self.block_node(-1)
        self.skip_blank()
        if not self.eof():
            self.fail("unexpected content after the document's root node")
        return node

    # ------------------------------------------------------------ block
    def block_node(self, parent: int) -> Any:
        """The node starting on the current (non-blank) line, which is
        indented more than `parent`."""
        line = self.lines[self.i]
        self.check_indent(line)
        ind = _indent(line)
        content = line[ind:]
        if _is_entry(content):
            return self.block_sequence(ind)
        self.refuse_constructs(content)
        if content.startswith("? ") or content == "?":
            self.fail("complex mapping keys (?) are not supported")
        if self.mapping_key(content) is not None:
            return self.block_mapping(ind)
        return self.inline(parent, ind)

    def refuse_constructs(self, content: str) -> None:
        if content[:1] in _CONSTRUCTS:
            self.fail(f"{_CONSTRUCTS[content[0]]} are not supported")
        if content[:1] in "%@`":
            self.fail(f"a plain scalar cannot start with {content[0]!r}")

    def block_sequence(self, ind: int) -> list:
        out = []
        while True:
            self.skip_blank()
            if self.eof():
                break
            line = self.lines[self.i]
            self.check_indent(line)
            li = _indent(line)
            if li < ind:
                break
            content = line[li:]
            if li > ind or not _is_entry(content):
                if li == ind:
                    break
                self.fail("bad indentation of a sequence entry")
            rest = content[1:]
            if rest.strip(" \t") == "" or rest.strip(" \t").startswith("#"):
                self.i += 1
                self.skip_blank()
                if self.eof() or _indent(self.lines[self.i]) <= ind:
                    out.append(None)
                else:
                    out.append(self.block_node(ind))
                continue
            # the entry's content starts on this line: blank out the "-" so
            # the content reads as a node at its own column
            self.lines[self.i] = " " * (li + 1) + rest
            col = _indent(self.lines[self.i])
            content = self.lines[self.i][col:]
            if _is_entry(content):
                out.append(self.block_sequence(col))
            elif self.mapping_key(content) is not None:
                out.append(self.block_mapping(col))
            else:
                self.refuse_constructs(content)
                out.append(self.inline(ind, col))
        return out

    def mapping_key(self, content: str):
        """(key, offset just past the `:`) when `content` starts with a
        simple mapping key, else None."""
        if not content or content[0] in "[{":
            return None
        if content[0] in "\"'":
            try:
                key, end = _quoted_line(content, 0)
            except ValueError:
                return None
            j = end
            while j < len(content) and content[j] in " \t":
                j += 1
            if j < len(content) and content[j] == ":" and (
                j + 1 == len(content) or content[j + 1] in " \t"
            ):
                return key, j + 1
            return None
        if content[0] in "#&*!|>%@`" or (
            content[0] in "-?:" and (len(content) == 1 or content[1] in " \t")
        ):
            return None
        end = _comment_at(content)
        j = 0
        while True:
            j = content.find(":", j)
            if j < 0 or j >= end:
                return None
            if j + 1 == len(content) or content[j + 1] in " \t":
                raw = content[:j].rstrip(" \t")
                return resolve_plain(raw, self.lineno()), j + 1
            j += 1

    def block_mapping(self, ind: int) -> dict:
        out: dict = {}
        while True:
            self.skip_blank()
            if self.eof():
                break
            line = self.lines[self.i]
            self.check_indent(line)
            li = _indent(line)
            if li < ind:
                break
            if li > ind:
                self.fail("bad indentation of a mapping entry")
            content = line[li:]
            if _is_entry(content):
                self.fail("a sequence entry where a mapping key was expected")
            self.refuse_constructs(content)
            if content.startswith("? ") or content == "?":
                self.fail("complex mapping keys (?) are not supported")
            kv = self.mapping_key(content)
            if kv is None:
                self.fail(f"expected a mapping key, found {content[:20]!r}")
            key, off = kv
            try:
                hash(key)
            except TypeError:
                self.fail("unhashable mapping key")
            out[key] = self.value_after(ind, li + off)
        return out

    def value_after(self, parent: int, col: int) -> Any:
        """The value of a key whose `:` ends just before column `col` of
        the current line."""
        line = self.lines[self.i]
        rest = line[col:]
        s = rest.strip(" \t")
        if not s or s.startswith("#"):
            self.i += 1
            self.skip_blank()
            if self.eof():
                return None
            nxt = self.lines[self.i]
            li = _indent(nxt)
            if li > parent:
                return self.block_node(parent)
            if li == parent and _is_entry(nxt[li:]):
                return self.block_sequence(li)
            return None
        start = col + len(rest) - len(rest.lstrip(" \t"))
        self.refuse_constructs(line[start:])
        return self.inline(parent, start)

    def inline(self, parent: int, col: int) -> Any:
        """A scalar or flow node starting at column `col` of the current
        line; leaves the cursor on the line after it."""
        line = self.lines[self.i]
        c = line[col]
        if c in "|>":
            return self.block_scalar(parent, col)
        if c in "[{":
            return self.flow(col)
        if c in "\"'":
            return self.quoted(col)
        return self.plain(parent, col)

    def plain(self, parent: int, col: int) -> Any:
        line = self.lines[self.i]
        text = line[col:]
        cut = _comment_at(text)
        first = text[:cut].rstrip(" \t")
        self.check_plain(first)
        start = self.i
        self.i += 1
        parts = [first]
        if cut == len(text):  # no comment: the scalar may go on
            breaks = 0
            while not self.eof():
                nxt = self.lines[self.i]
                if not nxt.strip(" \t"):
                    breaks += 1
                    self.i += 1
                    continue
                if _indent(nxt) <= parent or nxt.lstrip(" \t").startswith("#"):
                    break
                body = nxt.strip(" \t")
                c2 = _comment_at(body)
                more = body[:c2].rstrip(" \t")
                self.check_plain(more, continuation=True)
                parts.append("\n" * breaks if breaks else " ")
                parts.append(more)
                breaks = 0
                self.i += 1
                if c2 < len(body):
                    break
        if len(parts) == 1:
            return resolve_plain(first, self.lineno(start))
        return resolve_plain("".join(parts), self.lineno(start))

    def check_plain(self, text: str, continuation: bool = False) -> None:
        if ": " in text or ":\t" in text or text.endswith(":"):
            self.fail("mapping values are not allowed here")
        if not continuation and _is_entry(text):
            self.fail("a block sequence entry is not allowed here")

    def quoted(self, col: int) -> str:
        text = "\n".join(self.lines[self.i:])
        try:
            value, end = _quoted(text, col)
        except ValueError as e:
            self.fail(str(e))
        consumed = text.count("\n", 0, end)
        line_end = text.find("\n", end)
        rest = text[end:] if line_end < 0 else text[end:line_end]
        self.i += consumed
        self.expect_end(rest, "a quoted scalar")
        self.i += 1
        return value

    def flow(self, col: int) -> Any:
        text = "\n".join(self.lines[self.i:])
        parser = _Flow(text, self.lineno())
        value = parser.node(col)
        end = parser.pos
        consumed = text.count("\n", 0, end)
        line_end = text.find("\n", end)
        rest = text[end:] if line_end < 0 else text[end:line_end]
        self.i += consumed
        self.expect_end(rest, "a flow collection")
        self.i += 1
        return value

    def block_scalar(self, parent: int, col: int) -> str:
        line = self.lines[self.i]
        header = line[col:]
        folded = header[0] == ">"
        chomping, increment = None, None
        j = 1
        for _ in range(2):
            if j < len(header) and header[j] in "+-":
                if chomping is not None:
                    self.fail("repeated chomping indicator")
                chomping = header[j] == "+"
                j += 1
            elif j < len(header) and header[j] in "123456789":
                if increment is not None:
                    self.fail("repeated indentation indicator")
                increment = int(header[j])
                j += 1
        rest = header[j:]
        if rest and rest[0] not in " \t":
            self.fail("expected a chomping or indentation indicator")
        self.expect_end(rest, "a block scalar header")
        self.i += 1
        min_indent = max(parent + 1, 1)
        if increment is None:
            max_indent = 0
            k = self.i
            while k < len(self.lines) and not self.lines[k].strip(" "):
                max_indent = max(max_indent, len(self.lines[k]))
                k += 1
            if k < len(self.lines):
                max_indent = max(max_indent, _indent(self.lines[k]))
            indent = max(min_indent, max_indent)
        else:
            indent = min_indent + increment - 1
        chunks: list[str] = []
        breaks = self._empty_lines(indent)
        line_break = ""
        while not self.eof() and _indent(self.lines[self.i]) >= indent:
            chunks.extend(breaks)
            body = self.lines[self.i][indent:]
            leading_non_space = body[:1] not in (" ", "\t")
            chunks.append(body)
            self.i += 1
            # the last line of `lines` is the "" after a final newline
            line_break = "\n" if self.i < len(self.lines) else ""
            breaks = self._empty_lines(indent)
            if self.eof() or _indent(self.lines[self.i]) < indent:
                break
            if (folded and line_break and leading_non_space
                    and self.lines[self.i][indent:indent + 1] not in (" ", "\t")):
                if not breaks:
                    chunks.append(" ")
            else:
                chunks.append(line_break)
        if chomping is not False:
            chunks.append(line_break)
        if chomping is True:
            chunks.extend(breaks)
        return "".join(chunks)

    def _empty_lines(self, indent: int) -> list[str]:
        """Consume the empty lines ahead (spaces up to `indent` only), one
        newline each; the "" after a final newline is not a line."""
        out = []
        while self.i < len(self.lines) - 1 or (
            self.i == len(self.lines) - 1 and self.lines[self.i]
        ):
            cur = self.lines[self.i]
            if cur.strip(" ") or len(cur) > indent:
                break
            out.append("\n")
            self.i += 1
        if self.i == len(self.lines) - 1 and not self.lines[self.i]:
            self.i += 1
        return out


# ------------------------------------------------------------ quoted scalars
def _quoted_line(text: str, start: int) -> tuple[str, int]:
    """A quoted scalar that closes on its own line."""
    end_line = text.find("\n", start)
    return _quoted(text if end_line < 0 else text[:end_line], start)


def _breaks(text: str, i: int) -> tuple[list[str], int]:
    """The line breaks after a break inside a quoted scalar, each empty
    line one newline; whitespace around them is dropped."""
    out = []
    while True:
        if (i == 0 or text[i - 1] == "\n") and text[i:i + 3] in ("---", "...") and (
            text[i + 3:i + 4] in ("", " ", "\t", "\n")
        ):
            raise ValueError("a document separator inside a quoted scalar")
        while i < len(text) and text[i] in " \t":
            i += 1
        if i < len(text) and text[i] == "\n":
            out.append("\n")
            i += 1
        else:
            return out, i


def _quoted(text: str, start: int) -> tuple[str, int]:
    """(value, index after the closing quote) of the quoted scalar at
    `text[start]`, folded as PyYAML folds it; ValueError when it does not
    close or holds a bad escape."""
    q = text[start]
    double = q == '"'
    stops = " \t\n" + ('"\\' if double else "'")
    i, n = start + 1, len(text)
    chunks: list[str] = []
    while True:
        j = i
        while j < n and text[j] not in stops:
            j += 1
        chunks.append(text[i:j])
        i = j
        if i >= n:
            raise ValueError("a quoted scalar does not close")
        c = text[i]
        if c == q:
            if not double and text[i + 1:i + 2] == "'":
                chunks.append("'")
                i += 2
                continue
            return "".join(chunks), i + 1
        if c == "\\":
            e = text[i + 1:i + 2]
            if e in _ESCAPES:
                chunks.append(_ESCAPES[e])
                i += 2
            elif e in _HEX_ESCAPES:
                k = _HEX_ESCAPES[e]
                digits = text[i + 2:i + 2 + k]
                if len(digits) != k or any(d not in "0123456789abcdefABCDEF" for d in digits):
                    raise ValueError(f"bad escape \\{e}{digits}")
                chunks.append(chr(int(digits, 16)))
                i += 2 + k
            elif e == "\n":
                # an escaped line break: the lines join with no space
                more, i = _breaks(text, i + 2)
                chunks.extend(more)
            else:
                raise ValueError(f"unknown escape \\{e}")
            continue
        # whitespace, maybe a line break
        j = i
        while j < n and text[j] in " \t":
            j += 1
        ws, i = text[i:j], j
        if i >= n:
            raise ValueError("a quoted scalar does not close")
        if text[i] == "\n":
            more, i = _breaks(text, i + 1)
            chunks.append("".join(more) if more else " ")
        else:
            chunks.append(ws)


# ---------------------------------------------------------------- flow nodes
class _Flow:
    def __init__(self, text: str, first_line: int):
        self.text = text
        self.pos = 0
        self.first_line = first_line

    def fail(self, message: str):
        raise YAMLError(message, self.first_line + self.text.count("\n", 0, self.pos))

    def skip(self) -> None:
        t = self.text
        while self.pos < len(t):
            c = t[self.pos]
            if c in " \t\n":
                self.pos += 1
            elif c == "#" and (self.pos == 0 or t[self.pos - 1] in " \t\n"):
                nl = t.find("\n", self.pos)
                self.pos = len(t) if nl < 0 else nl
            else:
                break

    def peek(self) -> str:
        return self.text[self.pos: self.pos + 1]

    def node(self, start: int) -> Any:
        self.pos = start
        return self.value()

    def value(self) -> Any:
        self.skip()
        c = self.peek()
        if not c:
            self.fail("a flow collection does not close")
        if c == "[":
            return self.sequence()
        if c == "{":
            return self.mapping()
        if c in "\"'":
            try:
                v, end = _quoted(self.text, self.pos)
            except ValueError as e:
                self.fail(str(e))
            self.pos = end
            return v
        if c in _CONSTRUCTS:
            self.fail(f"{_CONSTRUCTS[c]} are not supported")
        if c in "]},":
            self.fail(f"unexpected {c!r} in a flow collection")
        return self.plain()

    def plain(self) -> Any:
        t = self.text
        start_line = self.first_line + t.count("\n", 0, self.pos)
        lines = [[]]
        while self.pos < len(t):
            c = t[self.pos]
            if c in _FLOW_INDICATORS or c == "?":
                break
            if c == ":" and t[self.pos + 1:self.pos + 2] in ("", " ", "\t", "\n", *_FLOW_INDICATORS):
                break
            if c == "#" and self.pos > 0 and t[self.pos - 1] in " \t\n":
                break
            if c == "\n":
                lines.append([])
            else:
                lines[-1].append(c)
            self.pos += 1
        parts = ["".join(ln).strip(" \t") for ln in lines]
        while len(parts) > 1 and not parts[-1]:
            parts.pop()
        out, empties = parts[0], 0
        for part in parts[1:]:
            if not part:
                empties += 1
                continue
            out += ("\n" * empties if empties else " ") + part
            empties = 0
        return resolve_plain(out, start_line)

    def sequence(self) -> list:
        self.pos += 1
        out = []
        while True:
            self.skip()
            c = self.peek()
            if c == "]":
                self.pos += 1
                return out
            item = self.value()
            self.skip()
            if self.peek() == ":":
                # a single-pair mapping inside a flow sequence
                self.pos += 1
                self.skip()
                v = None if self.peek() in (",", "]") else self.value()
                _hashable(self, item)
                item = {item: v}
                self.skip()
            out.append(item)
            c = self.peek()
            if c == ",":
                self.pos += 1
            elif c != "]":
                self.fail("expected ',' or ']' in a flow sequence")

    def mapping(self) -> dict:
        self.pos += 1
        out: dict = {}
        while True:
            self.skip()
            c = self.peek()
            if c == "}":
                self.pos += 1
                return out
            if c == "?" and self.text[self.pos + 1: self.pos + 2] in (" ", "\n", "\t"):
                self.fail("complex mapping keys (?) are not supported")
            key = self.value()
            _hashable(self, key)
            self.skip()
            value = None
            if self.peek() == ":":
                self.pos += 1
                self.skip()
                if self.peek() not in (",", "}"):
                    value = self.value()
                    self.skip()
            out[key] = value
            c = self.peek()
            if c == ",":
                self.pos += 1
            elif c != "}":
                self.fail("expected ',' or '}' in a flow mapping")


def _hashable(parser: _Flow, key) -> None:
    try:
        hash(key)
    except TypeError:
        parser.fail("unhashable mapping key")


# ------------------------------------------------------------------ the API
def _documents(text: str) -> list[tuple[int, list[str]]]:
    """(first line number, lines) of each document of the stream. A
    document closed by a marker gets a final "" line, as the split of a
    text that ends in a newline does: its last line had a break."""
    docs: list[tuple[int, list[str]]] = []
    cur: list[str] = []
    start = 1
    explicit = False  # the current document was opened by `---`

    def close():
        if explicit or any(not _blank(ln) for ln in cur):
            docs.append((start, cur + [""]))

    for n, line in enumerate(text.split("\n"), 1):
        if line.startswith("%"):
            raise YAMLError("directives (%) are not supported", n)
        if line == "---" or line.startswith(("--- ", "---\t")):
            close()
            start, cur, explicit = n, [" " * 3 + line[3:]], True
            continue
        if line == "..." or line.startswith(("... ", "...\t")):
            tail = line[3:].strip(" \t")
            if tail and not tail.startswith("#"):
                raise YAMLError("content after a document end marker", n)
            close()
            start, cur, explicit = n + 1, [], False
            continue
        if not cur:
            start = n
        cur.append(line)
    if explicit or any(not _blank(ln) for ln in cur):
        docs.append((start, cur))
    return docs


def safe_load_all(text: str) -> list:
    """Every document of `text`, as `list(yaml.safe_load_all(text))`."""
    text = text.replace("\r\n", "\n").replace("\r", "\n")
    if text.startswith("\ufeff"):
        text = text[1:]
    bad = _NON_PRINTABLE.search(text)
    if bad:
        raise YAMLError(
            f"unacceptable character {bad.group()!r}", text.count("\n", 0, bad.start()) + 1
        )
    out = []
    for first, lines in _documents(text):
        if not any(not _blank(ln) for ln in lines):
            out.append(None)
            continue
        try:
            out.append(_Loader(lines, first).document())
        except RecursionError:
            raise YAMLError("nesting too deep", first) from None
    return out


def safe_load(text: str) -> Any:
    """The one document of `text` (None when there is none), as
    `yaml.safe_load`."""
    docs = safe_load_all(text)
    if len(docs) > 1:
        raise YAMLError("expected a single document in the stream")
    return docs[0] if docs else None
