"""The port's Polyaxonfile reading against the JAX package's, on the CPU.

- `yaml_lite.safe_load_all` against PyYAML's `yaml.safe_load_all` on every
  file in `examples/`, every YAML block of the docs that PyYAML accepts,
  a table of YAML 1.1 scalar forms, and hypothesis-drawn documents (nested
  mappings and sequences of drawn scalars, written by `yaml.safe_dump` in
  block, flow and mixed styles, and plain scalars drawn from the forms the
  resolver tells apart; derandomized, so every run draws the same
  examples). Equality is exact (`==`, with NaN compared as NaN).
- `read_polyaxonfile` against the reference's on the examples and on
  `tests/test_polyaxonfile_fuzz.py`'s mutations: both accept with equal
  `to_dict()` (compared as JSON text, so key order and int/float count), or
  both raise `PolyaxonfileError`.
- `parse_cli_param` equal for each case; every spec class with the
  reference's fields and defaults.
"""

import copy
import dataclasses
import json
import math
import random
import re
from pathlib import Path

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from pydantic_core import PydanticUndefined

import polyaxon_tpu.schemas as jschemas
from polyaxon_tpu.polyaxonfile import read_polyaxonfile as jax_read
from polyaxon_tpu.polyaxonfile.reader import PolyaxonfileError as JaxPolyaxonfileError
from polyaxon_tpu.polyaxonfile.reader import parse_cli_param as jax_parse_cli_param
from polyaxon_tpu_torch import schemas
from polyaxon_tpu_torch.polyaxonfile import (
    PolyaxonfileError,
    check_polyaxonfile,
    parse_cli_param,
    read_polyaxonfile,
)
from polyaxon_tpu_torch.polyaxonfile import yaml_lite
from polyaxon_tpu_torch.schemas import matrix as tmatrix
from polyaxon_tpu_torch.schemas import run_kinds as trk

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((REPO / "examples").glob("*.yaml"))
DOC_BLOCKS = [
    (f"{md.name}#{i}", block)
    for md in (REPO / "docs" / "polyaxonfile.md", REPO / "docs" / "operations.md",
               REPO / "README.md")
    for i, block in enumerate(re.findall(r"```yaml\n(.*?)```", md.read_text(), re.S))
]


def _same(a, b) -> bool:
    """Structural equality with NaN equal to NaN and bool apart from int."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _pyyaml(text):
    try:
        return list(yaml.safe_load_all(text))
    except yaml.YAMLError:
        return None


def _check_against_pyyaml(text):
    want = _pyyaml(text)
    if want is None:
        return
    got = yaml_lite.safe_load_all(text)
    assert _same(got, want), (text, got, want)


# ------------------------------------------------------------------ yaml_lite
@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_yaml_lite_reads_each_example_as_pyyaml(path):
    text = path.read_text()
    assert _same(yaml_lite.safe_load_all(text), list(yaml.safe_load_all(text)))


@pytest.mark.parametrize("name,block", DOC_BLOCKS, ids=[n for n, _ in DOC_BLOCKS])
def test_yaml_lite_reads_each_doc_block_as_pyyaml(name, block):
    _check_against_pyyaml(block)


SCALARS = [
    "1e-3", "2.0e-4", "3e-4", "1.0e3", "1.5E+2", ".5", "-.inf", ".NaN", "+1", "-0", "0",
    "017", "0x1F", "0b101", "1_000", "1:30", "1:30.5", "012345", "08", "yes", "No", "ON",
    "off", "y", "n", "True", "FALSE", "~", "null", "Null", "NULL", "", "2024-01-02",
    "2001-12-14t21:59:43.10-05:00", "2001-12-14 21:59:43.10", "0.", "1.", "1.2.3",
    "v5e", "4x8", "-1", "- 1", "a b", "a  b", "a#b", "a #b", "'q'", '"d\\tq"', "'it''s'",
    "=", "<<", "[1, 2]", "{a: 1}", "[]", "{}", "https://x.org/a?b=c", "12:30:45",
]


@pytest.mark.parametrize("scalar", SCALARS)
def test_yaml_lite_resolves_scalars_as_pyyaml(scalar):
    text = f"k: {scalar}\n"
    want = _pyyaml(text)
    if want is None or scalar in ("=", "<<"):
        return  # PyYAML refuses it, or the port refuses the construct below
    assert _same(yaml_lite.safe_load_all(text), want), scalar


@pytest.mark.parametrize("text,construct", [
    ("a: &x 1\nb: *x\n", "anchors"),
    ("a: *x\n", "aliases"),
    ("a: !!str 1\n", "tags"),
    ("base: {a: 1}\nmerged:\n  <<: 1\n", "merge"),
    ("? complex\n: key\n", "complex"),
    ("%YAML 1.1\n---\na: 1\n", "directives"),
    ("a: [1, &y 2]\n", "anchors"),
])
def test_yaml_lite_refuses_constructs_by_name_and_line(text, construct):
    with pytest.raises(PolyaxonfileError, match=rf"{construct}.*\(line \d+\)"):
        yaml_lite.safe_load_all(text)


def test_yaml_lite_documents_and_block_scalars():
    text = ("# lead\n---\na: |\n  x\n   y\n\n  z\nb: >-\n  folded\n  text\n\n  para\n"
            "c: |+\n  keep\n\n---\n- 1\n- [a, b]\n...\n")
    _check_against_pyyaml(text)
    assert len(yaml_lite.safe_load_all(text)) == 2
    assert yaml_lite.safe_load("") is None
    with pytest.raises(PolyaxonfileError, match="single document"):
        yaml_lite.safe_load("a: 1\n---\nb: 2\n")


_WORDS = st.text(alphabet="abcxyz019 .:-#'\"_/", min_size=0, max_size=12)
_LEAF = st.one_of(
    st.none(), st.booleans(), st.integers(-10**6, 10**6),
    st.floats(allow_nan=False, allow_infinity=True, width=64), _WORDS,
    st.sampled_from(["yes", "off", "1e-3", "2.0e-4", "0x1F", "1:30", "~", "2024-01-02",
                     "- a", "a: b", "#c", "{{ params.lr }}", "line\nbreak", " lead", "trail "]),
)
# PyYAML writes an empty key as a complex `? ''` key, which the port refuses
_KEYS = st.one_of(_WORDS.filter(bool), st.integers(-5, 5), st.sampled_from(["on", "null", "1.5"]))
_DOCS = st.recursive(
    _LEAF,
    lambda kids: st.one_of(st.lists(kids, max_size=4),
                           st.dictionaries(_KEYS, kids, max_size=4)),
    max_leaves=20,
)


@settings(max_examples=150, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(doc=_DOCS, style=st.sampled_from([False, True, None]), width=st.sampled_from([20, 80]))
def test_yaml_lite_reads_what_pyyaml_writes(doc, style, width):
    text = yaml.safe_dump(doc, default_flow_style=style, width=width, sort_keys=False)
    _check_against_pyyaml(text)


_PLAIN = st.one_of(
    st.from_regex(r"[-+]?[0-9][0-9_]{0,3}(\.[0-9_]{0,3})?([eE][-+]?[0-9]{1,2})?", fullmatch=True),
    st.from_regex(r"[-+]?0[xbo]?[0-9a-fA-F_]{0,4}", fullmatch=True),
    st.from_regex(r"[0-9]{1,2}(:[0-9]{1,2}){1,2}(\.[0-9]*)?", fullmatch=True),
    st.from_regex(r"(yes|no|on|off|true|false|y|n|null|~)", fullmatch=True).map(
        lambda s: random.Random(s).choice([s, s.upper(), s.title()])),
    st.from_regex(r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}", fullmatch=True),
    st.from_regex(r"\.(inf|nan|Inf|NaN|INF|NAN)", fullmatch=True),
    st.from_regex(r"[a-z0-9.:/-]{1,10}", fullmatch=True),
)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(scalar=_PLAIN, flow=st.booleans())
def test_yaml_lite_resolves_drawn_plain_scalars(scalar, flow):
    text = f"k: [{scalar}, x]\n" if flow else f"k: {scalar}\n"
    try:
        want = list(yaml.safe_load_all(text))
    except (yaml.YAMLError, ValueError):  # an out-of-range date raises ValueError
        return
    assert _same(yaml_lite.safe_load_all(text), want), text


# ------------------------------------------------------------------ reader
def _both(path, **kw):
    """(ours, reference): each a to_dict() JSON text or the string 'error'."""
    out = []
    for read, err in ((read_polyaxonfile, PolyaxonfileError),
                      (jax_read, JaxPolyaxonfileError)):
        try:
            out.append(json.dumps(read(str(path), **kw).to_dict()))
        except err:
            out.append("error")
    return out


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_read_polyaxonfile_matches_the_reference_on_examples(path):
    ours, ref = _both(path)
    assert ours == ref != "error"
    ours, ref = _both(path, params={"lr": 1e-3, "steps": 5}, name="renamed")
    assert ours == ref != "error"


@pytest.mark.parametrize("seed", range(6))
def test_read_polyaxonfile_matches_the_reference_on_fuzz_mutations(tmp_path, seed):
    from test_polyaxonfile_fuzz import BASE, JUNK, _paths

    rng = random.Random(seed)
    outcomes = set()
    for trial in range(40):
        spec = copy.deepcopy(BASE)
        for _ in range(rng.randint(1, 3)):
            _, container, key = rng.choice(_paths(spec))
            action = rng.random()
            if action < 0.5:
                container[key] = rng.choice(JUNK)
            elif action < 0.8 and isinstance(container, dict):
                container.pop(key, None)
            elif isinstance(container, dict):
                container[f"fuzz_{rng.randint(0, 9)}"] = rng.choice(JUNK)
        p = tmp_path / f"fuzz_{seed}_{trial}.yaml"
        p.write_text(yaml.safe_dump(spec))
        ours, ref = _both(p)
        assert ours == ref, (trial, yaml.safe_dump(spec))
        outcomes.add(ours == "error")
    assert outcomes == {True, False}  # the mutations both pass and fail


def test_reader_fails_cleanly_like_the_reference(tmp_path):
    cases = {
        "binary.yaml": b"\x00\x01\x02\xff\xfe polyaxon",
        "deep.yaml": ("[" * 150 + "]" * 150).encode(),
        "empty.yaml": b"",
        "scalar.yaml": b"42",
        "anchor_bomb.yaml": b"a: &a [1]\nb: [*a, *a, *a]\nkind: operation",
        "kind.yaml": b"kind: frobnicate\n",
        "two.yaml": b"kind: operation\ncomponent: {run: {kind: job}}\n---\nkind: operation\n",
    }
    for name, payload in cases.items():
        p = tmp_path / name
        p.write_bytes(payload)
        assert _both(p) == ["error", "error"], name
    with pytest.raises(PolyaxonfileError, match="not found"):
        read_polyaxonfile(tmp_path / "missing.yaml")


def test_check_polyaxonfile_summaries_match():
    from polyaxon_tpu.polyaxonfile import check_polyaxonfile as jax_check

    for path in EXAMPLES:
        assert check_polyaxonfile(path) == jax_check(path), path.name


@pytest.mark.parametrize("raw", [
    "lr=0.1", "lr=1e-3", "lr=2.0e-4", "layers=[1,2]", "cfg={a: 1, b: [x]}", "flag=yes",
    "flag=off", "name=  spaced ", "empty=", "nul=~", "s='quoted'", "x=a=b", "n=017",
    "d=2024-01-02", "bad=[unclosed", "k=a: b",
])
def test_parse_cli_param_matches_the_reference(raw):
    assert _same(parse_cli_param(raw), jax_parse_cli_param(raw))


def test_parse_cli_param_needs_a_name():
    with pytest.raises(PolyaxonfileError, match="name=value"):
        parse_cli_param("novalue")


# ------------------------------------------------------------------ specs
def _spec_classes():
    from polyaxon_tpu.schemas import environment, matrix, operation, run_kinds

    pairs = []
    for jmod, tmod in ((run_kinds, trk), (matrix, tmatrix), (environment, schemas.environment),
                       (operation, schemas.operation)):
        for name in dir(jmod):
            ref = getattr(jmod, name)
            if (name.startswith("V1") and isinstance(ref, type)
                    and issubclass(ref, jschemas.BaseSchema) and ref.__module__ == jmod.__name__):
                pairs.append((name, ref, getattr(tmod, name, None)))
    for name in ("V1Component", "V1Cache", "V1Plugins", "V1Build", "V1IO", "V1Param",
                 "V1Termination"):
        pairs.append((name, getattr(jschemas, name), getattr(schemas, name, None)))
    return pairs


SPECS = _spec_classes()


@pytest.mark.parametrize("name,ref,ours", SPECS, ids=[n for n, _, _ in SPECS])
def test_every_spec_has_the_reference_fields_and_defaults(name, ref, ours):
    assert ours is not None, f"{name} is not ported"
    fields = {f.name: f for f in dataclasses.fields(ours)}
    assert list(fields) == list(ref.model_fields), name
    for f, info in ref.model_fields.items():
        if info.is_required():
            assert fields[f].default is dataclasses.MISSING, (name, f)
        elif info.default_factory is not None:
            assert fields[f].default_factory() == info.default_factory(), (name, f)
        elif info.default is not PydanticUndefined:
            assert fields[f].default == info.default, (name, f)


@pytest.mark.parametrize("doc,match", [
    ({"kind": "operation", "component": {"run": {"kind": "jaxjob"}}}, "program"),
    ({"kind": "operation", "component": {"run": {"kind": "nope"}}}, "tag"),
    ({"kind": "operation", "component": {"run": {}}}, "discriminator"),
    ({"kind": "operation", "component": {"run": {"kind": "jaxjob", "replicas": 0,
                                                  "program": {"model": {"name": "m"}}}}},
     "greater than or equal to 1"),
    ({"kind": "operation", "typo": 1}, "Extra inputs are not permitted"),
    ({"kind": "operation", "matrix": {"kind": "grid", "params": {
        "x": {"kind": "uniform", "value": {"low": 0, "high": 1}}}}}, "must be discrete"),
])
def test_validation_errors_name_the_location(doc, match):
    with pytest.raises(ValueError, match=match) as ours:
        schemas.V1Operation.from_dict(doc)
    with pytest.raises(ValueError):
        jschemas.V1Operation.model_validate(doc)
    assert isinstance(ours.value, schemas.SpecError) and ours.value.errors
