"""Length + CRC32 framed records, an own copy of `frame` and `scan_frames`
from `polyaxon_tpu/store/eventlog.py` (the port imports nothing of the JAX
package). The spill tier's disk segments use this framing, so a segment
written by either package reads back in the other."""

from __future__ import annotations

import struct
import zlib

_HEADER = struct.Struct("<II")  # payload length, crc32(payload)
_MAX_FRAME = 16 * 1024 * 1024


def frame(payload: bytes) -> bytes:
    return _HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def scan_frames(data: bytes) -> tuple[list[bytes], str, int]:
    """Walk framed records. Returns (payloads, verdict, good_end).

    verdict "clean":   every byte accounted for.
    verdict "torn":    valid prefix, then an incomplete/bad frame that
                       reaches EOF — the signature of a crash mid-append.
                       Recovery truncates to good_end.
    verdict "corrupt": a bad frame with MORE data after it — bit rot or a
                       scribble, not a torn write. Recovery quarantines.
    """
    payloads: list[bytes] = []
    off = 0
    n = len(data)
    while off < n:
        if off + _HEADER.size > n:
            return payloads, "torn", off
        length, crc = _HEADER.unpack_from(data, off)
        end = off + _HEADER.size + length
        if length > _MAX_FRAME and end <= n:
            return payloads, "corrupt", off
        if end > n:
            return payloads, "torn", off
        payload = data[off + _HEADER.size : end]
        if zlib.crc32(payload) != crc:
            return payloads, ("torn" if end == n else "corrupt"), off
        payloads.append(payload)
        off = end
    return payloads, "clean", off
