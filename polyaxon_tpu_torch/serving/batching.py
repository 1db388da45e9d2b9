"""Serving configuration and the client-visible error (own minimal copy of
the parts of `polyaxon_tpu/serving/batching.py` the per-request path uses)."""

from __future__ import annotations

import dataclasses


class ServingError(RuntimeError):
    """Client-visible serving failure; the HTTP layer maps it to 400."""


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Knobs of the per-request serving path.

    `max_batch` caps the rows of one request: each row holds a dense
    [seq_len, n_kv, hd] cache per layer for the whole decode."""

    max_batch: int = 8
