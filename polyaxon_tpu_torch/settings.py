"""Client settings: the layered `home` lookup of `polyaxon_tpu/settings.py`
(an own copy; the port imports nothing of the JAX package).

`home` (the run store's location) comes from the environment
(`POLYAXON_HOME`) first, then the user config file
(`$POLYAXON_CONFIG_DIR/config.json`, default `~/.polyaxon/config.json`),
then the default `~/.polyaxon` — the reference's default, so both packages
find one store. The other keys of the reference's settings (project,
streams_url, queue) belong to its CLI, which is not ported.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Optional

KNOWN_KEYS = ("home",)

_ENV_MAP = {"home": "POLYAXON_HOME"}


_DEFAULTS = {"home": str(Path.home() / ".polyaxon")}


def config_dir() -> Path:
    return Path(os.environ.get("POLYAXON_CONFIG_DIR", str(Path.home() / ".polyaxon")))


def config_path() -> Path:
    return config_dir() / "config.json"


def read_file_config() -> dict:
    p = config_path()
    if p.exists():
        try:
            return json.loads(p.read_text())
        except (OSError, json.JSONDecodeError):
            return {}
    return {}


def get(key: str) -> Optional[Any]:
    if key not in KNOWN_KEYS:
        raise KeyError(f"unknown setting {key!r}; one of {KNOWN_KEYS}")
    env = os.environ.get(_ENV_MAP[key])
    if env is not None:
        return env
    file_cfg = read_file_config()
    if key in file_cfg:
        return file_cfg[key]
    return _DEFAULTS[key]
