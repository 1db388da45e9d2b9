"""Client settings: layered config (env > user config file > defaults),
an own copy of `polyaxon_tpu/settings.py`. Keys:

  home            run-store location         (env POLYAXON_HOME)
  project         default project            (env POLYAXON_PROJECT)
  streams_url     remote streams service     (env POLYAXON_STREAMS_URL)
  queue           default submit queue       (env POLYAXON_QUEUE)

`config set key value` persists to the user config file
(`~/.polyaxon/config.json`, or `$POLYAXON_CONFIG_DIR/config.json`), the
same file and defaults as the reference's, so both packages find one
store.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Optional

KNOWN_KEYS = ("home", "project", "streams_url", "queue")

_ENV_MAP = {
    "home": "POLYAXON_HOME",
    "project": "POLYAXON_PROJECT",
    "streams_url": "POLYAXON_STREAMS_URL",
    "queue": "POLYAXON_QUEUE",
}

_DEFAULTS = {
    "home": str(Path.home() / ".polyaxon"),
    "project": "default",
    "streams_url": None,
    "queue": "default",
}


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


def set_value(key: str, value: Any) -> None:
    if key not in KNOWN_KEYS:
        raise KeyError(f"unknown setting {key!r}; one of {KNOWN_KEYS}")
    cfg = read_file_config()
    cfg[key] = value
    config_dir().mkdir(parents=True, exist_ok=True)
    config_path().write_text(json.dumps(cfg, indent=1))


def unset(key: str) -> None:
    cfg = read_file_config()
    cfg.pop(key, None)
    config_path().parent.mkdir(parents=True, exist_ok=True)
    config_path().write_text(json.dumps(cfg, indent=1))


def show() -> dict:
    return {k: get(k) for k in KNOWN_KEYS}
