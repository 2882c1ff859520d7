"""Environment variable config tier (copy of granite_tpu/utils/environment.py;
reference: util/environment.cpp:47).

Granite reads GRANITE_* env vars via Util::get_environment; we keep the same
names where behavior carries over (e.g. GRANITE_NUM_WORKER_THREADS).
"""

from __future__ import annotations

import os


def get_environment(name: str, default: str = "") -> str:
    return os.environ.get(name, default)


def get_environment_int(name: str, default: int = 0) -> int:
    v = os.environ.get(name)
    if v is None:
        return default
    try:
        return int(v, 0)
    except ValueError:
        return default


def get_environment_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() not in ("0", "false", "off", "")
