"""Env-var controlled logging (analog of NVCOMP_LOG_LEVEL / NVCOMP_LOG_FILE).

Reference behavior: ``README.md:79-88`` — levels 0(off)/1(error)/2(+warn)/3(+info:
every low-level API call)/4-5(debug); log file may be a path, ``stdout`` or
``stderr``; default is a timestamped file.  We mirror the scheme with
``TPUCOMP_LOG_LEVEL`` / ``TPUCOMP_LOG_FILE`` but default to stderr rather than a
file (friendlier default for a Python library).  Same variables as
:mod:`tpucomp.logging`, which this module copies.
"""
from __future__ import annotations

import functools
import os
import sys
import time
from typing import Any

LEVEL_OFF = 0
LEVEL_ERROR = 1
LEVEL_WARN = 2
LEVEL_INFO = 3
LEVEL_DEBUG = 4
LEVEL_TRACE = 5

_LEVEL_NAMES = {1: "ERROR", 2: "WARN", 3: "INFO", 4: "DEBUG", 5: "TRACE"}


@functools.lru_cache(maxsize=1)
def _config() -> tuple[int, Any]:
    level = int(os.environ.get("TPUCOMP_LOG_LEVEL", "0") or "0")
    dest = os.environ.get("TPUCOMP_LOG_FILE", "stderr")
    if dest == "stderr":
        stream = sys.stderr
    elif dest == "stdout":
        stream = sys.stdout
    else:
        stream = open(dest, "a")  # noqa: SIM115 - deliberately long-lived
    return level, stream


def reset_logging_config() -> None:
    """Re-read env vars (used by tests)."""
    _config.cache_clear()


def log(level: int, msg: str, *args: Any) -> None:
    cfg_level, stream = _config()
    if level > cfg_level:
        return
    if args:
        msg = msg % args
    ts = time.strftime("%Y-%m-%d %H:%M:%S")
    print(f"[tpucomp_torch {ts} {_LEVEL_NAMES.get(level, level)}] {msg}", file=stream)


def error(msg: str, *args: Any) -> None:
    log(LEVEL_ERROR, msg, *args)


def warn(msg: str, *args: Any) -> None:
    log(LEVEL_WARN, msg, *args)


def info(msg: str, *args: Any) -> None:
    log(LEVEL_INFO, msg, *args)


def debug(msg: str, *args: Any) -> None:
    log(LEVEL_DEBUG, msg, *args)


def api_call(name: str, **kwargs: Any) -> None:
    """Log a low-level API call at INFO level (reference logs every LLIF call at 3)."""
    cfg_level, _ = _config()
    if cfg_level >= LEVEL_INFO:
        arg_str = ", ".join(f"{k}={v}" for k, v in kwargs.items())
        log(LEVEL_INFO, "%s(%s)", name, arg_str)
