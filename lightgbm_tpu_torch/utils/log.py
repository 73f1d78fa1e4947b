"""Logging for lightgbm_tpu.

TPU-native counterpart of the reference's ``Log`` singleton
(LightGBM include/LightGBM/utils/log.h:38-108): levels Debug/Info/Warning/Fatal,
Fatal raises, and a pluggable callback so embedding hosts (CLI, tests) can redirect
output. Each emitted line carries an ISO-8601 timestamp; ``warn_once``
rate-limits recurring warnings (backend probes, CPU fallbacks) to one line
per key per process.
"""
from __future__ import annotations

import sys
import threading
import time
from typing import Callable, Optional

_LEVELS = {"debug": 10, "info": 20, "warning": 30, "fatal": 40}
_level = "info"
_callback: Optional[Callable[[str], None]] = None
_warned_keys: set = set()
_warn_lock = threading.Lock()


class LightGBMError(Exception):
    """Raised on fatal errors (mirrors Log::Fatal throwing std::runtime_error)."""


def set_verbosity(verbosity: int) -> None:
    """Map LightGBM's ``verbosity`` int to a level: <0 fatal, 0 warning, 1 info, >1 debug."""
    global _level
    if verbosity < 0:
        _level = "fatal"
    elif verbosity == 0:
        _level = "warning"
    elif verbosity == 1:
        _level = "info"
    else:
        _level = "debug"


def register_callback(cb: Optional[Callable[[str], None]]) -> None:
    global _callback
    _callback = cb


def _emit(level: str, msg: str) -> None:
    if _LEVELS[level] < _LEVELS[_level]:
        return
    stamp = time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime())
    text = "[LightGBM-TPU] [%s] [%s] %s" % (stamp, level.capitalize(), msg)
    if _callback is not None:
        _callback(text + "\n")
    else:
        print(text, file=sys.stderr, flush=True)


def debug(msg: str, *args) -> None:
    _emit("debug", msg % args if args else msg)


def info(msg: str, *args) -> None:
    _emit("info", msg % args if args else msg)


def warning(msg: str, *args) -> None:
    _emit("warning", msg % args if args else msg)


def warn_once(key: str, msg: str, *args) -> bool:
    """Emit a warning once per ``key`` per process; later calls with the
    same key are dropped. For warnings that recur structurally (backend
    probe failures, CPU fallbacks, retraces) where the first line carries
    all the signal and repetition only buries it. Returns whether the line
    was emitted."""
    with _warn_lock:
        if key in _warned_keys:
            return False
        _warned_keys.add(key)
    warning(msg, *args)
    return True


def reset_warn_once() -> None:
    """Forget warn_once history (tests)."""
    with _warn_lock:
        _warned_keys.clear()


def fatal(msg: str, *args) -> None:
    text = msg % args if args else msg
    _emit("fatal", text)
    raise LightGBMError(text)
