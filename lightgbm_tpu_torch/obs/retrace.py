"""Trace watchdog: count the first dispatches of each entry at a new shape.

The port's copy of lightgbm_tpu/obs/retrace.py, with the same API
(``note_trace``, ``arm``, ``disarm``, ``counts``,
``retraces_after_warmup``) and the same ``LIGHTGBM_TPU_RETRACE`` modes.
In the JAX package a "trace" is an XLA compile of a jitted entry. The port
compiles nothing per shape (its kernels are built once per source by
ops/cuda_build.py), so here a "trace" is the **first dispatch of a kernel
entry at a new shape**: ops/packed_kernel.py calls :func:`note_trace` the
first time an entry sees a (device, shape) signature, which on the serving
path means a new row bucket or a new model's tree shape. What it polices is
what the JAX package's watchdog polices there: traffic that escapes the
warmed buckets. Instrumented entry points:

  * ``ops.packed_predict_leaves``  — packed serving traversal
  * ``ops.packed_predict_values``  — fused scores
  * ``ops.packed_bin_rows``        — fused raw->rank binning

After warmup, call :func:`arm` to snapshot the counts. Any later trace of an
armed name is a retrace: it warns once per name (utils/log.warn_once) and,
with ``LIGHTGBM_TPU_RETRACE=fail``, raises ``LightGBMError``.
``LIGHTGBM_TPU_RETRACE=warn`` is the explicit spelling of the default. Each
name's count is published as the ``jit_traces{name=}`` gauge of the
process registry.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, Optional

from ..utils import log
from ..utils.log import LightGBMError
from . import registry as registry_mod
from . import sanitize as sanitize_mod

ENV_RETRACE = "LIGHTGBM_TPU_RETRACE"


def _mode() -> str:
    """Read per event, not at import: tests and long-lived servers flip it."""
    return os.environ.get(ENV_RETRACE, "").lower()


class RetraceWatchdog:
    """Per-name compile counts + an armed warm baseline."""

    def __init__(self) -> None:
        self._counts: Dict[str, int] = {}
        self._warm: Dict[str, int] = {}
        self._armed = False
        self._lock = sanitize_mod.make_lock("obs.retrace")

    def note_trace(self, name: str) -> None:
        """Called once per trace (the first dispatch of an entry at a new shape)."""
        with self._lock:
            count = self._counts[name] = self._counts.get(name, 0) + 1
            retrace = self._armed and name in self._warm
        # the labeled per-name count on /metrics
        try:
            registry_mod.REGISTRY.gauge("jit_traces").set(count, name=name)
        except TypeError as e:
            # a metric-kind collision ("jit_traces" registered as another
            # kind): metrics must never break a dispatch
            log.debug("retrace: jit_traces gauge update failed: %r" % e)
        if retrace:
            msg = (
                "retrace after warmup: %r dispatched at a new shape (%d traces "
                "total) — a shape drifted off the warmed buckets on the hot "
                "path; set %s=fail to hard-fail here" % (name, count, ENV_RETRACE)
            )
            if _mode() == "fail":
                raise LightGBMError(msg)
            log.warn_once("retrace:%s" % name, msg)

    def arm(self, names: Optional[Iterable[str]] = None) -> None:
        """Snapshot current counts as the warm baseline. With ``names``,
        only those entry points are policed (unknown names are armed at 0
        so their very first trace counts as a retrace)."""
        with self._lock:
            if names is None:
                self._warm = dict(self._counts)
            else:
                for n in names:
                    self._warm[n] = self._counts.get(n, 0)
            self._armed = True

    def disarm(self) -> None:
        with self._lock:
            self._armed = False
            self._warm = {}

    def reset(self) -> None:
        with self._lock:
            self._counts = {}
            self._warm = {}
            self._armed = False

    @property
    def armed(self) -> bool:
        return self._armed

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def retraces_after_warmup(self) -> Dict[str, int]:
        """name -> traces since arm(), for armed names only (empty unarmed)."""
        with self._lock:
            if not self._armed:
                return {}
            return {
                n: self._counts.get(n, 0) - base
                for n, base in self._warm.items()
                if self._counts.get(n, 0) > base
            }

    def total_retraces(self) -> int:
        return sum(self.retraces_after_warmup().values())


#: process-wide watchdog; ops/packed_kernel.py notes into it, serve warmup arms it
WATCHDOG = RetraceWatchdog()


def note_trace(name: str) -> None:
    WATCHDOG.note_trace(name)


def arm(names: Optional[Iterable[str]] = None) -> None:
    WATCHDOG.arm(names)


def disarm() -> None:
    WATCHDOG.disarm()


def reset() -> None:
    WATCHDOG.reset()


def counts() -> Dict[str, int]:
    return WATCHDOG.counts()


def retraces_after_warmup() -> Dict[str, int]:
    return WATCHDOG.retraces_after_warmup()
