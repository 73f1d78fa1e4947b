"""Structured span tracer: Chrome-trace-format JSON, Perfetto-viewable.

The port's copy of lightgbm_tpu/obs/trace.py. Env-gated with
``LIGHTGBM_TPU_TRACE=<path>``: when set, every ``span()`` context in the
process records a Chrome "complete" event (``ph: "X"`` with
pid/tid/ts/dur, microseconds) and the buffer is written to ``<path>`` at
``stop()``/``flush()`` or process exit. Load the file in Perfetto
(https://ui.perfetto.dev) or chrome://tracing; events on one thread nest by
time containment.

Span sites (cat → where):
  * ``serve``         — request lifecycle: queue wait → batch gather →
                        dispatch → reply (serve/server.py, serve/batcher.py)

Device correlation: when torch's profiler is recording, ``span()`` also
enters ``torch.profiler.record_function(name)``, so the host span shows up
in the profile beside the kernels it launched.

One trace file per process: an env-derived path gets a ``.rank<N>`` suffix
in a multi-process ``torch.distributed`` world.

Disabled cost: one dict lookup per ``span()`` call. Thread-safe throughout.
"""
from __future__ import annotations

import atexit
import contextlib
import gzip
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional

from . import sanitize as sanitize_mod

ENV_TRACE = "LIGHTGBM_TPU_TRACE"

_EPOCH = time.perf_counter()


def now_us() -> float:
    """Microseconds on the tracer's (monotonic) clock."""
    return (time.perf_counter() - _EPOCH) * 1e6


#: buffer cap: ~160 bytes/event dict puts 1M events around 160MB — enough
#: for hours of phase spans or minutes of per-request serve spans, small
#: enough that a traced long-lived server cannot OOM from the tracer
MAX_EVENTS = 1_000_000


class Tracer:
    """In-memory Chrome-trace event buffer bound to one output path.

    The buffer is CAPPED at ``max_events``: once full, further events are
    counted (``dropped``) but not stored, and the flushed file carries a
    ``dropped_events`` marker — tracing a long-lived serve process degrades
    to a truncated-but-loadable trace instead of unbounded memory growth.
    """

    def __init__(self, path: str, max_events: int = MAX_EVENTS) -> None:
        self.path = path
        self.pid = os.getpid()
        self.max_events = max_events
        self.dropped = 0
        self._events: List[Dict] = []
        self._lock = sanitize_mod.make_lock("obs.trace.buffer")
        self._tids: Dict[int, int] = {}  # thread ident -> small stable tid

    def _append(self, ev: Dict) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(ev)

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = len(self._tids)
                self._tids[ident] = tid
                name = threading.current_thread().name
                # metadata rides outside the cap: a handful of threads
                self._events.insert(tid, {
                    "ph": "M", "name": "thread_name", "pid": self.pid,
                    "tid": tid, "args": {"name": name},
                })
            return tid

    def complete(
        self, name: str, cat: str, ts_us: float, dur_us: float,
        args: Optional[Dict] = None, tid: Optional[int] = None,
    ) -> None:
        ev = {
            "ph": "X", "name": name, "cat": cat or "lgbtpu",
            "pid": self.pid, "tid": self._tid() if tid is None else tid,
            "ts": round(ts_us, 3), "dur": round(max(dur_us, 0.0), 3),
        }
        if args:
            ev["args"] = args
        self._append(ev)

    def instant(self, name: str, cat: str = "", args: Optional[Dict] = None) -> None:
        ev = {
            "ph": "i", "s": "t", "name": name, "cat": cat or "lgbtpu",
            "pid": self.pid, "tid": self._tid(), "ts": round(now_us(), 3),
        }
        if args:
            ev["args"] = args
        self._append(ev)

    def counter(self, name: str, value: float) -> None:
        self._append({
            "ph": "C", "name": name, "cat": "lgbtpu", "pid": self.pid,
            "tid": 0, "ts": round(now_us(), 3),
            "args": {"value": float(value)},
        })

    def flush(self) -> str:
        """Write the full buffer (Chrome trace object form) to ``path``."""
        with self._lock:
            events = list(self._events)
            dropped = self.dropped
        payload = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"producer": "lightgbm_tpu_torch.obs.trace"},
        }
        if dropped:
            payload["otherData"]["dropped_events"] = dropped
        with open(self.path, "w", encoding="utf-8") as fh:
            json.dump(payload, fh)
            fh.write("\n")
        return self.path

    def event_count(self) -> int:
        with self._lock:
            return len(self._events)


_TRACER: Optional[Tracer] = None
_LOCK = sanitize_mod.make_lock("obs.trace")
_ATEXIT_ARMED = False


def start(path: Optional[str] = None) -> Tracer:
    """Start (or return) the process tracer; ``path`` defaults to the
    LIGHTGBM_TPU_TRACE env var. Idempotent while a tracer is live."""
    global _TRACER, _ATEXIT_ARMED
    with _LOCK:
        if _TRACER is not None:
            return _TRACER
        target = path or os.environ.get(ENV_TRACE, "")
        if not target:
            raise ValueError(
                "trace.start() needs a path (or set %s)" % ENV_TRACE
            )
        if path is None:
            # every rank inherits the same env var: an env-derived path gets
            # a .rank<N> suffix; explicit paths are the caller's
            target = rank_suffixed(target)
        _TRACER = Tracer(target)
        if not _ATEXIT_ARMED:
            _ATEXIT_ARMED = True
            atexit.register(_atexit_flush)
        return _TRACER


def rank_suffixed(target: str) -> str:
    """``<target>.rank<N>`` in a multi-process ``torch.distributed`` world
    (consults only an already-imported and initialised torch.distributed;
    never imports it): two ranks must never clobber one trace file."""
    if ".rank" in target:
        return target
    dist = sys.modules.get("torch.distributed")
    if dist is None:
        return target
    try:
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            return "%s.rank%d" % (target, dist.get_rank())
    except Exception as e:
        # a half-initialised group must not break tracing
        from ..utils import log

        log.debug("trace: rank probe failed: %r" % (e,))
    return target


def stop() -> Optional[str]:
    """Flush and detach the tracer; returns the written path (None when no
    tracer was live). A later ``span()`` re-arms from the env var, so tests
    can start/stop repeatedly."""
    global _TRACER
    with _LOCK:
        tr, _TRACER = _TRACER, None
    if tr is None:
        return None
    return tr.flush()


def _atexit_flush() -> None:
    with _LOCK:
        tr = _TRACER
    if tr is not None:
        try:
            tr.flush()
        except OSError:
            pass  # a dead target dir must not break interpreter shutdown


def active() -> Optional[Tracer]:
    """The live tracer, auto-starting from the env var on first use."""
    tr = _TRACER
    if tr is not None:
        return tr
    if os.environ.get(ENV_TRACE, ""):
        try:
            return start()
        except (ValueError, OSError):
            return None
    return None


def enabled() -> bool:
    return active() is not None


def _profiler_recording() -> bool:
    """True when torch is imported and its profiler is recording."""
    tr = sys.modules.get("torch")
    if tr is None:
        return False
    try:
        return bool(tr.autograd._profiler_enabled())
    except (AttributeError, RuntimeError):
        return False


@contextlib.contextmanager
def span(name: str, cat: str = "", **args):
    """Record a complete event around the body; no-op without a tracer.

    Keyword args land in the event's ``args`` dict (JSON-able values only).
    While torch's profiler records, the span also enters
    ``torch.profiler.record_function`` so the profile carries the same name.
    """
    tr = active()
    if tr is None:
        yield
        return
    ann = None
    if _profiler_recording():
        try:
            import torch

            ann = torch.profiler.record_function(name)
            ann.__enter__()
        except Exception:
            ann = None  # the profiler's annotation is unavailable here
    t0 = now_us()
    try:
        yield
    finally:
        t1 = now_us()
        if ann is not None:
            try:
                ann.__exit__(None, None, None)
            except Exception as e:
                # annotation teardown must never mask the body's result
                from ..utils import log

                log.debug("trace: record_function teardown failed: %r" % (e,))
        tr.complete(name, cat, t0, t1 - t0, args or None)


def complete_at(name: str, cat: str, t0_us: float, t1_us: float,
                **args) -> None:
    """Record a complete event with explicit start/end (``now_us`` clock) —
    for spans measured across threads, e.g. a request's queue wait."""
    tr = active()
    if tr is not None:
        tr.complete(name, cat, t0_us, t1_us - t0_us, args or None)


def instant(name: str, cat: str = "", **args) -> None:
    tr = active()
    if tr is not None:
        tr.instant(name, cat, args or None)


# ---------------------------------------------------------------------------
# multi-file merge: fold per-process/per-rank traces into one timeline
# ---------------------------------------------------------------------------

def load_chrome_trace(path: str) -> Dict:
    """A Chrome-trace JSON document, gzipped or not."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as fh:
        doc = json.load(fh)
    if isinstance(doc, list):  # the bare-array form of the format
        doc = {"traceEvents": doc}
    return doc


def merge_traces(out_path: str, in_paths) -> Dict:
    """Fold several Chrome-trace files (per-rank ``.rank<N>`` files, a
    torch profiler's exported trace) into one Perfetto-loadable timeline.
    Every source (file, pid) pair is remapped to a fresh disjoint pid with a
    ``process_name`` metadata row naming its origin; ``dropped_events``
    markers are summed and kept. Gzipped inputs (``*.json.gz``) load
    transparently. Returns {files, events, pids, dropped, path}."""
    events: List[Dict] = []
    pid_map: Dict = {}
    dropped = 0
    n_events = 0
    files = 0
    for i, p in enumerate(in_paths):
        try:
            doc = load_chrome_trace(str(p))
        except (OSError, ValueError):
            continue  # a torn/absent child trace must not kill the merge
        files += 1
        dropped += int((doc.get("otherData") or {}).get("dropped_events", 0)
                       or 0)
        label = os.path.basename(str(p))
        for ev in doc.get("traceEvents") or []:
            old = ev.get("pid", 0)
            key = (i, old)
            new = pid_map.get(key)
            if new is None:
                new = pid_map[key] = len(pid_map) + 1
                events.append({
                    "ph": "M", "name": "process_name", "pid": new, "tid": 0,
                    "args": {"name": "%s (pid %s)" % (label, old)},
                })
            ev2 = dict(ev)
            ev2["pid"] = new
            events.append(ev2)
            n_events += 1
    payload: Dict = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"producer": "lightgbm_tpu_torch.obs.trace merge"},
    }
    if dropped:
        payload["otherData"]["dropped_events"] = dropped
    with open(out_path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh)
        fh.write("\n")
    return {
        "files": files, "events": n_events, "pids": len(pid_map),
        "dropped": dropped, "path": out_path,
    }


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m lightgbm_tpu_torch.obs.trace merge -o out.json in1 in2 ...``
    (globs welcome). Stdlib only."""
    import argparse
    import glob as glob_mod

    ap = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.obs.trace",
        description="Chrome-trace utilities (obs/trace.py)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    mg = sub.add_parser("merge", help="fold per-process trace files into one timeline "
                                      "with disjoint pids")
    mg.add_argument("inputs", nargs="+", help="trace files or shell-unexpanded globs")
    mg.add_argument("-o", "--out", default="trace_merged.json")
    args = ap.parse_args(argv)
    paths: List[str] = []
    for item in args.inputs:
        hits = sorted(glob_mod.glob(item))
        paths.extend(hits if hits else [item])
    paths = list(dict.fromkeys(paths))  # order-preserving dedupe
    stats = merge_traces(args.out, paths)
    print(
        "trace merge: %(files)d file(s) -> %(path)s "
        "(%(events)d events, %(pids)d pids, %(dropped)d dropped)" % stats
    )
    return 0 if stats["files"] else 1


if __name__ == "__main__":
    sys.exit(main())
