"""One metrics registry for train + serve (counters, gauges, histograms).

The port's copy of lightgbm_tpu/obs/registry.py:

 * ``Counter`` — monotonically increasing totals, optionally labeled (the
   training code's counters, e.g. ``hist_impl_fallback_total``, keep their
   names);
 * ``Gauge`` — last-value or pull-callback instruments (queue depth),
   optionally labeled;
 * ``Histogram`` — a bounded ring of recent observations with exact
   percentiles over the ring;
 * ``RateMeter`` — sliding-window event rate (QPS, rows/s).

``MetricsRegistry`` hands out get-or-create instruments by name and renders
them as Prometheus text exposition (``prometheus_text``) or a JSON-able
run report (``run_report``). ``REGISTRY`` is the process-wide default;
each ServeApp keeps its own instance and its /metrics endpoint concatenates
both (serve/server.py). Stdlib + numpy only and lock-guarded throughout.
"""
from __future__ import annotations

import re
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import sanitize as sanitize_mod

# every exposed metric name is prefixed at exposition time, so raw names stay
# short in code ("qps") and scrape configs match one family ("lgbtpu_*")
PROM_PREFIX = "lgbtpu_"

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return PROM_PREFIX + _NAME_OK.sub("_", name)


def _prom_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    body = ",".join(
        '%s="%s"' % (
            _NAME_OK.sub("_", k),
            # full label-value escaping per the exposition format: a raw
            # newline inside a quoted value would break the whole scrape
            str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n"),
        )
        for k, v in labels
    )
    return "{%s}" % body


def _label_key(labels: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter, optionally labeled: ``c.inc(3, model="prod")``."""

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._values: Dict[Tuple, float] = {}
        self._lock = sanitize_mod.make_lock("obs.registry.counter")

    def inc(self, by: float = 1, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + by

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0)

    def values(self) -> Dict[Tuple, float]:
        with self._lock:
            return dict(self._values)


class Gauge:
    """Last-value gauge; ``set_fn`` turns it into a pull gauge whose value is
    computed at read time (queue depth, device memory)."""

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._values: Dict[Tuple, float] = {}
        self._fn: Optional[Callable[[], float]] = None
        self._lock = sanitize_mod.make_lock("obs.registry.gauge")

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def set_fn(self, fn: Callable[[], float]) -> None:
        with self._lock:
            self._fn = fn

    def values(self) -> Dict[Tuple, float]:
        with self._lock:
            out = dict(self._values)
            fn = self._fn
        if fn is not None:
            try:
                out[()] = float(fn())
            except Exception:
                # a pull gauge must never take /metrics down with it
                out.setdefault((), 0.0)
        return out


class Histogram:
    """Ring buffer of recent observations; exact percentiles over the ring,
    plus an all-time count and sum for Prometheus summary semantics."""

    QUANTILES = (0.50, 0.95, 0.99)

    def __init__(self, size: int = 4096) -> None:
        self._buf = np.zeros(size, np.float64)
        self._n = 0  # total ever recorded
        self._sum = 0.0  # all-time sum (Prometheus _sum)
        self._lock = sanitize_mod.make_lock("obs.registry.histogram")

    def record(self, value: float) -> None:
        with self._lock:
            self._buf[self._n % len(self._buf)] = value
            self._n += 1
            self._sum += value

    def snapshot(self) -> Dict[str, float]:
        """count/sum are all-time; quantiles/max/mean are over the ring."""
        with self._lock:
            n = min(self._n, len(self._buf))
            if n == 0:
                return {"count": 0}
            window = np.sort(self._buf[:n])
            total, total_sum = self._n, self._sum

        def pct(p):
            return float(window[min(int(p * n), n - 1)])

        return {
            "count": total,
            "sum": total_sum,
            "p50": pct(0.50),
            "p95": pct(0.95),
            "p99": pct(0.99),
            "max": float(window[-1]),
            "mean": float(window.mean()),
        }


class RateMeter:
    """Sliding-window event rate (QPS / rows-per-second).

    Timestamps default to ``time.perf_counter`` — they only ever feed
    deltas, and a wall-clock (NTP) step would smear or empty the window.
    Callers passing explicit ``now`` values must use one consistent clock.
    """

    def __init__(self, window_s: float = 60.0) -> None:
        self.window_s = window_s
        self._events: deque = deque()  # (t, weight)
        self._lock = sanitize_mod.make_lock("obs.registry.rate")

    def record(self, weight: float = 1.0, now: Optional[float] = None) -> None:
        t = time.perf_counter() if now is None else now
        with self._lock:
            self._events.append((t, weight))
            self._trim(t)

    def _trim(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()

    def rate(self, now: Optional[float] = None) -> float:
        t = time.perf_counter() if now is None else now
        with self._lock:
            self._trim(t)
            if not self._events:
                return 0.0
            span = max(t - self._events[0][0], 1e-9)
            # a single burst shorter than the window divides by its true
            # span, not the full window, so cold-start rates aren't diluted
            return sum(w for _, w in self._events) / min(span, self.window_s)


class MetricsRegistry:
    """Name -> instrument, get-or-create; renders every registered
    instrument as Prometheus text or a JSON run report."""

    def __init__(self) -> None:
        self._metrics: Dict[str, object] = {}
        self._sections: Dict[str, Callable[[], object]] = {}
        self._lock = sanitize_mod.make_lock("obs.registry")

    def register_report_section(
        self, name: str, fn: Callable[[], object]
    ) -> None:
        """Attach a pull section to ``run_report()``: ``fn()`` is called at
        report time and its JSON-able return lands under ``name`` (skipped
        when empty/None or raising — a section must never break a report)."""
        with self._lock:
            self._sections[name] = fn

    def _get_or_create(self, name: str, factory, kind) -> object:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, kind):
                raise TypeError(
                    "metric %r already registered as %s"
                    % (name, type(m).__name__)
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, lambda: Counter(name, help), Counter)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, lambda: Gauge(name, help), Gauge)

    def histogram(self, name: str, size: int = 4096) -> Histogram:
        return self._get_or_create(name, lambda: Histogram(size), Histogram)

    def rate(self, name: str, window_s: float = 60.0) -> RateMeter:
        return self._get_or_create(
            name, lambda: RateMeter(window_s), RateMeter
        )

    def attach(self, name: str, metric):
        """Adopt an externally built instrument under ``name``; returns the
        already-registered one when the name exists (shared by design —
        callers must keep using the returned object)."""
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, type(metric)) and not isinstance(
                    metric, type(existing)
                ):
                    raise TypeError(
                        "metric %r already registered as %s"
                        % (name, type(existing).__name__)
                    )
                return existing
            self._metrics[name] = metric
            return metric

    def _items(self) -> List[Tuple[str, object]]:
        with self._lock:
            return sorted(self._metrics.items())

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    def counters(self) -> Dict[str, int]:
        """{name: summed-over-labels value} for every registered Counter."""
        out: Dict[str, int] = {}
        for name, m in self._items():
            if isinstance(m, Counter):
                out[name] = int(sum(m.values().values()))
        return out

    def snapshot(self) -> Dict[str, object]:
        """Label-preserving JSON-able capture of every instrument:
        counters/gauges as ``{name: [[[k, v] label pairs, value], ...]}``,
        rates as scalars, histograms as their summary snapshot."""
        counters: Dict[str, list] = {}
        gauges: Dict[str, list] = {}
        rates: Dict[str, float] = {}
        summaries: Dict[str, Dict[str, float]] = {}
        for name, m in self._items():
            if isinstance(m, Counter):
                counters[name] = [
                    [[list(kv) for kv in labels], v]
                    for labels, v in sorted(m.values().items())
                ]
            elif isinstance(m, Gauge):
                gauges[name] = [
                    [[list(kv) for kv in labels], v]
                    for labels, v in sorted(m.values().items())
                ]
            elif isinstance(m, RateMeter):
                rates[name] = round(m.rate(), 6)
            elif isinstance(m, Histogram):
                summaries[name] = Histogram.snapshot(m)
        return {
            "counters": counters,
            "gauges": gauges,
            "rates": rates,
            "summaries": summaries,
        }

    # -- renderers ---------------------------------------------------------

    def prometheus_text(self) -> str:
        """Prometheus text exposition (format version 0.0.4) of everything
        registered: counters as ``counter`` (``_total`` suffix enforced),
        gauges and rates as ``gauge``, histograms as ``summary`` with exact
        ring quantiles + all-time _count/_sum. ``# HELP`` lines carry each
        instrument's help string (escaped per the format: backslash and
        newline only — HELP values are not quoted, so ``"`` stays raw)."""
        lines: List[str] = []
        for name, m in self._items():
            if isinstance(m, Counter):
                pname = _prom_name(name)
                if not pname.endswith("_total"):
                    pname += "_total"
                _help_line(lines, pname, m.help)
                lines.append("# TYPE %s counter" % pname)
                vals = m.values() or {(): 0.0}
                for labels, v in sorted(vals.items()):
                    lines.append("%s%s %s" % (pname, _prom_labels(labels), _num(v)))
            elif isinstance(m, Gauge):
                pname = _prom_name(name)
                _help_line(lines, pname, m.help)
                lines.append("# TYPE %s gauge" % pname)
                vals = m.values() or {(): 0.0}
                for labels, v in sorted(vals.items()):
                    lines.append("%s%s %s" % (pname, _prom_labels(labels), _num(v)))
            elif isinstance(m, RateMeter):
                pname = _prom_name(name)
                lines.append("# TYPE %s gauge" % pname)
                lines.append("%s %s" % (pname, _num(m.rate())))
            elif isinstance(m, Histogram):
                pname = _prom_name(name)
                # base-class snapshot explicitly: subclasses may re-render
                # their snapshot for humans (serve's millisecond keys), but
                # the exposition needs the raw native-unit quantiles
                snap = Histogram.snapshot(m)
                lines.append("# TYPE %s summary" % pname)
                for q in Histogram.QUANTILES:
                    key = "p%d" % int(q * 100)
                    lines.append(
                        '%s{quantile="%g"} %s'
                        % (pname, q, _num(snap.get(key, 0.0)))
                    )
                lines.append("%s_sum %s" % (pname, _num(snap.get("sum", 0.0))))
                lines.append("%s_count %d" % (pname, snap.get("count", 0)))
        return "\n".join(lines) + "\n"

    def run_report(self) -> Dict[str, object]:
        """JSON-able block of every instrument's current state."""
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        summaries: Dict[str, Dict[str, float]] = {}
        rates: Dict[str, float] = {}
        for name, m in self._items():
            if isinstance(m, Counter):
                for labels, v in m.values().items():
                    counters[_report_key(name, labels)] = v
            elif isinstance(m, Gauge):
                for labels, v in m.values().items():
                    gauges[_report_key(name, labels)] = round(float(v), 6)
            elif isinstance(m, RateMeter):
                rates[name] = round(m.rate(), 3)
            elif isinstance(m, Histogram):
                snap = Histogram.snapshot(m)
                summaries[name] = {
                    k: (round(v, 6) if isinstance(v, float) else v)
                    for k, v in snap.items()
                }
        out: Dict[str, object] = {
            "counters": counters,
            "gauges": gauges,
            "summaries": summaries,
            "rates": rates,
        }
        with self._lock:
            sections = list(self._sections.items())
        for name, fn in sorted(sections):
            try:
                block = fn()
            except Exception:
                continue  # a report section must never break the report
            if block:
                out[name] = block
        return out


def _num(v: float) -> str:
    """Prometheus number formatting: integers bare, floats via repr,
    non-finite values as the format's ``NaN``/``+Inf``/``-Inf`` tokens.
    The finiteness check must come FIRST: ``int(nan)`` raises ValueError
    and ``int(inf)`` OverflowError, and either would have taken the whole
    /metrics scrape down with it (a pull gauge can legitimately yield
    inf — e.g. a rate denominator of zero upstream)."""
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _help_line(lines: List[str], pname: str, help_text: str) -> None:
    """Append the ``# HELP`` line for ``pname`` when a help string exists.
    HELP values are raw (not quoted), so only backslash and newline need
    escaping — escaping ``"`` here would render literal backslashes in
    scrape UIs."""
    if help_text:
        lines.append(
            "# HELP %s %s"
            % (pname,
               str(help_text).replace("\\", "\\\\").replace("\n", "\\n"))
        )


def _report_key(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return name
    return "%s{%s}" % (name, ",".join("%s=%s" % kv for kv in labels))


#: process-wide default registry (training side, fault sites, the retrace watchdog)
REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return REGISTRY
