"""Serving metrics: a thin client of the obs metrics registry.

The port's copy of lightgbm_tpu/serve/metrics.py. ``LatencyWindow``
renders millisecond snapshots for the JSON endpoint, and ``ServeMetrics``
wires the server's instruments into a
:class:`~lightgbm_tpu_torch.obs.registry.MetricsRegistry` so ``/metrics``
can render Prometheus text exposition straight off it.

Each ``ServeMetrics`` owns a fresh registry by default (two ServeApps in one
process must not mix latency rings); the /metrics endpoint concatenates the
app registry with the process-wide one (serve/server.py).

Percentiles come from a bounded ring of the most recent observations: at
serving rates the last few thousand samples are the steady state, and the
p99 of a ring is exact where a log-bucketed histogram is approximate.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..obs.registry import (  # noqa: F401  (RateMeter re-exported: public API)
    Histogram,
    MetricsRegistry,
    RateMeter,
)


class LatencyWindow(Histogram):
    """Ring buffer of recent latencies (seconds in, milliseconds out)."""

    def snapshot(self) -> Dict[str, float]:  # type: ignore[override]
        base = super().snapshot()
        if base.get("count", 0) == 0:
            return {"count": 0}
        return {
            "count": base["count"],
            "p50_ms": round(base["p50"] * 1e3, 4),
            "p95_ms": round(base["p95"] * 1e3, 4),
            "p99_ms": round(base["p99"] * 1e3, 4),
            "max_ms": round(base["max"] * 1e3, 4),
            "mean_ms": round(base["mean"] * 1e3, 4),
        }


class ServeMetrics:
    """The server's one metrics hub (serve/server.py wires everything here).

    All instruments are registered on ``self.registry`` under stable names,
    so ``prometheus_text()`` is the complete serving exposition:
    request/dispatch latency summaries, qps / rows_per_second gauges, queue
    depth, batch occupancy, and every ``incr`` counter (as ``*_total``).
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        reg = registry if registry is not None else MetricsRegistry()
        self.registry = reg
        self.request_latency = reg.attach(
            "request_latency_seconds", LatencyWindow()
        )  # full request wall time
        self.dispatch_latency = reg.attach(
            "dispatch_latency_seconds", LatencyWindow()
        )  # device dispatch only
        self.qps = reg.rate("qps")
        self.rows_per_sec = reg.rate("rows_per_second")
        self.batch_occupancy = reg.attach(
            "batch_occupancy_ratio", Histogram(1024)
        )  # 0..1 per dispatched batch
        self.queue_depth_fn = lambda: 0  # wired to the batcher's queue
        reg.gauge("queue_depth").set_fn(
            lambda: float(self.queue_depth_fn())
        )

    def incr(self, name: str, by: int = 1) -> None:
        self.registry.counter(name).inc(by)

    def counters(self) -> Dict[str, int]:
        return self.registry.counters()

    def prometheus_text(self) -> str:
        return self.registry.prometheus_text()

    def snapshot(self, dispatcher_stats: Optional[Dict] = None) -> Dict[str, object]:
        occ = self.batch_occupancy.snapshot()
        out: Dict[str, object] = {
            "request_latency": self.request_latency.snapshot(),
            "dispatch_latency": self.dispatch_latency.snapshot(),
            "qps": round(self.qps.rate(), 3),
            "rows_per_sec": round(self.rows_per_sec.rate(), 1),
            "queue_depth": int(self.queue_depth_fn()),
            "counters": self.counters(),
            "batch_occupancy": {
                "count": occ.get("count", 0),
                "mean": round(occ.get("mean", 0.0), 4),
                "p50": round(occ.get("p50", 0.0), 4),
            },
        }
        if dispatcher_stats:
            out["buckets"] = dispatcher_stats
        return out
