"""Measurement and routing support of the port: the histogram tune sweep
(``python -m lightgbm_tpu_torch.obs.tune``), the device-family vocabulary
its tables are keyed by, the metrics registry (counters, gauges,
histograms, rates and their Prometheus text), the span tracer, the lock
sanitizer and the retrace watchdog of the serving path."""
