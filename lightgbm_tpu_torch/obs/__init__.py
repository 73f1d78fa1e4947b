"""Measurement and routing support of the port: the histogram tune sweep
(``python -m lightgbm_tpu_torch.obs.tune``), the device-family vocabulary
its tables are keyed by, and a small counter registry."""
