"""Inference serving on the card: the port of lightgbm_tpu/serve/.

A trained :class:`~lightgbm_tpu_torch.basic.Booster` walks its trees one
at a time (models/tree.py); this subsystem packs the ensemble into dense
device tensors and wraps them in a serving stack:

- ``packed``  — ``PackedEnsemble``: rank-space tensor ensemble, bit-exact
  against ``Booster.predict`` (exact path: host f64 codes, the traversal
  kernel, the host f64 sum) plus a fused all-device f32 path (the bin
  kernel, then the fused-score kernel; csrc/packed_predict.cu)
- ``cache``   — pads batches to power-of-two row buckets so steady-state
  traffic meets no new shape
- ``batcher`` — micro-batcher coalescing concurrent requests into one
  device dispatch
- ``server``  — stdlib-only threaded HTTP JSON endpoint with a hot-swap
  model registry
- ``metrics`` — latency percentiles, QPS, queue depth, bucket counters

Entry points: ``Booster.to_packed()``, ``python -m lightgbm_tpu_torch.serve``.
The drift monitor of the JAX package (serve/drift.py) is not ported.
"""
from .batcher import MicroBatcher
from .cache import BucketedDispatcher, next_bucket
from .metrics import ServeMetrics
from .packed import PackedEnsemble, pack_booster

__all__ = [
    "BucketedDispatcher",
    "MicroBatcher",
    "PackedEnsemble",
    "ServeMetrics",
    "next_bucket",
    "pack_booster",
]
