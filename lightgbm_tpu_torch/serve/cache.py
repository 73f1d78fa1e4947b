"""Shape-bucketed dispatch: pad ragged batches to power-of-two row buckets.

The port's copy of lightgbm_tpu/serve/cache.py. In the JAX package a new
batch size is a new XLA compile; in the port it is a kernel dispatch at a
new shape, which the retrace watchdog (obs/retrace.py) counts as a trace,
and a new size of every host and device buffer of the dispatch. The
discipline is the same: pad every batch's row dimension up to a
power-of-two bucket so steady-state traffic reuses a handful of shapes,
then slice the padding back off.

``BucketedDispatcher`` wraps a row-leading function (the packed traversal
and the fused-score dispatches, serve/server.py). It tracks per-bucket hit
counts and a ``retraces`` counter (first time a bucket is seen); after
``warmup()`` a mixed-size load runs with zero retraces
(tests/test_torch_serve_packed.py holds it to that).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np

from ..obs import registry as obs_registry
from ..obs import sanitize as sanitize_mod

DEFAULT_MIN_ROWS = 16
DEFAULT_MAX_ROWS = 1 << 16


def next_bucket(n: int, min_rows: int = DEFAULT_MIN_ROWS) -> int:
    """Smallest power-of-two >= n, floored at ``min_rows`` (itself a pow2)."""
    if n <= min_rows:
        return min_rows
    return 1 << (int(n - 1).bit_length())


class BucketedDispatcher:
    """Pad-to-bucket wrapper around a row-leading dispatch function.

    ``fn(*arrays)`` must accept numpy arrays whose FIRST axis is the row
    dimension and return an array (or tuple of arrays) whose LAST axis is the
    row dimension — the packed kernels' [T, N] / [K, N] convention — or, with
    ``rows_axis=0``, row-leading output. Padding rows are zeros; results for
    them are sliced off before returning. Requests above ``max_rows`` are
    split into ``max_rows``-sized chunks (one warmed bucket each, results
    re-concatenated) so no request can mint an unbounded new bucket.
    """

    def __init__(
        self,
        fn: Callable,
        min_rows: int = DEFAULT_MIN_ROWS,
        max_rows: int = DEFAULT_MAX_ROWS,
        rows_axis: int = -1,
    ) -> None:
        self.fn = fn
        # the bucket ladder is pow2; a non-pow2 floor (e.g. --min-bucket-rows
        # 24) would make warmup() warm phantom buckets: round it up front
        self.min_rows = next_bucket(max(int(min_rows), 1), 1)
        self.max_rows = max_rows
        self.rows_axis = rows_axis
        self.bucket_counts: Dict[int, int] = {}
        self.retraces = 0  # distinct buckets dispatched: the new shapes paid
        self.calls = 0
        self._lock = sanitize_mod.make_lock("serve.cache.stats")

    def bucket(self, n: int) -> int:
        return next_bucket(n, self.min_rows)

    def _record(self, b: int) -> None:
        with self._lock:
            self.calls += 1
            new_bucket = b not in self.bucket_counts
            if new_bucket:
                self.bucket_counts[b] = 0
                self.retraces += 1
            self.bucket_counts[b] += 1
        if new_bucket:
            # the process-wide counter behind /metrics (obs/registry.py)
            obs_registry.REGISTRY.counter("bucket_retraces").inc()

    def __call__(self, *arrays: np.ndarray):
        n = arrays[0].shape[0]
        if n > self.max_rows:
            # split oversized requests at the cap instead of minting ever-
            # larger pow2 buckets; full chunks reuse one warmed bucket, only
            # the tail varies
            outs = [
                self(*(a[off : off + self.max_rows] for a in arrays))
                for off in range(0, n, self.max_rows)
            ]
            return self._concat(outs)
        b = self.bucket(n)
        self._record(b)
        if b != n:
            arrays = tuple(
                np.concatenate(
                    [a, np.zeros((b - n,) + a.shape[1:], a.dtype)], axis=0
                )
                for a in arrays
            )
        # the sanitizer's transfer-scope site marker (obs/sanitize.py): the
        # wrapped fns upload their operands explicitly
        with sanitize_mod.transfer_scope("serve.dispatch"):
            out = self.fn(*arrays)
        return self._slice(out, n)

    def _concat(self, outs):
        if isinstance(outs[0], tuple):
            return tuple(self._concat(list(parts)) for parts in zip(*outs))
        return np.concatenate(outs, axis=0 if self.rows_axis == 0 else -1)

    def _slice(self, out, n: int):
        if isinstance(out, tuple):
            return tuple(self._slice(o, n) for o in out)
        out = np.asarray(out)
        if self.rows_axis == 0:
            return out[:n]
        return out[..., :n]

    def warmup(self, make_inputs: Callable[[int], Sequence[np.ndarray]],
               max_rows: Optional[int] = None) -> list:
        """Dispatch once per bucket from ``min_rows`` to ``max_rows`` so
        steady-state traffic meets no new shape. ``make_inputs(n)`` builds a
        representative n-row input tuple. Returns the warmed bucket list."""
        buckets = []
        b = self.min_rows
        limit = max_rows or self.max_rows
        while b <= limit:
            self(*make_inputs(b))
            buckets.append(b)
            b <<= 1
        return buckets

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "calls": self.calls,
                "retraces": self.retraces,
                "buckets": dict(sorted(self.bucket_counts.items())),
            }
