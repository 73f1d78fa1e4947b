"""Wrappers of the serving path's hand-written kernels (csrc/packed_predict.cu).

``packed_bin_rows``, ``packed_predict_leaves`` and ``packed_predict_values``
take and give what lightgbm_tpu/ops/predict.py's functions of the same
names do, over a :class:`~lightgbm_tpu_torch.ops.predict.PackedTrees` on the
tensors' device: the kernel for CUDA tensors, the plain PyTorch version
(ops/predict.py) for CPU tensors. Any other device, and anything the
kernel does not take, raises, and so does a failed build or launch; there
is no fallback from the card to the plain version. ``launches`` counts, by
entry, the calls that launched a kernel.

Each entry notes a trace into the retrace watchdog (obs/retrace.py) the
first time it runs at a new (device, shape) signature, on either device:
the serve path's bucket discipline is policed the same way on the CPU
tests and on the card.

The traversal kernels read the trees from a node table (``node_table``:
[T, M, 8] int32, two 16-byte words a node), built on the device at the
first launch over a ``PackedTrees`` and kept while its fields are the same
tensors, unmodified.
"""
from __future__ import annotations

import ctypes
import threading
import weakref
from typing import Dict, Tuple

import torch

from ..obs import retrace as retrace_mod
from . import cuda_build, hist_kernel
from . import predict as plain
from .predict import PackedTrees

ENTRIES = ("packed_bin_rows", "packed_predict_leaves", "packed_predict_values")
launches: Dict[str, int] = {name: 0 for name in ENTRIES}

THREADS = 256
TREES_PER_ROUND = THREADS // 32  # packed_predict_values: a warp a tree of a round
TILE_ROWS = 32  # packed_predict_values: a lane a row
BIN_BLOCKS_PER_SM = 8
MAX_GRID_Y = 65535

_seen = set()
_seen_lock = threading.Lock()
_max_shared: Dict[int, int] = {}
_tables: Dict[int, tuple] = {}  # id(feature) -> (its weakref, field stamp, node table)
_tables_lock = threading.Lock()

_TREE_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int]
_BIN_ARGS = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
             + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])
_LEAVES_ARGS = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] + _TREE_ARGS
                + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_VALUES_ARGS = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] + _TREE_ARGS
                + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p])

#: each PackedTrees field's dtype and rank, as the kernels read them
FIELDS = {
    "feature": (torch.int32, 2), "thr_rank": (torch.int32, 2),
    "default_left": (torch.bool, 2), "missing_type": (torch.int32, 2),
    "left_child": (torch.int32, 2), "right_child": (torch.int32, 2),
    "is_cat": (torch.bool, 2), "cat_off": (torch.int32, 2), "cat_n": (torch.int32, 2),
    "leaf_value": (torch.float32, 2), "num_leaves": (torch.int32, 1),
    "cat_words": (torch.uint32, 1), "rank0": (torch.int32, 1),
    "zero_lo": (torch.int32, 1), "zero_hi": (torch.int32, 1),
}


def reset_launches() -> None:
    for name in ENTRIES:
        launches[name] = 0


def _note(entry: str, dev: torch.device, shape: Tuple) -> None:
    """A trace of ``entry``: its first dispatch at this (device, shape)."""
    key = (entry, str(dev)) + tuple(shape)
    with _seen_lock:
        if key in _seen:
            return
        _seen.add(key)
    retrace_mod.note_trace("ops." + entry)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, dev: torch.device, shape=None) -> None:
    if (t.device != dev or t.dtype != dtype or not t.is_contiguous()
            or (shape is not None and tuple(t.shape) != tuple(shape))):
        raise ValueError("packed_predict: %s must be a contiguous %s tensor%s on %s, got %s %s on %s"
                         % (name, dtype, "" if shape is None else " of shape %s" % (shape,), dev,
                            t.dtype, tuple(t.shape), t.device))


def _device(t: torch.Tensor) -> torch.device:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError("packed_predict: unsupported device %s" % t.device)
    return t.device


def _check_packed(packed: PackedTrees, dev: torch.device, F: int) -> Tuple[int, int]:
    T, M = packed.feature.shape
    for name, (dtype, rank) in FIELDS.items():
        t = getattr(packed, name)
        _check(name, t, dtype, dev)
        if t.dim() != rank:
            raise ValueError("packed_predict: %s must have rank %d, got %s"
                             % (name, rank, tuple(t.shape)))
    for name in ("thr_rank", "default_left", "missing_type", "left_child", "right_child",
                 "is_cat", "cat_off", "cat_n"):
        if tuple(getattr(packed, name).shape) != (T, M):
            raise ValueError("packed_predict: %s must be [%d, %d]" % (name, T, M))
    if packed.leaf_value.shape[0] != T or packed.num_leaves.shape[0] != T:
        raise ValueError("packed_predict: leaf_value and num_leaves must have %d trees" % T)
    if packed.cat_words.numel() < 1:
        raise ValueError("packed_predict: cat_words must hold at least one word")
    for name in ("rank0", "zero_lo", "zero_hi"):
        if getattr(packed, name).shape[0] != F:
            raise ValueError("packed_predict: %s must have one entry a feature (%d)" % (name, F))
    return T, M


def _check_rows(codes: torch.Tensor, isnan: torch.Tensor, dev: torch.device) -> Tuple[int, int]:
    if codes.dim() != 2:
        raise ValueError("packed_predict: codes must be [N, F], got %s" % (tuple(codes.shape),))
    _check("codes", codes, torch.int32, dev)
    _check("isnan", isnan, torch.bool, dev, tuple(codes.shape))
    return codes.shape


def _shared_limit(dev: torch.device) -> int:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    limit = _max_shared.get(index)
    if limit is None:
        fn = cuda_build.entry("packed_predict", "lgbt_packed_max_shared",
                              [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
        out = ctypes.c_int(0)
        cuda_build.check(fn(index, ctypes.byref(out)), "packed_predict shared-memory query")
        limit = _max_shared[index] = out.value
    return limit


def leaves_shared_bytes(M: int) -> int:
    """Dynamic shared memory of a packed_predict_leaves block: its tree's nodes."""
    return 2 * M * 16


def values_shared_bytes(M: int, K: int) -> int:
    """Dynamic shared memory of a packed_predict_values block: a round's trees,
    their values and the tile's class accumulators."""
    return 2 * TREES_PER_ROUND * M * 16 + (TREES_PER_ROUND + K) * TILE_ROWS * 4


def node_table(packed: PackedTrees) -> torch.Tensor:
    """[T, M, 8] int32 on the trees' device: each node's (feature, threshold
    rank, left, right) and (missing type | default_left << 2 | is_cat << 3,
    bitset offset, bitset words, 0), the layout csrc/packed_predict.cu
    stages. Built once a ``PackedTrees`` and reused while its node fields
    are the same, unmodified tensors."""
    fields = (packed.feature, packed.thr_rank, packed.left_child, packed.right_child,
              packed.missing_type, packed.default_left, packed.is_cat, packed.cat_off,
              packed.cat_n)
    stamp = tuple((id(t), t.data_ptr(), t._version) for t in fields)
    key = id(packed.feature)
    with _tables_lock:
        hit = _tables.get(key)
    if hit is not None and hit[0]() is packed.feature and hit[1] == stamp:
        return hit[2]
    flags = ((packed.missing_type & 3) | (packed.default_left.to(torch.int32) << 2)
             | (packed.is_cat.to(torch.int32) << 3))
    table = torch.stack([packed.feature, packed.thr_rank, packed.left_child, packed.right_child,
                         flags, packed.cat_off, packed.cat_n, torch.zeros_like(packed.feature)],
                        dim=-1).contiguous()
    with _tables_lock:
        if key not in _tables:  # drop the table with the ensemble's tensors
            weakref.finalize(packed.feature, _tables.pop, key, None)
        _tables[key] = (weakref.ref(packed.feature), stamp, table)
    return table


def _tree_args(packed: PackedTrees):
    return [node_table(packed).data_ptr(), packed.num_leaves.data_ptr(),
            packed.cat_words.data_ptr(), packed.rank0.data_ptr(), packed.zero_lo.data_ptr(),
            packed.zero_hi.data_ptr()]


def packed_bin_rows(X: torch.Tensor, bounds: torch.Tensor,
                    is_cat_feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes [N, F] int32, isnan [N, F] bool) of the f32 rows ``X`` [N, F]:
    each numerical feature's rank among its ``bounds`` row ([F, Bmax] f32,
    padded with +inf; searchsorted side="left" of the value with NaN as 0),
    each categorical feature's (``is_cat_feat`` [F] bool) truncated value."""
    dev = _device(X)
    if X.dim() != 2:
        raise ValueError("packed_predict: X must be [N, F], got %s" % (tuple(X.shape),))
    N, F = X.shape
    _note("packed_bin_rows", dev, (N, F) + tuple(bounds.shape))
    if dev.type == "cpu":
        return plain.packed_bin_rows(X, bounds, is_cat_feat)
    _check("X", X, torch.float32, dev)
    if bounds.dim() != 2 or bounds.shape[0] != F or bounds.shape[1] < 1:
        raise ValueError("packed_predict: bounds must be [%d, Bmax >= 1], got %s"
                         % (F, tuple(bounds.shape)))
    _check("bounds", bounds, torch.float32, dev)
    _check("is_cat_feat", is_cat_feat, torch.bool, dev, (F,))
    codes = torch.empty((N, F), dtype=torch.int32, device=dev)
    isnan = torch.empty((N, F), dtype=torch.bool, device=dev)
    if N * F == 0:
        return codes, isnan
    grid = max(1, min(-(-(N * F) // THREADS), hist_kernel._sm_count(dev) * BIN_BLOCKS_PER_SM))
    fn = cuda_build.entry("packed_predict", "lgbt_packed_bin_rows", _BIN_ARGS)
    cuda_build.check(fn(
        X.data_ptr(), N, F, bounds.data_ptr(), bounds.shape[1], is_cat_feat.data_ptr(),
        codes.data_ptr(), isnan.data_ptr(), grid, torch.cuda.current_stream(dev).cuda_stream,
    ), "packed_bin_rows kernel")
    launches["packed_bin_rows"] += 1
    return codes, isnan


def packed_predict_leaves(codes: torch.Tensor, isnan: torch.Tensor,
                          packed: PackedTrees) -> torch.Tensor:
    """[T, N] int32 leaf indices of every row in every tree of ``packed``."""
    dev = _device(codes)
    N, F = _check_rows(codes, isnan, dev)
    T, M = packed.feature.shape
    _note("packed_predict_leaves", dev, (N, F, T, M))
    if dev.type == "cpu":
        return plain.packed_predict_leaves(codes, isnan, packed)
    _check_packed(packed, dev, F)
    shared = leaves_shared_bytes(M)
    if shared > _shared_limit(dev):
        raise ValueError("packed_predict: a tree of %d nodes does not fit in shared memory "
                         "(%d bytes, at most %d)" % (M, shared, _shared_limit(dev)))
    out = torch.empty((T, N), dtype=torch.int32, device=dev)
    if N == 0 or T == 0:
        return out
    fn = cuda_build.entry("packed_predict", "lgbt_packed_predict_leaves", _LEAVES_ARGS)
    cuda_build.check(fn(
        codes.data_ptr(), isnan.data_ptr(), N, F, *_tree_args(packed), T, M, out.data_ptr(),
        -(-N // THREADS), min(T, MAX_GRID_Y), torch.cuda.current_stream(dev).cuda_stream,
    ), "packed_predict_leaves kernel")
    launches["packed_predict_leaves"] += 1
    return out


def packed_predict_values(codes: torch.Tensor, isnan: torch.Tensor, packed: PackedTrees,
                          num_class: int = 1, average_output: bool = False) -> torch.Tensor:
    """[K, N] f32 raw scores: tree i's leaf value added into class i % K
    (``num_class``) in tree order, divided by the iteration count when
    ``average_output``."""
    dev = _device(codes)
    N, F = _check_rows(codes, isnan, dev)
    T, M = packed.feature.shape
    K = max(int(num_class), 1)
    _note("packed_predict_values", dev, (N, F, T, M, K, bool(average_output)))
    if dev.type == "cpu":
        return plain.packed_predict_values(codes, isnan, packed, K, average_output)
    _check_packed(packed, dev, F)
    shared = values_shared_bytes(M, K)
    if shared > _shared_limit(dev):
        raise ValueError("packed_predict: %d trees of %d nodes and %d classes do not fit in shared "
                         "memory (%d bytes, at most %d)"
                         % (TREES_PER_ROUND, M, K, shared, _shared_limit(dev)))
    out = torch.empty((K, N), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    fn = cuda_build.entry("packed_predict", "lgbt_packed_predict_values", _VALUES_ARGS)
    cuda_build.check(fn(
        codes.data_ptr(), isnan.data_ptr(), N, F, *_tree_args(packed), T, M,
        packed.leaf_value.data_ptr(), packed.leaf_value.shape[1], K, int(bool(average_output)),
        out.data_ptr(), -(-N // TILE_ROWS), torch.cuda.current_stream(dev).cuda_stream,
    ), "packed_predict_values kernel")
    launches["packed_predict_values"] += 1
    return out
