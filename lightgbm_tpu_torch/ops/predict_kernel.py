"""Wrapper of the hand-written bin-space predict kernel (csrc/predict_bins.cu).

``add_tree_value`` adds one tree's value at each row's leaf to a score
vector: the kernel for CUDA tensors, the plain PyTorch version
(ops/predict.py ``add_tree_value``) for CPU tensors; any other device, and
anything the kernel does not take, raises, and so does a failed build or
launch. ``launches`` counts the calls that launched the kernel, by
instantiation: ``predict_bins``, and ``predict_bins_wide`` for int16 bins
(``predict_bins_wide_efb`` for int16 groups of a bundled table).

The tree is read as the device-resident split loop keeps it
(ops/grow_state.py): ``node_i`` rows (feature, threshold, left, right,
default_left), with categorical features ``node_b`` rows (each node's
membership words), and the leaf count in device memory, so models/gbdt.py
calls it inside the captured boosting iteration for every validation set.
Over EFB-bundled bins (``group_id`` and ``bin_offset`` in the meta) the
kernel's bundled instantiations decode each read.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import cuda_build, hist_kernel
from . import predict as plain

KERNELS = ("predict_bins", "predict_bins_wide", "predict_bins_wide_efb")
launches: Dict[str, int] = {}


def reset_launches() -> None:
    """Every launch count of this module to 0."""
    launches.update(dict.fromkeys(KERNELS, 0))


reset_launches()

#: the nodes a block stages in shared memory, 16 bytes each, up to 227 KB
MAX_NODES = 227 * 1024 // 16
THREADS = 256
BLOCKS_PER_SM = 8
_META_KEYS = ("num_bin", "missing_type", "default_bin")
_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 9 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 2 + [ctypes.c_void_p]
)


def grid(N: int, num_sms: int) -> int:
    """Blocks of a launch over N rows: one row a thread, at most
    BLOCKS_PER_SM blocks an SM (a grid-stride loop takes the rest)."""
    return max(1, min(-(-N // THREADS), num_sms * BLOCKS_PER_SM))


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, dev: torch.device, shape=None) -> None:
    if (t.device != dev or t.dtype != dtype or not t.is_contiguous()
            or (shape is not None and tuple(t.shape) != tuple(shape))):
        raise ValueError("predict_bins: %s must be a contiguous %s tensor%s on %s, got %s %s on %s"
                         % (name, dtype, "" if shape is None else " of shape %s" % (shape,), dev,
                            t.dtype, tuple(t.shape), t.device))


def add_tree_value(
    bins: torch.Tensor,
    node_i: torch.Tensor,
    num_leaves: torch.Tensor,
    feature_meta: Dict[str, torch.Tensor],
    value: torch.Tensor,
    score: torch.Tensor,
    leaf_out: Optional[torch.Tensor] = None,
    node_b: Optional[torch.Tensor] = None,
) -> None:
    """``score[r] += value[leaf(r)]`` for every row of ``bins`` ([N, F]
    uint8 or int16, or ``[N, G]`` with the meta's EFB plan), through
    the tree of ``num_leaves[0]`` leaves whose nodes are the first rows of
    ``node_i`` ([K, 5] int32) and, with ``is_categorical`` in the meta, of
    ``node_b`` ([K, W] int32 membership words); ``value`` [> K] f32,
    ``score`` [N] f32 updated in place, ``leaf_out`` optional [N] int32.
    Reads nothing back on CUDA."""
    dev = bins.device
    if dev.type == "cpu":
        plain.add_tree_value(bins, node_i, num_leaves, feature_meta, value, score, leaf_out, node_b)
        return
    if dev.type != "cuda":
        raise ValueError("predict_bins: unsupported device %s" % dev)
    if bins.dim() != 2:
        raise ValueError("predict_bins: bins must be [N, F], got %s" % (tuple(bins.shape),))
    N, C = bins.shape
    F = feature_meta["num_bin"].numel()
    efb = "group_id" in feature_meta
    if not efb and C != F:
        raise ValueError("predict_bins: bins has %d columns for %d features" % (C, F))
    wide = bins.dtype == torch.int16
    _check("bins", bins, torch.int16 if wide else torch.uint8, dev)
    if node_i.dim() != 2 or node_i.shape[1] != 5:
        raise ValueError("predict_bins: node_i must be [K, 5], got %s" % (tuple(node_i.shape),))
    _check("node_i", node_i, torch.int32, dev)
    K = node_i.shape[0]
    if K > MAX_NODES:
        raise ValueError("predict_bins: %d nodes do not fit in shared memory (at most %d)"
                         % (K, MAX_NODES))
    if num_leaves.numel() < 1:
        raise ValueError("predict_bins: num_leaves must hold the leaf count")
    _check("num_leaves", num_leaves, torch.int32, dev)
    for k in _META_KEYS + (("group_id", "bin_offset") if efb else ()):
        _check(k, feature_meta[k], torch.int32, dev, (F,))
    if value.dim() != 1 or value.numel() < K + 1:
        raise ValueError("predict_bins: value must be [> %d], got %s" % (K, tuple(value.shape)))
    _check("value", value, torch.float32, dev)
    _check("score", score, torch.float32, dev, (N,))
    if leaf_out is not None:
        _check("leaf_out", leaf_out, torch.int32, dev, (N,))
    is_cat = feature_meta.get("is_categorical")
    W = 0
    if is_cat is not None:
        _check("is_categorical", is_cat, torch.bool, dev, (F,))
        if node_b is None or node_b.dim() != 2 or node_b.shape[0] != K or node_b.shape[1] < 1:
            raise ValueError("predict_bins: node_b must be [%d, W >= 1] with categorical features"
                             % K)
        _check("node_b", node_b, torch.int32, dev)
        W = node_b.shape[1]
        if K * (16 + 4 * W) > MAX_NODES * 16:
            raise ValueError("predict_bins: %d nodes of %d words do not fit in shared memory"
                             % (K, W))
    fn = cuda_build.entry("predict_bins", "lgbt_predict_bins", _ARGTYPES)
    cuda_build.check(fn(
        bins.data_ptr(), N, C, node_i.data_ptr(), K, num_leaves.data_ptr(),
        feature_meta["missing_type"].data_ptr(), feature_meta["default_bin"].data_ptr(),
        feature_meta["num_bin"].data_ptr(), value.data_ptr(), score.data_ptr(),
        None if leaf_out is None else leaf_out.data_ptr(),
        None if is_cat is None else node_b.data_ptr(),
        None if is_cat is None else is_cat.data_ptr(), W,
        feature_meta["group_id"].data_ptr() if efb else None,
        feature_meta["bin_offset"].data_ptr() if efb else None, 2 if wide else 1,
        grid(N, hist_kernel._sm_count(dev)), torch.cuda.current_stream(dev).cuda_stream,
    ), "predict_bins kernel")
    launches["predict_bins" + ("_wide" if wide else "") + ("_efb" if wide and efb else "")] += 1
