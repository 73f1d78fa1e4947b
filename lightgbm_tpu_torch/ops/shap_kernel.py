"""Wrapper of the hand-written TreeSHAP kernels (csrc/tree_shap.cu).

``tree_shap(X, ens, num_class, num_features)`` gives what ops/shap.py
``contrib_plain`` gives, ``[K, N, F + 1]`` f64, over a :class:`ShapTrees`
built by :func:`shap_trees` on the rows' device: the kernels for CUDA
tensors, the plain PyTorch version for CPU tensors. Any other device, and
anything the kernel does not take, raises, and so does a failed build or
launch; there is no fallback from the card to the plain version.
``launches["tree_shap"]`` counts the launches of the SHAP kernel (each
followed by the in-order sum of its partials).

Scratch, sized from the model and the rows: each resident thread's path
arrays and stack (:func:`slot_bytes`, from the deepest tree), at most
``PATH_BYTES`` in all, so a deep model runs with fewer threads rather than
being refused; and the per-tree partials of a chunk of trees, ``[C, N, F +
1]`` f64, at most ``PARTIAL_BYTES`` (rows x (F + 1), not threads, sets it).
The grid is what the card holds at once of the built kernel
(:func:`resident_blocks`), or fewer where the scratch allows fewer slots;
its blocks loop over the (128 rows, tree) tiles (:func:`launch_plan`).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from ..models.tree import K_CATEGORICAL_MASK, Tree
from . import cuda_build
from .shap import contrib_plain

launches: Dict[str, int] = {"tree_shap": 0}

THREADS = 128
PATH_BYTES = 2 << 30
PARTIAL_BYTES = 256 << 20
STAGE_BYTES = 48 * 1024  # a tree larger than this is read from global memory

NODE_DTYPE = np.dtype([("threshold", "<f8"), ("count", "<f8"), ("feature", "<i4"), ("left", "<i4"),
                       ("right", "<i4"), ("flags", "<i4"), ("cat_lo", "<i4"), ("cat_nw", "<i4")])
LEAF_DTYPE = np.dtype([("value", "<f8"), ("count", "<f8")])
LEGACY_CATEGORICAL = 16  # csrc/tree_shap.cu kLegacyCategorical

_SHAP_ARGS = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
              + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 6
              + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
_SUM_ARGS = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 4
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
_GRID_ARGS = [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.c_longlong]
_resident: Dict[tuple, tuple] = {}


class LaunchPlan(NamedTuple):
    """How :func:`tree_shap` cuts its work on the card (:func:`launch_plan`)."""

    chunk: int  # trees a launch (C): their partials fill at most PARTIAL_BYTES
    grid: int  # blocks of tree_shap_kernel: what the card holds at once, or the scratch allows
    sum_grid: int  # blocks of tree_sum_kernel, over the [K, N, F + 1] output
    tiles: int  # (128 rows, tree) tiles of the first launch; a block loops over tiles / grid
    staged: bool  # the trees staged in shared memory (each at most STAGE_BYTES)
    shared: int  # shared bytes a block


class ShapTrees(NamedTuple):
    """A model's trees as csrc/tree_shap.cu reads them, on one device."""

    trees: List[Tree]  # the host trees (the plain version walks them)
    nodes: torch.Tensor  # [T, M * 40] uint8: NODE_DTYPE records
    leaves: torch.Tensor  # [T, L * 16] uint8: LEAF_DTYPE records
    words: torch.Tensor  # [>= 1] int32: every categorical node's bitset words
    expected: torch.Tensor  # [T] f64: each tree's expected value
    num_leaves: torch.Tensor  # [T] int32
    max_depth: int  # the deepest tree's
    max_feature: int  # the largest split feature (-1 without splits)


def reset_launches() -> None:
    launches["tree_shap"] = 0


def shap_trees(trees: Sequence[Tree], device) -> ShapTrees:
    """Pack ``trees`` into a :class:`ShapTrees` on ``device``: nodes padded
    to the most any tree has (M), leaves to M + 1, categorical bitsets into
    one pool (each node its first word and word count; a categorical node of
    a tree without bitsets is the legacy equality)."""
    trees = list(trees)
    T = len(trees)
    M = max([t.num_leaves - 1 for t in trees] + [1])
    nodes = np.zeros((T, M), NODE_DTYPE)
    leaves = np.zeros((T, M + 1), LEAF_DTYPE)
    pool: List[np.ndarray] = []
    base = 0
    for i, t in enumerate(trees):
        n = t.num_leaves - 1
        leaves["value"][i, :t.num_leaves] = t.leaf_value[:t.num_leaves]
        leaves["count"][i, :t.num_leaves] = t.leaf_count[:t.num_leaves].astype(np.float64)
        if n <= 0:
            continue
        dt = t.decision_type[:n].astype(np.int32) & 0xF
        cat = (dt & K_CATEGORICAL_MASK) > 0
        rec = nodes[i, :n]
        rec["threshold"] = t.threshold[:n]
        rec["count"] = t.internal_count[:n].astype(np.float64)
        rec["feature"] = t.split_feature[:n]
        rec["left"] = t.left_child[:n]
        rec["right"] = t.right_child[:n]
        if t.num_cat > 0:
            rec["flags"] = dt
            idx = np.where(cat, t.threshold[:n], 0).astype(np.int64)
            bounds = np.asarray(t.cat_boundaries, np.int64)
            rec["cat_lo"] = np.where(cat, base + bounds[idx], 0)
            rec["cat_nw"] = np.where(cat, bounds[idx + 1] - bounds[idx], 0)
            pool.append(np.asarray(t.cat_threshold, np.uint32))
            base += len(t.cat_threshold)
        else:
            rec["flags"] = dt | np.where(cat, LEGACY_CATEGORICAL, 0)
    words = np.concatenate(pool) if pool else np.zeros(1, np.uint32)
    dev = torch.device(device)
    return ShapTrees(
        trees=trees,
        nodes=torch.from_numpy(nodes.view(np.uint8).reshape(T, -1).copy()).to(dev),
        leaves=torch.from_numpy(leaves.view(np.uint8).reshape(T, -1).copy()).to(dev),
        words=torch.from_numpy(words.view(np.int32).copy()).to(dev),
        expected=torch.tensor([t._expected_value_cached() for t in trees], dtype=torch.float64,
                              device=dev),
        num_leaves=torch.tensor([t.num_leaves for t in trees], dtype=torch.int32, device=dev),
        max_depth=max([t._max_depth_cached() for t in trees] + [0]),
        max_feature=max([int(t.split_feature[:t.num_leaves - 1].max())
                         for t in trees if t.num_leaves > 1] + [-1]),
    )


def path_positions(max_depth: int) -> int:
    """Path positions a slot holds: the reference's triangular layout for
    maxd = max_depth + 2 (lightgbm_tpu/models/tree.py:477-482)."""
    maxd = max_depth + 2
    return maxd * (maxd + 1) // 2 + maxd


def slot_bytes(max_depth: int) -> int:
    """Scratch bytes of one thread: its path positions (an int32 and three
    f64 each) and its stack frames (four int32 and two f64 each)."""
    return path_positions(max_depth) * (4 + 3 * 8) + (max_depth + 2) * (4 * 4 + 2 * 8)


def resident_blocks(device: torch.device, shared: int) -> tuple:
    """(tree_shap_kernel's, tree_sum_kernel's) blocks that ``device`` holds at
    once, the first with ``shared`` bytes a block (``lgbt_tree_shap_grid``:
    the occupancy a multiprocessor, from the built kernel, times the SMs)."""
    key = (torch.device(device).index, int(shared))
    got = _resident.get(key)
    if got is None:
        fn = cuda_build.entry("tree_shap", "lgbt_tree_shap_grid", _GRID_ARGS)
        shap_blocks, sum_blocks = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device):
            cuda_build.check(fn(ctypes.byref(shap_blocks), ctypes.byref(sum_blocks), int(shared)),
                             "tree_shap occupancy")
        if shap_blocks.value < 1 or sum_blocks.value < 1:
            raise RuntimeError("tree_shap: no block of %d shared bytes fits on the card" % shared)
        got = _resident[key] = (shap_blocks.value, sum_blocks.value)
    return got


def launch_plan(ens: ShapTrees, num_rows: int, num_features: int, num_class: int,
                device) -> LaunchPlan:
    """The chunk of trees, grids and staging :func:`tree_shap` launches with
    for ``num_rows`` rows of ``num_features`` features and ``num_class``
    classes on the CUDA ``device``."""
    N, F, K = int(num_rows), int(num_features), max(int(num_class), 1)
    M = ens.nodes.shape[1] // NODE_DTYPE.itemsize
    L = ens.leaves.shape[1] // LEAF_DTYPE.itemsize
    tree_bytes = M * NODE_DTYPE.itemsize + L * LEAF_DTYPE.itemsize
    staged = tree_bytes <= STAGE_BYTES
    shared = tree_bytes if staged else 0
    C = int(max(1, min(len(ens.trees), PARTIAL_BYTES // (N * (F + 1) * 8))))
    shap_blocks, sum_blocks = resident_blocks(device, shared)
    tiles = -(-N // THREADS) * C
    slots = max(1, PATH_BYTES // slot_bytes(ens.max_depth) // THREADS)
    sum_grid = -(-(K * N * (F + 1)) // 256)
    return LaunchPlan(chunk=C, grid=int(max(1, min(tiles, shap_blocks, slots))),
                      sum_grid=int(max(1, min(sum_grid, sum_blocks))), tiles=tiles,
                      staged=staged, shared=shared)


def tree_shap(X: torch.Tensor, ens: ShapTrees, num_class: int, num_features: int) -> torch.Tensor:
    """``[K, N, F + 1]`` f64 SHAP values of the f64 rows ``X`` [N, >= F] over
    the trees of ``ens``, tree i added into class i % K in tree order; the
    last column of each class holds the sum of its trees' expected values."""
    dev = X.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError("tree_shap: unsupported device %s" % dev)
    K = max(int(num_class), 1)
    F = int(num_features)
    if X.dim() != 2:
        raise ValueError("tree_shap: X must be [N, F], got %s" % (tuple(X.shape),))
    if ens.max_feature >= min(F, X.shape[1]):
        raise ValueError("tree_shap: a tree splits on feature %d but X has %d columns and phi %d"
                         % (ens.max_feature, X.shape[1], F))
    if dev.type == "cpu":
        return contrib_plain(X, ens.trees, K, F)
    if X.dtype != torch.float64 or not X.is_contiguous():
        raise ValueError("tree_shap: X must be a contiguous float64 tensor, got %s" % X.dtype)
    for name in ("nodes", "leaves", "words", "expected", "num_leaves"):
        t = getattr(ens, name)
        if t.device != dev or not t.is_contiguous():
            raise ValueError("tree_shap: %s must be a contiguous tensor on %s, got %s"
                             % (name, dev, t.device))
    N = X.shape[0]
    T = len(ens.trees)
    out = torch.zeros((K, N, F + 1), dtype=torch.float64, device=dev)
    if N == 0 or T == 0:
        return out
    plan = launch_plan(ens, N, F, K, dev)
    C, grid = plan.chunk, plan.grid
    M = ens.nodes.shape[1] // NODE_DTYPE.itemsize
    L = ens.leaves.shape[1] // LEAF_DTYPE.itemsize
    partial = torch.empty((C, N, F + 1), dtype=torch.float64, device=dev)
    S = grid * THREADS
    P = path_positions(ens.max_depth)
    Q = ens.max_depth + 2
    fidx = torch.empty(P * S, dtype=torch.int32, device=dev)
    fracs = torch.empty((3, P * S), dtype=torch.float64, device=dev)
    st_int = torch.empty(4 * Q * S, dtype=torch.int32, device=dev)
    st_dbl = torch.empty(2 * Q * S, dtype=torch.float64, device=dev)
    shap_fn = cuda_build.entry("tree_shap", "lgbt_tree_shap", _SHAP_ARGS)
    sum_fn = cuda_build.entry("tree_shap", "lgbt_tree_sum", _SUM_ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for t0 in range(0, T, C):
        c = min(C, T - t0)
        partial[:c].zero_()
        cuda_build.check(shap_fn(
            X.data_ptr(), N, X.shape[1], F, ens.nodes.data_ptr(), ens.leaves.data_ptr(),
            ens.words.data_ptr(), ens.expected.data_ptr(), ens.num_leaves.data_ptr(), t0, c, M, L,
            int(plan.staged), fidx.data_ptr(), fracs[0].data_ptr(), fracs[1].data_ptr(),
            fracs[2].data_ptr(), st_int.data_ptr(), st_dbl.data_ptr(), P, Q, partial.data_ptr(),
            grid, stream), "tree_shap kernel")
        launches["tree_shap"] += 1
        cuda_build.check(sum_fn(partial.data_ptr(), N, F, K, t0, c, out.data_ptr(),
                                plan.sum_grid, stream), "tree_shap sum kernel")
    return out
