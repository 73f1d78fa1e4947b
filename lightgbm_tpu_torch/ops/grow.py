"""Leaf-wise (best-first) tree growth, sequential bucketed mode.

Counterpart of lightgbm_tpu/ops/grow.py ``grow_tree`` (SerialTreeLearner::
Train, serial_tree_learner.cpp:173-237) for numerical, unbundled data:

 * a DataPartition-style row permutation: each split stably partitions the
   leaf's contiguous segment of ``order`` (data_partition.hpp:111);
 * one histogram of the root, then per split one histogram of the smaller
   child read in place through its segment of ``order``; the larger child's
   histogram is the parent's minus the smaller one's (serial_tree_learner.
   cpp:510);
 * both children's best splits from one two-child scan;
 * monotone-constraint windows per leaf (serial_tree_learner.cpp:841-850)
   and ``max_depth``.

The split loop runs on the host: per split it reads the partition's left
count and the children's packed split records back (two small syncs), picks
the best leaf with a host argmax, and wires the tree in host tensors. The
histogram and the split scan are the hand-written kernels on CUDA tensors
and their plain versions on CPU tensors (ops/hist_kernel.py,
ops/split_kernel.py). The output is the JAX package's bin-space
``TreeArrays`` plus the per-row leaf index.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import hist_kernel, split_kernel
from .histogram import leaf_values
from .split import MISSING_NAN, MISSING_ZERO, SplitParams, calculate_leaf_output


class TreeArrays(NamedTuple):
    """Flat-array decision tree (bin-space thresholds), mirroring tree.h:58-522.
    Host (CPU) tensors; layout and dtypes of lightgbm_tpu/ops/grow.py."""

    num_leaves: torch.Tensor  # scalar int32: leaves actually grown
    split_feature: torch.Tensor  # [M-1] int32 (used-feature index)
    threshold_bin: torch.Tensor  # [M-1] int32
    default_left: torch.Tensor  # [M-1] bool
    left_child: torch.Tensor  # [M-1] int32 (node idx, or -(leaf+1) for leaves)
    right_child: torch.Tensor  # [M-1] int32
    split_gain: torch.Tensor  # [M-1] f32
    internal_value: torch.Tensor  # [M-1] f32
    internal_count: torch.Tensor  # [M-1] f32
    leaf_value: torch.Tensor  # [M] f32
    leaf_count: torch.Tensor  # [M] f32
    leaf_weight: torch.Tensor  # [M] f32 (sum of hessians)
    leaf_parent: torch.Tensor  # [M] int32
    leaf_depth: torch.Tensor  # [M] int32
    cat_member: torch.Tensor  # [M-1, B] bool: left-side bin membership


# packed record columns (ops/split.py BEST_F / BEST_I)
_GAIN, _LG, _LH, _LC, _RG, _RH, _RC, _LO, _RO = range(9)
_FEAT, _THR, _NCAT, _DL = range(4)


def _go_left(col, threshold, default_left, missing, default_bin, nan_bin):
    """Bin-space numerical decision (dense_bin.hpp Split)."""
    go_left = col <= threshold
    if missing == MISSING_ZERO:
        go_left[col == default_bin] = default_left
    elif missing == MISSING_NAN:
        go_left[col == nan_bin] = default_left
    return go_left


def grow_tree(
    bins: torch.Tensor,  # [F, N] uint8
    grad: torch.Tensor,  # [N] f32
    hess: torch.Tensor,  # [N] f32
    feature_mask: torch.Tensor,  # [F] bool
    feature_meta: Dict[str, torch.Tensor],  # int32 [F]: num_bin/missing_type/default_bin/monotone
    num_leaves: int,
    max_depth: int,
    num_bins: int,
    params: SplitParams,
    two_way: bool = True,
    bins_nf: Optional[torch.Tensor] = None,  # [N, F] copy of bins for the histograms
) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one tree; returns (TreeArrays, leaf_id [N] int64 on the bins' device)."""
    dev = bins.device
    F, N = bins.shape
    M = num_leaves
    B = num_bins
    f32 = torch.float32
    meta_h = {k: feature_meta[k].cpu() for k in ("num_bin", "missing_type", "default_bin", "monotone")}
    hist_bins = bins_nf.t() if bins_nf is not None else bins

    def split2(idx, laux_rows):
        aux = laux_rows.to(dev)
        outf, outi = split_kernel.find_best_split_pair(
            hist[idx], aux[:, :3].contiguous(), aux[:, 3:].contiguous(),
            feature_meta, feature_mask, params, two_way,
        )
        return outf.cpu(), outi.cpu()

    # ---- root ------------------------------------------------------------
    vals_all = leaf_values(grad, hess, torch.ones(N, dtype=f32, device=dev))
    hist = torch.empty((M, F, B, 3), dtype=f32, device=dev)
    hist[0] = hist_kernel.histogram(hist_bins, vals_all, B)
    root = torch.stack([grad.sum(), hess.sum(), vals_all[:, 2].sum()]).cpu()

    # [M, 5] leaf aux: sum_grad, sum_hess, num_data, monotone min, max
    laux = torch.zeros((M, 5), dtype=f32)
    laux[0, :3] = root
    laux[:, 3] = -math.inf
    laux[:, 4] = math.inf
    node_f = torch.zeros((M, 3), dtype=f32)  # split_gain, internal_value, internal_count
    node_i = torch.zeros((M, 4), dtype=torch.int32)  # feature, threshold, left, right
    node_b = torch.zeros((M, 1 + B), dtype=torch.bool)  # default_left | cat_member
    leaf_f = torch.zeros((M, 3), dtype=f32)  # leaf_value, leaf_count, leaf_weight
    leaf_i = torch.zeros((M, 2), dtype=torch.int32)  # leaf_parent, leaf_depth
    leaf_i[:, 0] = -1
    leaf_f[0] = torch.stack([calculate_leaf_output(root[0], root[1], params), root[2], root[1]])
    best_f = torch.zeros((M, 9), dtype=f32)
    best_f[:, _GAIN] = -math.inf
    best_i = torch.zeros((M, 4), dtype=torch.int32)
    if M > 1:
        best_f[:1], best_i[:1] = split2([0], laux[:1])

    order = torch.arange(N, dtype=torch.int32, device=dev)
    leaf_begin = [0] * M
    leaf_phys = [0] * M
    leaf_phys[0] = N
    nl = 1
    for node in range(M - 1):
        best_leaf = int(torch.argmax(best_f[:, _GAIN]))
        if not best_f[best_leaf, _GAIN] > 0.0:
            break
        rec_f = best_f[best_leaf].clone()
        f, thr, _, dl = (int(v) for v in best_i[best_leaf])
        new_leaf = nl

        # ---- stable partition of the leaf's segment ----------------------
        b0, cnt = leaf_begin[best_leaf], leaf_phys[best_leaf]
        seg = order[b0:b0 + cnt]
        col = bins[f].index_select(0, seg)
        gl = _go_left(
            col, thr, bool(dl), int(meta_h["missing_type"][f]),
            int(meta_h["default_bin"][f]), int(meta_h["num_bin"][f]) - 1,
        )
        left_rows, right_rows = seg[gl], seg[~gl]
        left_phys = left_rows.numel()
        order[b0:b0 + cnt] = torch.cat([left_rows, right_rows])

        # ---- wire the tree ------------------------------------------------
        parent = int(leaf_i[best_leaf, 0])
        if parent >= 0:
            for c in (2, 3):
                if int(node_i[parent, c]) == -(best_leaf + 1):
                    node_i[parent, c] = node
        depth = int(leaf_i[best_leaf, 1]) + 1
        paux = laux[best_leaf].clone()
        node_i[node] = torch.tensor([f, thr, -(best_leaf + 1), -(new_leaf + 1)], dtype=torch.int32)
        node_f[node] = torch.stack(
            [rec_f[_GAIN], calculate_leaf_output(paux[0], paux[1], params), paux[2]]
        )
        node_b[node, 0] = bool(dl)
        node_b[node, 1 + thr] = True  # one-hot of the threshold (numerical split)
        leaf_f[best_leaf] = rec_f[[_LO, _LC, _LH]]
        leaf_f[new_leaf] = rec_f[[_RO, _RC, _RH]]
        leaf_i[best_leaf] = torch.tensor([node, depth], dtype=torch.int32)
        leaf_i[new_leaf] = torch.tensor([node, depth], dtype=torch.int32)

        # ---- leaf sums + monotone windows --------------------------------
        mono = int(meta_h["monotone"][f])
        mid = (rec_f[_LO] + rec_f[_RO]) / 2.0
        pmin, pmax = paux[3], paux[4]
        l_min = mid if mono < 0 else pmin
        l_max = mid if mono > 0 else pmax
        r_min = mid if mono > 0 else pmin
        r_max = mid if mono < 0 else pmax
        laux[best_leaf] = torch.stack([rec_f[_LG], rec_f[_LH], rec_f[_LC], l_min, l_max])
        laux[new_leaf] = torch.stack([rec_f[_RG], rec_f[_RH], rec_f[_RC], r_min, r_max])
        leaf_begin[new_leaf] = b0 + left_phys
        leaf_phys[best_leaf] = left_phys
        leaf_phys[new_leaf] = cnt - left_phys

        # ---- histograms: smaller child from data, larger by subtraction --
        left_smaller = bool(rec_f[_LC] <= rec_f[_RC])
        small_idx, large_idx = (best_leaf, new_leaf) if left_smaller else (new_leaf, best_leaf)
        s_begin = leaf_begin[small_idx]
        small = hist_kernel.histogram(
            hist_bins, vals_all, B, rows=order[s_begin:s_begin + leaf_phys[small_idx]]
        )
        large = hist[best_leaf] - small
        hist[small_idx] = small
        hist[large_idx] = large
        nl += 1

        # ---- both children's best splits ---------------------------------
        ch = [best_leaf, new_leaf]
        outf, outi = split2(ch, laux[ch])
        if max_depth > 0 and depth >= max_depth:
            outf[:, _GAIN] = -math.inf
        best_f[ch] = outf
        best_i[ch] = outi

    # per-row leaf index from the segment layout
    begins = torch.tensor(leaf_begin[:nl])
    by_begin = torch.argsort(begins)
    counts = torch.tensor(leaf_phys[:nl])[by_begin]
    pos_leaf = torch.repeat_interleave(by_begin, counts).to(dev)
    leaf_id = torch.empty(N, dtype=torch.int64, device=dev)
    leaf_id[order.long()] = pos_leaf
    tree = TreeArrays(
        num_leaves=torch.tensor(nl, dtype=torch.int32),
        split_feature=node_i[: M - 1, 0],
        threshold_bin=node_i[: M - 1, 1],
        default_left=node_b[: M - 1, 0],
        left_child=node_i[: M - 1, 2],
        right_child=node_i[: M - 1, 3],
        split_gain=node_f[: M - 1, 0],
        internal_value=node_f[: M - 1, 1],
        internal_count=node_f[: M - 1, 2],
        leaf_value=leaf_f[:, 0],
        leaf_count=leaf_f[:, 1],
        leaf_weight=leaf_f[:, 2],
        leaf_parent=leaf_i[:, 0],
        leaf_depth=leaf_i[:, 1],
        cat_member=node_b[: M - 1, 1:],
    )
    return tree, leaf_id
