"""Stable partition of a leaf's row segment: the plain PyTorch version.

Counterpart of lightgbm_tpu/ops/grow.py's ``partition_segment`` (the
bucketed grower's stable partition, data_partition.hpp:111): the rows
``order[begin : begin + count]`` of the split leaf become ``[left | right]``
(by the numerical or the categorical decision) in their old relative order, so the segment keeps the reference's ``[pre |
left | right | post]`` layout. On an EFB-bundled table the decision reads the
feature's group row and decodes it first (ops/remap.py ``decode_col``,
lightgbm_tpu/ops/grow.py:1298-1301). With ops/grow_step.py ``pick`` before it, the
oracle of csrc/partition.cu (ops/partition_kernel.py ``pick_partition``) and
the path taken for CPU tensors.
"""
from __future__ import annotations

import torch

from . import grow_state as gs
from .remap import decode_col
from .split import MISSING_NAN, MISSING_ZERO, words_member


def go_left(col, threshold, default_left, missing, default_bin, nan_bin, member=None):
    """Bin-space decision (dense_bin.hpp Split): numerical, or with
    ``member`` (bool over bins, a categorical split's left side) the bitset
    lookup alone (CategoricalDecisionInner, tree.h:275)."""
    if member is not None:
        return member[col.long()]
    go_left = col <= threshold
    if missing == MISSING_ZERO:
        go_left[col == default_bin] = default_left
    elif missing == MISSING_NAN:
        go_left[col == nan_bin] = default_left
    return go_left


def stable_partition(order, bins, begin, count, feature, threshold, default_left, meta,
                     bits=None) -> int:
    """Partition ``order[begin : begin + count]`` in place by the split
    (``feature``, ``threshold``, ``default_left``, and its membership words
    ``bits`` [W] int32 when the feature is categorical) on ``bins`` [F, N]
    (an EFB-bundled table's [G, N], with the plan in the meta), with the
    feature's ``meta`` (num_bin / missing_type / default_bin arrays and
    is_categorical when there are such features, read on the host: the host
    split loop passes CPU copies); returns the left count. The segment
    becomes ``torch.cat([seg[gl], seg[~gl]])``."""
    seg = order[begin:begin + count]
    if "group_id" in meta:
        col = decode_col(bins[int(meta["group_id"][feature])].index_select(0, seg),
                         int(meta["bin_offset"][feature]), int(meta["default_bin"][feature]),
                         int(meta["num_bin"][feature]))
    else:
        col = bins[feature].index_select(0, seg)
    is_cat = meta.get("is_categorical")
    member = None
    if is_cat is not None and bool(is_cat[feature]):
        member = words_member(bits.to(col.device), 32 * bits.shape[-1])
    gl = go_left(
        col, threshold, bool(default_left), int(meta["missing_type"][feature]),
        int(meta["default_bin"][feature]), int(meta["num_bin"][feature]) - 1, member,
    )
    left = seg[gl]
    order[begin:begin + count] = torch.cat([left, seg[~gl]])
    return left.numel()


def partition(s: gs.GrowState) -> None:
    """The split loop's partition step on the state ``s``: the segment of
    leaf ``ctl[BEST]`` by the split the pick just wired (node ``ctl[STEP] -
    1``: its feature, threshold, default_left and membership words, the
    leaf's best record or a forced one); the children's (begin, count) and
    ``ctl[PBEGIN/PCOUNT/LEFT]`` written as csrc/partition.cu writes them.
    Nothing once ``ctl[ACTIVE]`` is 0."""
    ctl = s.ctl
    if not int(ctl[gs.ACTIVE]):
        return
    leaf, new = int(ctl[gs.BEST]), int(ctl[gs.NEW])
    node = int(ctl[gs.STEP]) - 1
    f, thr, dl = (int(s.node_i[node, c]) for c in (0, 1, 4))
    b0, cnt = int(s.leaf_begin[leaf]), int(s.leaf_count[leaf])
    left = stable_partition(s.order, s.bins, b0, cnt, f, thr, dl, s.feature_meta, s.node_b[node])
    ctl[gs.PBEGIN], ctl[gs.PCOUNT], ctl[gs.LEFT] = b0, cnt, left
    s.leaf_count[leaf] = left
    s.leaf_begin[new] = b0 + left
    s.leaf_count[new] = cnt - left
