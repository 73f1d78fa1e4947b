"""Tree traversal in plain PyTorch: over raw features and over bins.

Raw space (``raw_predict_leaf``, ``ensemble_predict_raw``): the
counterpart of the JAX package's raw-feature prediction
(lightgbm_tpu/models/gbdt.py ``predict_raw`` over models/tree.py
``predict_leaf_fast``): every row advances one tree level per step, with
NumericalDecision semantics (tree.h:216-255) in double precision or, at a
categorical node, CategoricalDecision's (tree.h:257-271: the value
truncated to an int, looked up in the node's bitset over category values;
a negative value, one outside the bitset, and NaN under missing NaN go
right), and the trees' values are summed in f64 in boosting order.

Bin space (``make_predict_tree``, ``tree_predict_leaf``,
``tree_predict_value``, ``add_tree_value``): the counterpart of
lightgbm_tpu/ops/predict.py over an ``[N, F]`` row-major bin matrix (uint8,
or int16 past 256 bins a feature) binned with the training set's mappers: a node's decision is an integer
compare plus the missing-bin rules (dense_bin.hpp Split), or at a
categorical node the lookup of the row's bin in the node's left-side
membership (CategoricalDecisionInner, tree.h:275). Over an EFB-bundled
``[N, G]`` matrix (the meta's ``group_id`` and ``bin_offset``) a node reads
its feature's group column and decodes the byte to the feature's sub-bin
first (lightgbm_tpu/ops/predict.py:104-109). The validation scores and the
rollback use it. ``add_tree_value`` is the plain version of the
hand-written kernel csrc/predict_bins.cu (ops/predict_kernel.py) and the
path taken for CPU tensors.

Packed space (``PackedTrees``, ``packed_bin_rows``,
``packed_predict_leaves``, ``packed_predict_values``): the serving path's
dense rank-space ensemble, lightgbm_tpu/ops/predict.py:160-319. Every
numerical feature gets a sorted lattice of the thresholds the model uses
(serve/packed.py ``model_lattice``), rows are converted raw -> rank once,
and each node decision is an integer compare, so ``rank(x) <= rank(thr)``
holds exactly when ``x <= thr``. These are the plain versions of the
hand-written kernels of csrc/packed_predict.cu (ops/packed_kernel.py) and
the path taken for CPU tensors: ``packed_predict_values`` sums each
class's trees one f32 add a tree in tree order, as the kernel does.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..binning import MISSING_NAN, MISSING_ZERO
from ..models.tree import K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK, K_ZERO_THRESHOLD, Tree
from .split import words_member


def raw_predict_leaf(X: torch.Tensor, tree: Tree) -> torch.Tensor:
    """Leaf index per row of the f64 ``[N, F]`` raw feature matrix ``X``."""
    n = X.shape[0]
    dev = X.device
    if tree.num_leaves <= 1:
        return torch.zeros(n, dtype=torch.int64, device=dev)

    def arr(a, dtype):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    feat = arr(tree.split_feature, torch.int64)
    thr = arr(tree.threshold, torch.float64)
    dt = arr(tree.decision_type, torch.int32)
    miss = (dt >> 2) & 3
    dl = (dt & K_DEFAULT_LEFT_MASK) > 0
    is_cat = (dt & K_CATEGORICAL_MASK) > 0
    if tree.num_cat > 0:
        bounds = arr(tree.cat_boundaries, torch.int64)
        words = arr(tree.cat_threshold, torch.int64)
    left = arr(tree.left_child, torch.int64)
    right = arr(tree.right_child, torch.int64)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    for _ in range(tree.num_leaves - 1):
        active = node >= 0
        if not bool(active.any()):
            break
        nd = node.clamp(min=0)
        fv = X.gather(1, feat[nd][:, None])[:, 0]
        m = miss[nd]
        nan = torch.isnan(fv)
        fv = torch.where(nan & (m != MISSING_NAN), torch.zeros_like(fv), fv)
        is_zero = (fv > -K_ZERO_THRESHOLD) & (fv <= K_ZERO_THRESHOLD)
        use_default = ((m == MISSING_ZERO) & is_zero) | ((m == MISSING_NAN) & torch.isnan(fv))
        go_left = torch.where(use_default, dl[nd], fv <= thr[nd])
        raw = X.gather(1, feat[nd][:, None])[:, 0]
        if tree.num_cat > 0:
            # bitset membership (FindInBitset); NaN: right under missing NaN, else category 0
            iv = torch.trunc(torch.where(nan, torch.zeros_like(raw), raw)).to(torch.int64)
            cat_idx = torch.where(is_cat[nd], thr[nd], torch.zeros_like(thr[nd])).to(torch.int64)
            lo = bounds[cat_idx]
            w = iv >> 5
            in_range = (iv >= 0) & (w < bounds[cat_idx + 1] - lo)
            word = words[torch.clamp(lo + w, 0, max(words.numel() - 1, 0))] if words.numel() \
                else torch.zeros_like(iv)
            bit = (word >> (iv & 31)) & 1
            cat_left = in_range & (bit > 0) & ~(nan & (m == MISSING_NAN))
        else:  # single-category equality (model files without bitsets)
            iv = torch.trunc(torch.where(nan, torch.full_like(raw, -1.0), raw)).to(torch.int64)
            cat_left = ~nan & (iv == thr[nd].to(torch.int64))
        go_left = torch.where(is_cat[nd], cat_left, go_left)
        nxt = torch.where(go_left, left[nd], right[nd])
        node = torch.where(active, nxt, node)
    return -(node + 1)


def ensemble_predict_raw(X: torch.Tensor, trees: Sequence[Tree],
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N] f64 sum of the trees' values, accumulated tree by tree onto
    ``out`` (the running sums of earlier trees, added to in place) or onto
    zeros."""
    if out is None:
        out = torch.zeros(X.shape[0], dtype=torch.float64, device=X.device)
    for t in trees:
        values = torch.as_tensor(t.leaf_value, dtype=torch.float64, device=X.device)
        out += values[raw_predict_leaf(X, t)]
    return out


class PredictTree(NamedTuple):
    """A tree's nodes with their features' missing-bin rules, for a
    traversal in bin space (lightgbm_tpu/ops/predict.py ``PredictTree``)."""

    split_feature: torch.Tensor  # [M-1] int64
    threshold_bin: torch.Tensor  # [M-1] int64
    default_left: torch.Tensor  # [M-1] bool
    left_child: torch.Tensor  # [M-1] int64 (node, or -(leaf+1))
    right_child: torch.Tensor  # [M-1] int64
    leaf_value: torch.Tensor  # [M] f32
    missing_type: torch.Tensor  # [M-1] int64, of each node's feature
    default_bin: torch.Tensor  # [M-1] int64
    nan_bin: torch.Tensor  # [M-1] int64 (the feature's num_bin - 1)
    num_leaves: int
    is_cat: torch.Tensor  # [M-1] bool: the node's feature is categorical
    cat_member: torch.Tensor  # [M-1, B'] bool: a categorical node's left-side bins
    column: torch.Tensor  # [M-1] int64: the bin column read (the group, bundled)
    bin_offset: torch.Tensor  # [M-1] int64: the feature's offset in its group (bundled)
    efb: bool  # the bins are EFB-bundled: decode each read


def predict_tree(split_feature, threshold_bin, default_left, left_child, right_child,
                 leaf_value, num_leaves: int, feature_meta: Dict[str, torch.Tensor],
                 cat_member=None) -> PredictTree:
    """A :class:`PredictTree` from a tree's node arrays and the features'
    meta (``num_bin``, ``missing_type``, ``default_bin``, and
    ``is_categorical`` with ``cat_member`` [M-1, B'] bool, each node's
    membership, when there are categorical features; ``group_id`` and
    ``bin_offset`` when the bins are EFB-bundled), on the meta's device."""
    dev = feature_meta["num_bin"].device

    def i64(a):
        return torch.as_tensor(a).to(device=dev, dtype=torch.int64)

    f = i64(split_feature)
    is_cat = feature_meta.get("is_categorical")
    if is_cat is None:
        is_cat_nodes = torch.zeros(f.shape, dtype=torch.bool, device=dev)
        cat_member = torch.zeros(f.shape + (1,), dtype=torch.bool, device=dev)
    else:
        is_cat_nodes = torch.as_tensor(is_cat).to(device=dev, dtype=torch.bool)[f]
        cat_member = torch.as_tensor(cat_member).to(device=dev, dtype=torch.bool)
    efb = "group_id" in feature_meta
    column, bin_offset = (i64(feature_meta["group_id"])[f], i64(feature_meta["bin_offset"])[f]) \
        if efb else (f, torch.zeros_like(f))
    return PredictTree(
        split_feature=f, threshold_bin=i64(threshold_bin),
        default_left=torch.as_tensor(default_left).to(device=dev, dtype=torch.bool),
        left_child=i64(left_child), right_child=i64(right_child),
        leaf_value=leaf_value.to(device=dev, dtype=torch.float32),
        missing_type=i64(feature_meta["missing_type"])[f],
        default_bin=i64(feature_meta["default_bin"])[f],
        nan_bin=i64(feature_meta["num_bin"])[f] - 1,
        num_leaves=int(num_leaves),
        is_cat=is_cat_nodes,
        cat_member=cat_member,
        column=column,
        bin_offset=bin_offset,
        efb=efb,
    )


def make_predict_tree(tree, feature_meta: Dict[str, torch.Tensor]) -> PredictTree:
    """Bundle ops/grow.py TreeArrays with the per-node feature meta
    (lightgbm_tpu/ops/predict.py ``make_predict_tree``)."""
    return predict_tree(tree.split_feature, tree.threshold_bin, tree.default_left,
                        tree.left_child, tree.right_child, tree.leaf_value,
                        int(tree.num_leaves), feature_meta, tree.cat_member)


def tree_predict_leaf(bins: torch.Tensor, tree: PredictTree) -> torch.Tensor:
    """Leaf index [N] int64 of every row of the ``[N, F]`` bin matrix
    ``bins`` (uint8, or int16 past 256 bins a feature; ``[N, G]`` uint8
    bundled): all rows advance one level a step until each is at a leaf."""
    N = bins.shape[0]
    node = torch.zeros(N, dtype=torch.int64, device=bins.device)
    if tree.num_leaves <= 1:
        return node
    rows = torch.arange(N, device=bins.device)
    active = torch.ones(N, dtype=torch.bool, device=bins.device)
    while bool(active.any()):
        nd = node[active]
        col = bins[rows[active], tree.column[nd]].to(torch.int64)
        if tree.efb:  # the group byte as the node feature's sub-bin (efb.py decode_subbin)
            r = col - tree.bin_offset[nd]
            col = torch.where((r >= 0) & (r < tree.nan_bin[nd]),
                              r + (r >= tree.default_bin[nd]).long(), tree.default_bin[nd])
        go_left = col <= tree.threshold_bin[nd]
        dl = tree.default_left[nd]
        miss = tree.missing_type[nd]
        go_left = torch.where((miss == MISSING_ZERO) & (col == tree.default_bin[nd]), dl, go_left)
        go_left = torch.where((miss == MISSING_NAN) & (col == tree.nan_bin[nd]), dl, go_left)
        go_left = torch.where(tree.is_cat[nd],
                              tree.cat_member[nd, col.clamp(max=tree.cat_member.shape[1] - 1)],
                              go_left)
        node[active] = torch.where(go_left, tree.left_child[nd], tree.right_child[nd])
        active = node >= 0
    return -(node + 1)


def tree_predict_value(bins: torch.Tensor, tree: PredictTree) -> torch.Tensor:
    """Each row's leaf value [N] f32."""
    return tree.leaf_value[tree_predict_leaf(bins, tree)]


def add_tree_value(
    bins: torch.Tensor,  # [N, F] uint8 or int16
    node_i: torch.Tensor,  # [>= M-1, 5] int32: feature, threshold, left, right, default_left
    num_leaves: torch.Tensor,  # [1] int32: the tree's leaves
    feature_meta: Dict[str, torch.Tensor],
    value: torch.Tensor,  # [M] f32: what a row at each leaf adds
    score: torch.Tensor,  # [N] f32, updated in place
    leaf_out=None,  # optional [N] int32: each row's leaf
    node_b=None,  # [>= M-1, W] int32: each node's membership words (categorical features)
) -> None:
    """``score[r] += value[leaf(r)]`` for every row r of ``bins``, one f32
    add a row; the plain version of csrc/predict_bins.cu, which reads the
    tree the same way from a split loop's ``node_i``, ``node_b`` and
    ``ctl``."""
    nl = int(num_leaves.reshape(-1)[0])
    m = max(nl - 1, 0)
    nodes = node_i[:m].to(torch.int64)
    member = None
    if "is_categorical" in feature_meta:
        member = words_member(node_b[:m], 32 * node_b.shape[1])
    tree = predict_tree(nodes[:, 0], nodes[:, 1], nodes[:, 4] != 0, nodes[:, 2], nodes[:, 3],
                        value, nl, feature_meta, member)
    leaf = tree_predict_leaf(bins, tree)
    score += value[leaf]
    if leaf_out is not None:
        leaf_out.copy_(leaf)


# ---------------------------------------------------------------------------
# Packed-ensemble inference (serve/)
# ---------------------------------------------------------------------------


class PackedTrees(NamedTuple):
    """Dense rank-space ensemble: node fields [T, M], leaves [T, L]
    (lightgbm_tpu/ops/predict.py:175, the same fields and dtypes).

    ``M = max(num_leaves) - 1`` split slots (min 1); padded slots are inert
    (left = right = -1). ``cat_words`` is one flat uint32 bitset pool shared
    by every categorical node, which addresses it with (cat_off, cat_n);
    ``cat_n == 0`` on a categorical node marks the legacy single-category
    equality decision with the raw category value in ``thr_rank``. The
    per-feature rank0/zero_lo/zero_hi encode NaN -> 0.0 and the
    kZeroThreshold window in rank space.
    """

    feature: torch.Tensor  # [T, M] int32 split feature (original column)
    thr_rank: torch.Tensor  # [T, M] int32 threshold rank (or legacy cat value)
    default_left: torch.Tensor  # [T, M] bool
    missing_type: torch.Tensor  # [T, M] int32
    left_child: torch.Tensor  # [T, M] int32 (negative = -(leaf+1))
    right_child: torch.Tensor  # [T, M] int32
    is_cat: torch.Tensor  # [T, M] bool
    cat_off: torch.Tensor  # [T, M] int32 word offset into cat_words
    cat_n: torch.Tensor  # [T, M] int32 word count (0 = legacy equality)
    leaf_value: torch.Tensor  # [T, L] f32
    num_leaves: torch.Tensor  # [T] int32
    cat_words: torch.Tensor  # [W] uint32 flat bitset pool (W >= 1)
    rank0: torch.Tensor  # [F] int32 rank of 0.0 per feature
    zero_lo: torch.Tensor  # [F] int32 rank of -kZeroThreshold
    zero_hi: torch.Tensor  # [F] int32 rank of +kZeroThreshold


def packed_predict_leaves(codes: torch.Tensor, isnan: torch.Tensor,
                          packed: PackedTrees) -> torch.Tensor:
    """[T, N] int32 leaf indices of every row in every tree, all trees and
    rows advancing one level a step. ``codes``: [N, F] int32, the threshold
    rank of a numerical feature and the truncated category of a categorical
    one; ``isnan``: [N, F] bool. Each decision is lightgbm_tpu/ops/predict.py
    ``_packed_tree_leaf``'s (:204-254)."""
    T, M = packed.feature.shape
    N = codes.shape[0]
    dev = codes.device

    def node_field(name):
        return getattr(packed, name).to(torch.int64)

    feature, thr = node_field("feature"), node_field("thr_rank")
    miss, left, right = node_field("missing_type"), node_field("left_child"), node_field("right_child")
    cat_off, cat_n = node_field("cat_off"), node_field("cat_n")
    dl, is_cat = packed.default_left, packed.is_cat
    words = packed.cat_words.to(torch.int64)
    rank0, zero_lo, zero_hi = (getattr(packed, k).to(torch.int64) for k in ("rank0", "zero_lo", "zero_hi"))
    codes_t = codes.t().to(torch.int64)  # [F, N]
    nan_t = isnan.t()
    stump = (packed.num_leaves.to(torch.int64) <= 1)[:, None]
    node = torch.where(stump, -1, 0).expand(T, N).contiguous() if T else \
        torch.zeros((0, N), dtype=torch.int64, device=dev)
    while bool((node >= 0).any()):
        active = node >= 0
        nsafe = node.clamp(min=0)
        f = feature.gather(1, nsafe)
        c = codes_t.gather(0, f)
        nan = nan_t.gather(0, f)
        m = miss.gather(1, nsafe)
        # numerical: NaN -> 0.0 (rank0) unless missing==NaN, then the
        # kZeroThreshold window / NaN default routing, else the rank compare
        eff = torch.where(nan & (m != MISSING_NAN), rank0[f], c)
        in_band = (eff > zero_lo[f]) & (eff <= zero_hi[f])
        use_default = ((m == MISSING_ZERO) & in_band) | ((m == MISSING_NAN) & nan)
        num_left = torch.where(use_default, dl.gather(1, nsafe), eff <= thr.gather(1, nsafe))
        # categorical bitset membership (FindInBitset, common.h:943)
        iv = torch.where(nan, torch.zeros_like(c), c)
        w = iv >> 5
        nw = cat_n.gather(1, nsafe)
        in_range = (iv >= 0) & (w < nw)
        widx = cat_off.gather(1, nsafe) + torch.minimum(w.clamp(min=0), (nw - 1).clamp(min=0))
        word = words[widx.clamp(0, words.numel() - 1)]
        bit = (word >> (iv & 31)) & 1
        cat_left = in_range & (bit > 0) & ~(nan & (m == MISSING_NAN))
        # legacy single-category equality (cat_n == 0): int(fval) == value
        node_cat = is_cat.gather(1, nsafe)
        cat_left = torch.where(node_cat & (nw == 0), ~nan & (c == thr.gather(1, nsafe)), cat_left)
        go_left = torch.where(node_cat, cat_left, num_left)
        nxt = torch.where(go_left, left.gather(1, nsafe), right.gather(1, nsafe))
        node = torch.where(active, nxt, node)
    return (-(node + 1)).to(torch.int32)


def packed_predict_values(codes: torch.Tensor, isnan: torch.Tensor, packed: PackedTrees,
                          num_class: int = 1, average_output: bool = False) -> torch.Tensor:
    """[K, N] f32 raw scores: tree i's leaf value added into class i % K,
    one f32 add a tree in tree order (gbdt_prediction.cpp:13 ordering);
    ``average_output`` divides by the iterations, max(T // K, 1)."""
    leaves = packed_predict_leaves(codes, isnan, packed).to(torch.int64)  # [T, N]
    vals = packed.leaf_value.gather(1, leaves)  # [T, N] f32
    T = vals.shape[0]
    K = max(int(num_class), 1)
    out = torch.zeros((K, codes.shape[0]), dtype=torch.float32, device=codes.device)
    for i in range(T):
        out[i % K] += vals[i]
    if average_output:
        # an IEEE division by a tensor: a CPU-scalar divisor would let CUDA
        # multiply by its reciprocal, one rounding away from the kernel's quotient
        out = out / torch.full_like(out, float(max(T // K, 1)))
    return out


def packed_bin_rows(X: torch.Tensor, bounds: torch.Tensor,
                    is_cat_feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw -> code conversion of the fused serving path: (codes [N, F]
    int32, isnan [N, F] bool) of the f32 rows ``X`` [N, F]. ``bounds``:
    [F, Bmax] f32 per-feature threshold lattice padded with +inf; a
    numerical feature's code is its searchsorted (side="left") rank, a
    categorical feature's (``is_cat_feat``) the truncated integer category.
    f32: rows within one f32 ulp of a threshold may rank differently from
    the f64 host path (serve/packed.py ``_host_codes``)."""
    isnan = torch.isnan(X)
    Xz = torch.where(isnan, torch.zeros_like(X), X)
    ranks = torch.searchsorted(bounds, Xz.t().contiguous(), side="left").t().to(torch.int32)
    cat = torch.trunc(Xz.clamp(-2.0e9, 2.0e9)).to(torch.int32)
    codes = torch.where(is_cat_feat[None, :], cat, ranks).contiguous()
    return codes, isnan
