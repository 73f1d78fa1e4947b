"""Packed tensor ensemble: compile a Booster into device tensors for serving.

The port's copy of lightgbm_tpu/serve/packed.py. ``Booster.predict`` walks
the trees one at a time in f64; for serving, the whole ensemble is packed
once into dense ``[T, max_nodes]`` tensors on the serving device and every
request becomes one launch over all T trees (ops/packed_kernel.py
``packed_predict_leaves``, csrc/packed_predict.cu), the dense-forest layout
GPU forest inference uses (RAPIDS FIL).

Exactness. Device floats are f32; thresholds are f64, so comparing raw
values on the card would drift near thresholds. Instead every numerical
feature gets a *threshold lattice*: the sorted unique f64 thresholds the
model splits that feature on, plus the +/-kZeroThreshold sentinels that
bound LightGBM's missing-zero window. Rows convert raw -> rank with f64
host searchsorted (``_host_codes``), and each node decision becomes the
integer compare ``rank(x) <= rank(thr)``, exactly ``x <= thr`` because the
lattice holds ``thr`` itself. Leaf indices therefore match
``Booster.predict(pred_leaf=True)`` bit for bit; the f64 per-class tree sum
runs on the host in tree order, as GBDT.predict_raw sums, so raw scores and
converted outputs are bit-exact too (tests/test_torch_serve_packed.py).

The fused path (``fused_scores``) trades that guarantee for throughput: the
raw->rank conversion (``packed_bin_rows``) and one kernel that walks every
tree and sums each class's f32 leaf values in tree order
(``packed_predict_values``) run on the card. Rows within one f32 ulp of a
threshold may bin differently, and the sum is f32; it is held to the exact
path within 2·T·2^-24·Σ|v| a row.

No part of this path gives way to the CPU or to a plain version: on a CUDA
device a kernel that fails to build or launch raises.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..basic import resolve_device
from ..models.model_text import model_fingerprint, save_model_to_string
from ..models.tree import K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK, K_ZERO_THRESHOLD
from ..ops import packed_kernel
from ..ops.predict import PackedTrees
from ..utils.log import LightGBMError

_INT32_MAX = 2**31 - 1


def _decode_nodes(tree):
    """(missing_type, default_left, is_cat) int/bool arrays for one tree."""
    dt = np.asarray(tree.decision_type).astype(np.int32)
    return (dt >> 2) & 3, (dt & K_DEFAULT_LEFT_MASK) > 0, (dt & K_CATEGORICAL_MASK) > 0


def packed_trees_to(arrays, device) -> PackedTrees:
    """A :class:`PackedTrees` on ``device`` from its fields as numpy arrays
    (a mapping or a NamedTuple of them), each cast to the field's dtype."""
    get = arrays.get if hasattr(arrays, "get") else (lambda k: getattr(arrays, k))
    out = {}
    for name, (dtype, _rank) in packed_kernel.FIELDS.items():
        a = np.array(get(name), copy=True, order="C")
        out[name] = torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()
    return PackedTrees(**out)


class PackedEnsemble:
    """A Booster compiled for device-resident batch inference.

    Build with :func:`pack_booster` / ``Booster.to_packed()``. The object owns
    the device ``PackedTrees`` on ``device`` (default ``cuda``), the host f64
    lattices and leaf values for the exact path, and the model metadata
    (objective, class count, average_output) that reproduces
    ``Booster.predict`` end to end.
    """

    def __init__(
        self,
        packed: PackedTrees,
        feat_bounds: List[np.ndarray],
        is_cat_feat: np.ndarray,
        leaf_value64: np.ndarray,
        num_class: int,
        num_tree_per_iteration: int,
        average_output: bool,
        objective,
        fingerprint: str,
        feature_names: Optional[List[str]] = None,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.packed = packed
        self.feat_bounds = feat_bounds
        self.is_cat_feat = is_cat_feat
        self.leaf_value64 = leaf_value64
        self.num_class = num_class
        self.num_tree_per_iteration = num_tree_per_iteration
        self.average_output = average_output
        self.objective = objective
        self.fingerprint = fingerprint
        self.feature_names = feature_names or []
        self.num_features = len(feat_bounds)
        self.num_trees = int(leaf_value64.shape[0])
        # fused-path device constants (built once, reused every dispatch)
        bmax = max(max((len(b) for b in feat_bounds), default=1), 1)
        bounds = np.full((self.num_features, bmax), np.inf, np.float32)
        with np.errstate(over="ignore"):  # a threshold past f32's range is +/-inf there
            for f, b in enumerate(feat_bounds):
                bounds[f, : len(b)] = b.astype(np.float32)
        self.bounds_dev = torch.as_tensor(bounds, device=self.device)
        self.is_cat_dev = torch.as_tensor(np.asarray(is_cat_feat, bool), device=self.device)

    # -- host raw -> code conversion (f64-exact) --------------------------

    def _host_codes(self, X: np.ndarray):
        """[N, F] int32 codes + [N, F] bool NaN mask, f64 semantics."""
        isnan = np.isnan(X)
        codes = np.empty(X.shape, np.int32)
        for f in range(self.num_features):
            col = np.where(isnan[:, f], 0.0, X[:, f])
            if self.is_cat_feat[f]:
                iv = np.trunc(col)
                codes[:, f] = np.clip(iv, -(2.0**31), float(_INT32_MAX)).astype(np.int32)
            else:
                codes[:, f] = np.searchsorted(self.feat_bounds[f], col, side="left").astype(np.int32)
        return codes, isnan

    def _check_width(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float64)
        if X.ndim != 2:
            raise LightGBMError("Input numpy.ndarray must be 2 dimensional")
        if X.shape[1] != self.num_features:
            raise LightGBMError(
                "The number of features in data (%d) is not the same as it "
                "was in training data (%d)" % (X.shape[1], self.num_features)
            )
        return X

    # -- exact path (bit-identical to Booster.predict) --------------------

    def leaves_dev(self, codes: np.ndarray, isnan: np.ndarray) -> np.ndarray:
        """[T, N] int32 leaves of host codes, through the traversal kernel
        on the serving device (the plain version on the CPU)."""
        codes_dev = torch.as_tensor(codes, device=self.device)
        isnan_dev = torch.as_tensor(isnan, device=self.device)
        leaves = packed_kernel.packed_predict_leaves(codes_dev, isnan_dev, self.packed)
        return leaves.cpu().numpy()

    def predict_leaves(self, X: np.ndarray) -> np.ndarray:
        """[N, T] int32 leaf indices (== Booster.predict(pred_leaf=True))."""
        X = self._check_width(X)
        codes, isnan = self._host_codes(X)
        return self.leaves_dev(codes, isnan).T.astype(np.int32)

    def predict_raw(self, X: np.ndarray) -> np.ndarray:
        """Raw scores [N] / [N, K], f64-exact against GBDT.predict_raw."""
        return self._finalize_raw(self.predict_leaves(X))

    def _finalize_raw(self, leaves: np.ndarray) -> np.ndarray:
        N = leaves.shape[0]
        K = self.num_tree_per_iteration
        out = np.zeros((K, N), np.float64)
        # GBDT.predict_raw's order: tree i into class i % K, increasing i —
        # f64 addition is order-sensitive and the bit-exact contract
        # includes the sum
        for i in range(self.num_trees):
            out[i % K] += self.leaf_value64[i][leaves[:, i]]
        if self.average_output and self.num_trees > 0:
            out /= max(self.num_trees // K, 1)
        return out[0] if K == 1 else out.T

    def predict(self, X: np.ndarray, raw_score: bool = False, pred_leaf: bool = False) -> np.ndarray:
        """Bit-exact counterpart of ``Booster.predict`` (no contrib/early-stop)."""
        if pred_leaf:
            return self.predict_leaves(X)
        raw = self.predict_raw(X)
        if raw_score or self.objective is None:
            return raw
        return self.objective.convert_output(raw)

    # -- fused path (all on the device, f32) -------------------------------

    def fused_scores(self, X_dev: torch.Tensor) -> torch.Tensor:
        """[K, N] f32 scores from f32 raw rows on the serving device: the
        bin kernel, then the fused traversal-and-sum kernel. Device in,
        device out; callers slice and convert."""
        codes, isnan = packed_kernel.packed_bin_rows(X_dev, self.bounds_dev, self.is_cat_dev)
        return packed_kernel.packed_predict_values(
            codes, isnan, self.packed, num_class=self.num_tree_per_iteration,
            average_output=self.average_output,
        )

    def finalize_fused(self, out, raw_score: bool = False) -> np.ndarray:
        """[K, N] f32 device scores -> the ``predict`` output convention
        (class reshaping + objective transform). Shared by ``predict_fused``
        and the server's batched fused path so they cannot drift."""
        if isinstance(out, torch.Tensor):
            out = out.cpu().numpy()
        out = np.asarray(out).astype(np.float64)
        raw = out[0] if self.num_tree_per_iteration == 1 else out.T
        if raw_score or self.objective is None:
            return raw
        return self.objective.convert_output(raw)

    def predict_fused(self, X: np.ndarray, raw_score: bool = False) -> np.ndarray:
        """Fast-path prediction: f32 end to end on the device. Approximately
        (not bit-) equal to ``predict``; see the module docstring."""
        X = self._check_width(X)
        X_dev = torch.as_tensor(X.astype(np.float32), device=self.device)
        return self.finalize_fused(self.fused_scores(X_dev), raw_score)


def model_lattice(trees, num_features: int):
    """(feat_bounds, is_cat_feat) — the per-feature f64 threshold lattice of
    a tree list: sorted unique split thresholds plus the +/-kZeroThreshold
    sentinels bounding LightGBM's missing-zero window."""
    thr_lists: List[List[float]] = [[] for _ in range(num_features)]
    is_cat_feat = np.zeros(num_features, bool)
    is_num_feat = np.zeros(num_features, bool)
    for t in trees:
        _miss, _dl, cat = _decode_nodes(t)
        for n in range(max(t.num_leaves - 1, 0)):
            f = int(t.split_feature[n])
            if cat[n]:
                is_cat_feat[f] = True
            else:
                is_num_feat[f] = True
                thr_lists[f].append(float(t.threshold[n]))
    both = is_cat_feat & is_num_feat
    if both.any():
        raise LightGBMError(
            "Feature %d is split both numerically and categorically; "
            "cannot build a rank lattice" % int(np.nonzero(both)[0][0])
        )
    feat_bounds = []
    for f in range(num_features):
        vals = thr_lists[f] + [-K_ZERO_THRESHOLD, K_ZERO_THRESHOLD]
        feat_bounds.append(np.unique(np.asarray(vals, np.float64)))
    return feat_bounds, is_cat_feat


def pack_arrays(trees, feat_bounds):
    """The numpy fields of the ensemble's :class:`PackedTrees` (a dict) and
    its f64 leaf values [T, L]."""
    rank0 = np.asarray([np.searchsorted(b, 0.0, side="left") for b in feat_bounds], np.int32)
    zero_lo = np.asarray([np.searchsorted(b, -K_ZERO_THRESHOLD, side="left") for b in feat_bounds],
                         np.int32)
    zero_hi = np.asarray([np.searchsorted(b, K_ZERO_THRESHOLD, side="left") for b in feat_bounds],
                         np.int32)
    T = len(trees)
    M = max(max(t.num_leaves - 1 for t in trees), 1)
    L = max(t.num_leaves for t in trees)
    feature = np.zeros((T, M), np.int32)
    thr_rank = np.zeros((T, M), np.int32)
    default_left = np.zeros((T, M), bool)
    missing_type = np.zeros((T, M), np.int32)
    left = np.full((T, M), -1, np.int32)
    right = np.full((T, M), -1, np.int32)
    is_cat_node = np.zeros((T, M), bool)
    cat_off = np.zeros((T, M), np.int32)
    cat_n = np.zeros((T, M), np.int32)
    leaf32 = np.zeros((T, L), np.float32)
    leaf64 = np.zeros((T, L), np.float64)
    num_leaves = np.zeros(T, np.int32)
    cat_words: List[np.ndarray] = []
    n_cat_words = 0
    for ti, t in enumerate(trees):
        n = t.num_leaves
        num_leaves[ti] = n
        leaf64[ti, :n] = t.leaf_value[:n]
        leaf32[ti, :n] = np.asarray(t.leaf_value[:n]).astype(np.float32)
        m = max(n - 1, 0)
        if m == 0:
            continue
        miss, dl, cat = _decode_nodes(t)
        feature[ti, :m] = t.split_feature[:m]
        default_left[ti, :m] = dl[:m]
        missing_type[ti, :m] = miss[:m]
        left[ti, :m] = t.left_child[:m]
        right[ti, :m] = t.right_child[:m]
        is_cat_node[ti, :m] = cat[:m]
        for ni in range(m):
            thr = float(t.threshold[ni])
            if not cat[ni]:
                thr_rank[ti, ni] = np.searchsorted(
                    feat_bounds[int(t.split_feature[ni])], thr, side="left")
            elif t.num_cat > 0:
                ci = int(thr)
                lo, hi = int(t.cat_boundaries[ci]), int(t.cat_boundaries[ci + 1])
                words = np.asarray(t.cat_threshold[lo:hi], np.uint32)
                cat_off[ti, ni] = n_cat_words
                cat_n[ti, ni] = len(words)
                cat_words.append(words)
                n_cat_words += len(words)
            else:
                # legacy single-category equality node: cat_n stays 0 (the
                # kernel's legacy marker), the value rides in thr_rank
                thr_rank[ti, ni] = int(np.clip(thr, -(2.0**31), float(_INT32_MAX)))
    pool = np.concatenate(cat_words).astype(np.uint32) if cat_words else np.zeros(1, np.uint32)
    fields = dict(
        feature=feature, thr_rank=thr_rank, default_left=default_left, missing_type=missing_type,
        left_child=left, right_child=right, is_cat=is_cat_node, cat_off=cat_off, cat_n=cat_n,
        leaf_value=leaf32, num_leaves=num_leaves, cat_words=pool, rank0=rank0, zero_lo=zero_lo,
        zero_hi=zero_hi,
    )
    return fields, leaf64


def pack_booster(booster, num_iteration: int = -1, device=None) -> PackedEnsemble:
    """Compile ``booster`` (trained in-process or loaded from model text)
    into a :class:`PackedEnsemble` on ``device`` (default: the booster's).
    ``num_iteration`` clips the ensemble the way ``Booster.predict`` does."""
    gbdt = booster._gbdt
    trees = gbdt.trees()
    K = max(gbdt.num_tree_per_iteration, 1)
    use = len(trees)
    if num_iteration is not None and num_iteration > 0:
        use = min(use, num_iteration * K)
    trees = trees[:use]
    if not trees:
        raise LightGBMError("Cannot pack a model with no trees")
    dev = resolve_device(device) if device is not None else booster.device
    feat_bounds, is_cat_feat = model_lattice(trees, gbdt.max_feature_idx + 1)
    fields, leaf64 = pack_arrays(trees, feat_bounds)
    # hash the bare model text (no pandas_categorical trailer) over exactly
    # the packed iteration range, as the JAX package's PackedEnsemble does
    fingerprint = model_fingerprint(save_model_to_string(gbdt, 0, num_iteration))
    return PackedEnsemble(
        packed=packed_trees_to(fields, dev),
        feat_bounds=feat_bounds,
        is_cat_feat=is_cat_feat,
        leaf_value64=leaf64,
        num_class=gbdt.num_class,
        num_tree_per_iteration=K,
        average_output=bool(getattr(gbdt, "average_output", False)),
        objective=gbdt.objective,
        fingerprint=fingerprint,
        feature_names=booster.feature_name(),
        device=dev,
    )
