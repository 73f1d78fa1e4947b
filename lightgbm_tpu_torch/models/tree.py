"""Host-side flat-array decision tree; the PyTorch port's copy of
lightgbm_tpu/models/tree.py.

Counterpart of the reference Tree
(LightGBM include/LightGBM/tree.h:58-522, src/io/tree.cpp). The device
grower (ops/grow.py) emits bin-space TreeArrays; this class owns the *model*
representation: real-valued thresholds (RealThreshold = BinToValue + AvoidInf,
dataset.h:504, common.h:665), LightGBM's decision_type bit encoding, the versioned
text serialization (Tree::ToString, tree.cpp:206), and double-precision numpy
prediction with NumericalDecision semantics (tree.h:216-255).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from ..binning import MISSING_NAN, MISSING_NONE, MISSING_ZERO

K_CATEGORICAL_MASK = 1
K_DEFAULT_LEFT_MASK = 2
K_ZERO_THRESHOLD = 1e-35


def _avoid_inf(x: float) -> float:
    if x >= 1e300:
        return 1e300
    if x <= -1e300:
        return -1e300
    if math.isnan(x):
        return 0.0
    return x


def _short_float(v: float, precision: int = 20) -> str:
    s = "%.*g" % (precision, float(v))
    return s


class Tree:
    """A trained decision tree (numerical + one-hot categorical splits)."""

    def __init__(self, num_leaves: int) -> None:
        n = max(num_leaves, 1)
        self.num_leaves = n
        self.split_feature: np.ndarray = np.zeros(max(n - 1, 0), dtype=np.int32)
        self.threshold_bin: np.ndarray = np.zeros(max(n - 1, 0), dtype=np.int32)
        self.threshold: np.ndarray = np.zeros(max(n - 1, 0), dtype=np.float64)
        self.decision_type: np.ndarray = np.zeros(max(n - 1, 0), dtype=np.int8)
        self.left_child: np.ndarray = np.zeros(max(n - 1, 0), dtype=np.int32)
        self.right_child: np.ndarray = np.zeros(max(n - 1, 0), dtype=np.int32)
        self.split_gain: np.ndarray = np.zeros(max(n - 1, 0), dtype=np.float32)
        self.internal_value: np.ndarray = np.zeros(max(n - 1, 0), dtype=np.float64)
        self.internal_count: np.ndarray = np.zeros(max(n - 1, 0), dtype=np.int64)
        self.leaf_value: np.ndarray = np.zeros(n, dtype=np.float64)
        self.leaf_count: np.ndarray = np.zeros(n, dtype=np.int64)
        self.shrinkage: float = 1.0
        # categorical bitset storage (tree.h:372-376): for a categorical node,
        # threshold_ holds cat_idx; cat_threshold[cat_boundaries[cat_idx] :
        # cat_boundaries[cat_idx+1]] is a uint32 bitset over raw category VALUES
        self.num_cat: int = 0
        self.cat_boundaries: np.ndarray = np.zeros(1, dtype=np.int32)
        self.cat_threshold: np.ndarray = np.zeros(0, dtype=np.uint32)

    # -- construction from device output ---------------------------------

    @classmethod
    def from_device(cls, tree_arrays, dataset) -> "Tree":
        """Convert bin-space TreeArrays (ops/grow.py) into a model Tree."""
        n = int(tree_arrays.num_leaves)
        t = cls(n)
        if n <= 1:
            t.leaf_value[0] = float(np.asarray(tree_arrays.leaf_value)[0]) if n == 1 else 0.0
            t.leaf_count[0] = int(np.asarray(tree_arrays.leaf_count)[0]) if n == 1 else 0
            return t
        m = n - 1
        sf_used = np.asarray(tree_arrays.split_feature)[:m].astype(np.int32)
        t.threshold_bin = np.asarray(tree_arrays.threshold_bin)[:m].astype(np.int32)
        dl = np.asarray(tree_arrays.default_left)[:m].astype(bool)
        t.left_child = np.asarray(tree_arrays.left_child)[:m].astype(np.int32)
        t.right_child = np.asarray(tree_arrays.right_child)[:m].astype(np.int32)
        t.split_gain = np.asarray(tree_arrays.split_gain)[:m].astype(np.float32)
        t.internal_value = np.asarray(tree_arrays.internal_value)[:m].astype(np.float64)
        t.internal_count = np.rint(np.asarray(tree_arrays.internal_count)[:m]).astype(np.int64)
        t.leaf_value = np.asarray(tree_arrays.leaf_value)[:n].astype(np.float64)
        t.leaf_count = np.rint(np.asarray(tree_arrays.leaf_count)[:n]).astype(np.int64)

        # child encodings: device uses -(leaf+1); LightGBM text uses ~leaf == -(leaf+1). Same.
        t.split_feature = np.array(
            [dataset.used_feature_idx[f] for f in sf_used], dtype=np.int32
        )
        t.threshold = np.zeros(m, dtype=np.float64)
        t.decision_type = np.zeros(m, dtype=np.int8)
        cat_member = (
            np.asarray(tree_arrays.cat_member)[:m]
            if hasattr(tree_arrays, "cat_member")
            else None
        )
        boundaries = [0]
        cat_words: List[np.ndarray] = []
        for i in range(m):
            mapper = dataset.mappers[sf_used[i]]
            dt = 0
            if mapper.bin_type == 1:
                # categorical bitset node (Tree::SplitCategorical, tree.cpp:69-93):
                # threshold = cat_idx; member bins -> raw category values -> bitset
                dt |= K_CATEGORICAL_MASK
                member_bins = (
                    np.nonzero(cat_member[i])[0]
                    if cat_member is not None
                    else [int(t.threshold_bin[i])]
                )
                vals = sorted(
                    int(mapper.bin_2_categorical[b])
                    for b in member_bins
                    if b < len(mapper.bin_2_categorical)
                    and mapper.bin_2_categorical[b] >= 0
                )
                words = np.zeros((vals[-1] // 32 + 1) if vals else 1, np.uint32)
                for v in vals:
                    words[v // 32] |= np.uint32(1) << np.uint32(v % 32)
                t.threshold[i] = float(t.num_cat)
                t.threshold_bin[i] = t.num_cat  # tree.cpp:83 threshold_in_bin_=num_cat_
                boundaries.append(boundaries[-1] + len(words))
                cat_words.append(words)
                t.num_cat += 1
            else:
                t.threshold[i] = _avoid_inf(mapper.bin_to_value(int(t.threshold_bin[i])))
            if dl[i]:
                dt |= K_DEFAULT_LEFT_MASK
            dt |= (mapper.missing_type & 3) << 2
            t.decision_type[i] = dt
        if t.num_cat > 0:
            t.cat_boundaries = np.asarray(boundaries, np.int32)
            t.cat_threshold = np.concatenate(cat_words).astype(np.uint32)
        return t

    # -- decision helpers -------------------------------------------------

    def _default_left(self, node: int) -> bool:
        return bool(self.decision_type[node] & K_DEFAULT_LEFT_MASK)

    def _missing_type(self, node: int) -> int:
        return (int(self.decision_type[node]) >> 2) & 3

    def _is_categorical(self, node: int) -> bool:
        return bool(self.decision_type[node] & K_CATEGORICAL_MASK)

    # -- prediction (double precision, NumericalDecision tree.h:216) ------

    def predict(self, X: np.ndarray) -> np.ndarray:
        leaf = self.predict_leaf(X)
        return self.leaf_value[leaf]

    def predict_leaf(self, X: np.ndarray) -> np.ndarray:
        n = X.shape[0]
        if self.num_leaves <= 1:
            return np.zeros(n, dtype=np.int32)
        node = np.zeros(n, dtype=np.int32)
        out = np.full(n, -1, dtype=np.int32)
        active = np.ones(n, dtype=bool)
        while active.any():
            idx = np.nonzero(active)[0]
            nd = node[idx]
            fv = X[idx, self.split_feature[nd]].astype(np.float64)
            go_left = np.zeros(len(idx), dtype=bool)
            for k in range(len(idx)):
                go_left[k] = self._decide(int(nd[k]), float(fv[k]))
            nxt = np.where(go_left, self.left_child[nd], self.right_child[nd])
            is_leaf = nxt < 0
            out[idx[is_leaf]] = -(nxt[is_leaf] + 1)
            node[idx] = nxt
            active[idx] = ~is_leaf
        return out

    def _in_cat_bitset(self, cat_idx: int, iv: int) -> bool:
        """FindInBitset over this node's value-space bitset (common.h:943)."""
        lo = int(self.cat_boundaries[cat_idx])
        hi = int(self.cat_boundaries[cat_idx + 1])
        w = iv >> 5
        if w >= hi - lo:
            return False
        return bool((int(self.cat_threshold[lo + w]) >> (iv & 31)) & 1)

    def _decide(self, node: int, fval: float) -> bool:
        """NumericalDecision / CategoricalDecision (tree.h:216-271)."""
        miss = self._missing_type(node)
        if self._is_categorical(node):
            if self.num_cat > 0:
                if math.isnan(fval):
                    if miss == MISSING_NAN:
                        return False  # NaN is always right (tree.h:261)
                    iv = 0
                else:
                    iv = int(fval)
                    if iv < 0:
                        return False
                return self._in_cat_bitset(int(self.threshold[node]), iv)
            # legacy single-category equality (pre-bitset round-1 model files)
            if math.isnan(fval):
                return False
            return int(fval) == int(self.threshold[node])
        if math.isnan(fval) and miss != MISSING_NAN:
            fval = 0.0
        if (miss == MISSING_ZERO and -K_ZERO_THRESHOLD < fval <= K_ZERO_THRESHOLD) or (
            miss == MISSING_NAN and math.isnan(fval)
        ):
            return self._default_left(node)
        return fval <= self.threshold[node]

    def predict_fast(self, X: np.ndarray) -> np.ndarray:
        """Vectorized double-precision traversal (same semantics as predict)."""
        n = X.shape[0]
        if self.num_leaves <= 1:
            return np.full(n, self.leaf_value[0])
        leaf = self.predict_leaf_fast(X)
        return self.leaf_value[leaf]

    def predict_leaf_fast(self, X: np.ndarray) -> np.ndarray:
        n = X.shape[0]
        if self.num_leaves <= 1:
            return np.zeros(n, dtype=np.int32)
        miss_arr = (self.decision_type.astype(np.int32) >> 2) & 3
        dl_arr = (self.decision_type & K_DEFAULT_LEFT_MASK) > 0
        cat_arr = (self.decision_type & K_CATEGORICAL_MASK) > 0
        node = np.zeros(n, dtype=np.int32)
        active = np.ones(n, dtype=bool)
        while True:
            idx = np.nonzero(active)[0]
            if len(idx) == 0:
                break
            nd = node[idx]
            fv = X[idx, self.split_feature[nd]].astype(np.float64)
            miss = miss_arr[nd]
            thr = self.threshold[nd]
            nanv = np.isnan(fv)
            fv2 = np.where(nanv & (miss != MISSING_NAN), 0.0, fv)
            is_zero = (fv2 > -K_ZERO_THRESHOLD) & (fv2 <= K_ZERO_THRESHOLD)
            use_default = ((miss == MISSING_ZERO) & is_zero) | (
                (miss == MISSING_NAN) & np.isnan(fv2)
            )
            num_left = np.where(use_default, dl_arr[nd], fv2 <= thr)
            # truncation (not floor): matches the scalar path's int(fval), the
            # native kernel's static_cast, and the reference's CategoricalDecision
            if self.num_cat > 0:
                # bitset membership; NaN -> right when missing==NaN, else cat 0
                iv = np.trunc(np.where(nanv, 0.0, fv)).astype(np.int64)
                cat_idx = np.where(cat_arr[nd], thr, 0.0).astype(np.int64)
                lo = self.cat_boundaries[cat_idx].astype(np.int64)
                nwords = self.cat_boundaries[cat_idx + 1].astype(np.int64) - lo
                w = iv >> 5
                in_range = (iv >= 0) & (w < nwords)
                word_idx = np.clip(lo + w, 0, max(len(self.cat_threshold) - 1, 0))
                words = (
                    self.cat_threshold[word_idx].astype(np.int64)
                    if len(self.cat_threshold)
                    else np.zeros(len(idx), np.int64)
                )
                bit = (words >> (iv & 31)) & 1
                cat_left = in_range & (bit > 0) & ~(nanv & (miss == MISSING_NAN))
            else:
                fv_int = np.trunc(np.nan_to_num(fv, nan=-1.0)).astype(np.int64)
                cat_left = (~nanv) & (fv_int == thr.astype(np.int64))
            go_left = np.where(cat_arr[nd], cat_left, num_left)
            nxt = np.where(go_left, self.left_child[nd], self.right_child[nd])
            node[idx] = nxt
            active[idx] = nxt >= 0
        return -(node + 1)

    # -- transforms --------------------------------------------------------

    def apply_shrinkage(self, rate: float) -> None:
        """Tree::Shrinkage (tree.h:148)."""
        self.leaf_value *= rate
        self.internal_value *= rate
        self.shrinkage *= rate

    def set_leaf_values(self, values: np.ndarray) -> None:
        self.leaf_value = np.asarray(values, dtype=np.float64)[: self.num_leaves]

    def feature_importance_counts(self, num_total_features: int) -> np.ndarray:
        out = np.zeros(num_total_features, dtype=np.float64)
        for f in self.split_feature:
            out[f] += 1
        return out

    def feature_importance_gains(self, num_total_features: int) -> np.ndarray:
        out = np.zeros(num_total_features, dtype=np.float64)
        for f, g in zip(self.split_feature, self.split_gain):
            out[f] += float(g)
        return out

    # -- serialization (Tree::ToString, tree.cpp:206) ----------------------

    def to_string(self) -> str:
        lines = []
        lines.append("num_leaves=%d" % self.num_leaves)
        lines.append("num_cat=%d" % self.num_cat)
        n1 = self.num_leaves - 1
        lines.append("split_feature=" + " ".join(str(int(v)) for v in self.split_feature[:n1]))
        lines.append("split_gain=" + " ".join(_short_float(v, 8) for v in self.split_gain[:n1]))
        lines.append("threshold=" + " ".join(_short_float(v) for v in self.threshold[:n1]))
        lines.append("decision_type=" + " ".join(str(int(v)) for v in self.decision_type[:n1]))
        lines.append("left_child=" + " ".join(str(int(v)) for v in self.left_child[:n1]))
        lines.append("right_child=" + " ".join(str(int(v)) for v in self.right_child[:n1]))
        lines.append("leaf_value=" + " ".join(_short_float(v) for v in self.leaf_value[: self.num_leaves]))
        lines.append("leaf_count=" + " ".join(str(int(v)) for v in self.leaf_count[: self.num_leaves]))
        lines.append("internal_value=" + " ".join(_short_float(v, 8) for v in self.internal_value[:n1]))
        lines.append("internal_count=" + " ".join(str(int(v)) for v in self.internal_count[:n1]))
        if self.num_cat > 0:
            # tree.cpp:230-234: bitset words over raw category values
            lines.append(
                "cat_boundaries="
                + " ".join(str(int(v)) for v in self.cat_boundaries[: self.num_cat + 1])
            )
            lines.append(
                "cat_threshold=" + " ".join(str(int(v)) for v in self.cat_threshold)
            )
        lines.append("shrinkage=" + _short_float(self.shrinkage, 8))
        lines.append("")
        return "\n".join(lines) + "\n"

    @classmethod
    def from_string(cls, text: str) -> "Tree":
        kv: Dict[str, str] = {}
        for line in text.strip().splitlines():
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k.strip()] = v.strip()
        n = int(kv["num_leaves"])
        t = cls(n)

        def arr(key, dtype, count):
            if count <= 0 or key not in kv or kv[key] == "":
                return np.zeros(max(count, 0), dtype=dtype)
            vals = kv[key].split()
            return np.asarray([float(x) for x in vals], dtype=np.float64).astype(dtype)

        n1 = n - 1
        t.split_feature = arr("split_feature", np.int32, n1)
        t.split_gain = arr("split_gain", np.float32, n1)
        t.threshold = arr("threshold", np.float64, n1)
        t.decision_type = arr("decision_type", np.int8, n1)
        t.left_child = arr("left_child", np.int32, n1)
        t.right_child = arr("right_child", np.int32, n1)
        t.leaf_value = arr("leaf_value", np.float64, n)
        t.leaf_count = arr("leaf_count", np.int64, n)
        t.internal_value = arr("internal_value", np.float64, n1)
        t.internal_count = arr("internal_count", np.int64, n1)
        t.num_cat = int(kv.get("num_cat", 0))
        if t.num_cat > 0:
            t.cat_boundaries = np.asarray(
                [int(x) for x in kv["cat_boundaries"].split()], np.int32
            )
            t.cat_threshold = np.asarray(
                [int(x) for x in kv["cat_threshold"].split()], np.uint32
            )
        t.shrinkage = float(kv.get("shrinkage", 1.0))
        return t

    def to_json(self) -> dict:
        """Tree::ToJSON (tree.cpp:243) as a python dict."""
        if self.num_leaves == 1:
            structure = {"leaf_value": float(self.leaf_value[0])}
        else:
            structure = self._node_json(0)
        return {
            "num_leaves": int(self.num_leaves),
            "num_cat": int(self.num_cat),
            "shrinkage": self.shrinkage,
            "tree_structure": structure,
        }

    def _node_json(self, index: int) -> dict:
        if index < 0:
            leaf = -(index + 1)
            return {
                "leaf_index": int(leaf),
                "leaf_value": float(self.leaf_value[leaf]),
                "leaf_count": int(self.leaf_count[leaf]),
            }
        miss = ["None", "Zero", "NaN"][self._missing_type(index)]
        if self._is_categorical(index) and self.num_cat > 0:
            # tree.cpp:265-272: the JSON threshold is the "a||b||c" category list
            threshold = "||".join(
                str(v) for v in self.cat_values(int(self.threshold[index]))
            )
        else:
            threshold = float(self.threshold[index])
        return {
            "split_index": int(index),
            "split_feature": int(self.split_feature[index]),
            "split_gain": float(self.split_gain[index]),
            "threshold": threshold,
            "decision_type": "==" if self._is_categorical(index) else "<=",
            "default_left": self._default_left(index),
            "missing_type": miss,
            "internal_value": float(self.internal_value[index]),
            "internal_count": int(self.internal_count[index]),
            "left_child": self._node_json(int(self.left_child[index])),
            "right_child": self._node_json(int(self.right_child[index])),
        }

    def cat_values(self, cat_idx: int) -> List[int]:
        """Decode one categorical node's bitset into its category value list."""
        lo = int(self.cat_boundaries[cat_idx])
        hi = int(self.cat_boundaries[cat_idx + 1])
        out: List[int] = []
        for w in range(lo, hi):
            word = int(self.cat_threshold[w])
            for j in range(32):
                if (word >> j) & 1:
                    out.append((w - lo) * 32 + j)
        return out

    def max_depth(self) -> int:
        if self.num_leaves <= 1:
            return 0

        def depth(node, d):
            if node < 0:
                return d
            return max(depth(int(self.left_child[node]), d + 1), depth(int(self.right_child[node]), d + 1))

        return depth(0, 0)

    def leaf_depths(self) -> np.ndarray:
        """Depth of every leaf (root = 0), iteratively — the model/data
        observability tier's leaf-shape distributions (obs/modelstats.py)
        read this for num_leaves up to the hundreds, where the recursive
        max_depth walk would be fine but a per-leaf recursion would not."""
        out = np.zeros(self.num_leaves, np.int32)
        if self.num_leaves <= 1:
            return out
        stack = [(0, 0)]
        while stack:
            node, d = stack.pop()
            for child in (int(self.left_child[node]), int(self.right_child[node])):
                if child < 0:
                    out[-(child + 1)] = d + 1
                else:
                    stack.append((child, d + 1))
        return out

    # -- SHAP feature contributions (Tree::PredictContrib, tree.h:123,470) -

    def _data_count(self, node: int) -> float:
        if node < 0:
            return float(self.leaf_count[-(node + 1)])
        return float(self.internal_count[node])

    def expected_value(self) -> float:
        """Coverage-weighted mean output (Tree::ExpectedValue, tree.cpp)."""
        if self.num_leaves == 1:
            return float(self.leaf_value[0])
        total = float(self.internal_count[0])
        if total <= 0:
            return 0.0
        return float(np.dot(self.leaf_count[: self.num_leaves], self.leaf_value[: self.num_leaves]) / total)

    def predict_contrib_row(self, x: np.ndarray, phi: np.ndarray) -> None:
        """Add this tree's exact SHAP values for one row into ``phi`` [F+1].

        TreeSHAP (Lundberg et al.) exactly as the reference's Tree::TreeSHAP /
        ExtendPath / UnwindPath / UnwoundPathSum (tree.h:286-470): a decision-path
        walk maintaining, per unique feature on the path, the fraction of training
        rows flowing through when the feature is unknown (zero_fraction) vs. taken
        (one_fraction), with permutation weights (pweight) updated incrementally.
        """
        phi[-1] += self._expected_value_cached()
        if self.num_leaves == 1:
            return
        maxd = self._max_depth_cached() + 2
        # path arrays: feature_index / zero_fraction / one_fraction / pweight
        fidx = np.full(maxd * (maxd + 1) // 2 + maxd, -1, dtype=np.int64)
        zf = np.zeros_like(fidx, dtype=np.float64)
        of = np.zeros_like(zf)
        pw = np.zeros_like(zf)

        def extend(off: int, depth: int, pzf: float, pof: float, pfi: int) -> None:
            fidx[off + depth] = pfi
            zf[off + depth] = pzf
            of[off + depth] = pof
            pw[off + depth] = 1.0 if depth == 0 else 0.0
            for i in range(depth - 1, -1, -1):
                pw[off + i + 1] += pof * pw[off + i] * (i + 1) / (depth + 1)
                pw[off + i] = pzf * pw[off + i] * (depth - i) / (depth + 1)

        def unwind(off: int, depth: int, pi: int) -> None:
            one = of[off + pi]
            zero = zf[off + pi]
            nxt = pw[off + depth]
            for i in range(depth - 1, -1, -1):
                if one != 0.0:
                    tmp = pw[off + i]
                    pw[off + i] = nxt * (depth + 1) / ((i + 1) * one)
                    nxt = tmp - pw[off + i] * zero * (depth - i) / (depth + 1)
                else:
                    pw[off + i] = pw[off + i] * (depth + 1) / (zero * (depth - i))
            for i in range(pi, depth):
                fidx[off + i] = fidx[off + i + 1]
                zf[off + i] = zf[off + i + 1]
                of[off + i] = of[off + i + 1]

        def unwound_sum(off: int, depth: int, pi: int) -> float:
            one = of[off + pi]
            zero = zf[off + pi]
            nxt = pw[off + depth]
            total = 0.0
            for i in range(depth - 1, -1, -1):
                if one != 0.0:
                    tmp = nxt * (depth + 1) / ((i + 1) * one)
                    total += tmp
                    nxt = pw[off + i] - tmp * zero * ((depth - i) / (depth + 1))
                else:
                    total += (pw[off + i] / zero) / ((depth - i) / (depth + 1))
            return total

        def shap(node: int, depth: int, parent_off: int, pzf: float, pof: float, pfi: int) -> None:
            off = parent_off + depth
            fidx[off : off + depth] = fidx[parent_off : parent_off + depth]
            zf[off : off + depth] = zf[parent_off : parent_off + depth]
            of[off : off + depth] = of[parent_off : parent_off + depth]
            pw[off : off + depth] = pw[parent_off : parent_off + depth]
            extend(off, depth, pzf, pof, pfi)
            if node < 0:
                leaf_out = float(self.leaf_value[-(node + 1)])
                for i in range(1, depth + 1):
                    w = unwound_sum(off, depth, i)
                    phi[fidx[off + i]] += w * (of[off + i] - zf[off + i]) * leaf_out
                return
            f = int(self.split_feature[node])
            goes_left = self._decide(node, float(x[f]))
            hot = int(self.left_child[node] if goes_left else self.right_child[node])
            cold = int(self.right_child[node] if goes_left else self.left_child[node])
            w = self._data_count(node)
            hot_zf = (self._data_count(hot) / w) if w > 0 else 0.0
            cold_zf = (self._data_count(cold) / w) if w > 0 else 0.0
            inc_zf = 1.0
            inc_of = 1.0
            d = depth
            # if we have already split on this feature, undo that extension
            pi = 0
            while pi <= d:
                if fidx[off + pi] == f:
                    break
                pi += 1
            if pi != d + 1:
                inc_zf = zf[off + pi]
                inc_of = of[off + pi]
                unwind(off, d, pi)
                d -= 1
            shap(hot, d + 1, off, hot_zf * inc_zf, inc_of, f)
            shap(cold, d + 1, off, cold_zf * inc_zf, 0.0, f)

        shap(0, 0, 0, 1.0, 1.0, -1)

    def _expected_value_cached(self) -> float:
        if not hasattr(self, "_exp_value"):
            self._exp_value = self.expected_value()
        return self._exp_value

    def _max_depth_cached(self) -> int:
        if not hasattr(self, "_max_depth"):
            self._max_depth = self.max_depth()
        return self._max_depth

    def predict_contrib(self, X: np.ndarray, num_features: int) -> np.ndarray:
        """[n, num_features+1] SHAP matrix for this tree (last col = expected)."""
        X = np.asarray(X, np.float64)
        out = np.zeros((X.shape[0], num_features + 1), np.float64)
        for r in range(X.shape[0]):
            self.predict_contrib_row(X[r], out[r])
        return out
