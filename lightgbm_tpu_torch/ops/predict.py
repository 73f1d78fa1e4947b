"""Ensemble raw-score prediction in plain PyTorch.

Counterpart of the JAX package's raw-feature prediction
(lightgbm_tpu/models/gbdt.py ``predict_raw`` over models/tree.py
``predict_leaf_fast``): every row advances one tree level per step, with
NumericalDecision semantics (tree.h:216-255) in double precision, and the
trees' values are summed in f64 in boosting order. Numerical splits only;
a categorical node raises.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..binning import MISSING_NAN, MISSING_ZERO
from ..models.tree import K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK, K_ZERO_THRESHOLD, Tree


def tree_predict_leaf(X: torch.Tensor, tree: Tree) -> torch.Tensor:
    """Leaf index per row of the f64 ``[N, F]`` raw feature matrix ``X``."""
    n = X.shape[0]
    dev = X.device
    if tree.num_leaves <= 1:
        return torch.zeros(n, dtype=torch.int64, device=dev)
    if tree.num_cat > 0 or (tree.decision_type & K_CATEGORICAL_MASK).any():
        raise NotImplementedError("categorical splits are not ported yet")

    def arr(a, dtype):
        return torch.as_tensor(a, device=dev).to(dtype)

    feat = arr(tree.split_feature, torch.int64)
    thr = arr(tree.threshold, torch.float64)
    dt = arr(tree.decision_type, torch.int32)
    miss = (dt >> 2) & 3
    dl = (dt & K_DEFAULT_LEFT_MASK) > 0
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
        nxt = torch.where(go_left, left[nd], right[nd])
        node = torch.where(active, nxt, node)
    return -(node + 1)


def ensemble_predict_raw(X: torch.Tensor, trees: Sequence[Tree]) -> torch.Tensor:
    """[N] f64 sum of the trees' values, accumulated tree by tree."""
    out = torch.zeros(X.shape[0], dtype=torch.float64, device=X.device)
    for t in trees:
        values = torch.as_tensor(t.leaf_value, dtype=torch.float64, device=X.device)
        out += values[tree_predict_leaf(X, t)]
    return out
