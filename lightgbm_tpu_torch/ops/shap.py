"""Exact TreeSHAP over raw rows in plain PyTorch: the plain version of
csrc/tree_shap.cu (ops/shap_kernel.py) and the path taken for CPU tensors.

Counterpart of lightgbm_tpu/models/tree.py ``predict_contrib_row`` (Tree::
TreeSHAP with ExtendPath, UnwindPath and UnwoundPathSum, tree.h:286-470),
which the JAX package runs in Python row by row. Here the recursion over a
tree's nodes runs once on the host for all rows at once:

* the nodes are visited left child first; a path position's feature and zero
  fraction depend on the node path alone, so they are Python values; its one
  fraction (0 or 1: the row's hot child or not) and its permutation weight
  are ``[N]`` f64 tensors, held as ``[depth + 1, N]`` stacks;
* ExtendPath's loop is one step over the stack (each new weight reads only
  old ones); UnwindPath's keeps its loop over positions, with the ``one !=
  0`` branch as ``torch.where``; UnwoundPathSum runs for every position of a
  leaf's path at once, ``[depth, N]``;
* every expression keeps the Python's order of f64 operations, so each
  value carries the bits the JAX package's numpy computes (IEEE inf or nan
  where a zero fraction is 0, as numpy gives them); every divisor is a
  tensor on the rows' device (:class:`_Divisors`), since PyTorch divides a
  CUDA tensor by a Python number through its reciprocal;
* a row's recursion takes its hot child first, so its leaves add into its
  per-tree partial in its own order: each leaf's contributions are kept,
  each row's leaf order is its rank (the leaves of the hot subtree first),
  and the partial takes one ``scatter_add_`` a rank, a leaf's features being
  distinct.

``contrib_plain`` sums the per-tree partials (each starting from 0.0, its
expected value added first) into the class of each tree in tree order, as
``out[i % K] += t.predict_contrib(X, F)`` does.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..binning import MISSING_NAN, MISSING_ZERO
from ..models.tree import K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK, K_ZERO_THRESHOLD, Tree


def node_decisions(X: torch.Tensor, tree: Tree) -> torch.Tensor:
    """[N, M] bool: does each row go left at each node (``Tree._decide`` in
    f64: NumericalDecision with the missing types and default_left;
    CategoricalDecision through the node's bitset over category values, NaN
    under missing NaN, negative values and values outside the bitset going
    right; the legacy single-category equality when the tree has no
    bitsets)."""
    dev = X.device
    M = tree.num_leaves - 1
    feat = torch.as_tensor(np.asarray(tree.split_feature[:M], np.int64), device=dev)
    thr = torch.as_tensor(np.asarray(tree.threshold[:M], np.float64), device=dev)
    dt = torch.as_tensor(np.asarray(tree.decision_type[:M], np.int64), device=dev)
    miss = (dt >> 2) & 3
    fv = X[:, feat]
    nan = torch.isnan(fv)
    num = torch.where(nan & (miss != MISSING_NAN), torch.zeros_like(fv), fv)
    is_zero = (num > -K_ZERO_THRESHOLD) & (num <= K_ZERO_THRESHOLD)
    use_default = ((miss == MISSING_ZERO) & is_zero) | ((miss == MISSING_NAN) & torch.isnan(num))
    left = torch.where(use_default, ((dt & K_DEFAULT_LEFT_MASK) > 0).expand_as(fv), num <= thr)
    is_cat = (dt & K_CATEGORICAL_MASK) > 0
    if not bool(is_cat.any()):
        return left
    tv = torch.trunc(torch.where(nan, torch.zeros_like(fv), fv))
    if tree.num_cat > 0:
        bounds = torch.as_tensor(np.asarray(tree.cat_boundaries, np.int64), device=dev)
        words = torch.as_tensor(np.asarray(tree.cat_threshold, np.int64), device=dev)
        cat_idx = torch.where(is_cat, thr, torch.zeros_like(thr)).long()
        lo, nw = bounds[cat_idx], bounds[cat_idx + 1] - bounds[cat_idx]
        # int(fval) truncates; a value past 2^31 lies outside every bitset
        inside = (tv >= 0) & (tv < 2.0 ** 31)
        iv = torch.where(inside, tv, torch.zeros_like(tv)).long()
        w = iv >> 5
        inside &= w < nw
        word = words[(lo + w).clamp(0, max(words.numel() - 1, 0))] if words.numel() \
            else torch.zeros_like(iv)
        cat_left = inside & (((word >> (iv & 31)) & 1) > 0) & ~(nan & (miss == MISSING_NAN))
    else:  # single-category equality (model files without bitsets)
        cat_left = ~nan & (tv == torch.trunc(thr))
    return torch.where(is_cat, cat_left, left)


def _subtree_leaves(tree: Tree) -> np.ndarray:
    """Leaves under each node, [M] int64."""
    out = np.zeros(tree.num_leaves - 1, np.int64)
    stack, order = [0], []
    while stack:
        node = stack.pop()
        order.append(node)
        for child in (int(tree.left_child[node]), int(tree.right_child[node])):
            if child >= 0:
                stack.append(child)
    for node in reversed(order):
        out[node] = sum(1 if c < 0 else out[c]
                        for c in (int(tree.left_child[node]), int(tree.right_child[node])))
    return out


class _Divisors:
    """The divisors of the path arithmetic as device tensors: PyTorch divides
    a CUDA tensor by a Python number as a product with its reciprocal, which
    rounds differently, so each divisor is a tensor on the rows' device
    (``depth + 1``; each ``(depth - i) / (depth + 1)``, computed in Python as
    the reference computes it), cached by depth."""

    def __init__(self, device) -> None:
        self.device = device
        self._ints = torch.zeros(0, dtype=torch.float64, device=device)
        self._ratios = {}

    def plus_one(self, depth: int) -> torch.Tensor:
        if self._ints.numel() <= depth + 1:
            self._ints = torch.arange(2 * depth + 2, dtype=torch.float64, device=self.device)
        return self._ints[depth + 1]

    def ratios(self, depth: int) -> torch.Tensor:
        """[depth]: (depth - i) / (depth + 1) at index i."""
        r = self._ratios.get(depth)
        if r is None:
            r = self._ratios[depth] = torch.tensor(
                [(depth - i) / (depth + 1) for i in range(depth)], dtype=torch.float64,
                device=self.device)
        return r


def _extend(div: _Divisors, fidx: list, zf: list, of: torch.Tensor, pw: torch.Tensor,
            pzf: float, pof: torch.Tensor, pfi: int):
    """ExtendPath: the path of ``depth`` + 1 positions (``of``, ``pw``
    ``[depth, N]``) grown by one. Iteration i of the reference's loop sets
    pw[i + 1] += pof·pw[i]·(i + 1)/(depth + 1) from the old pw[i], then
    pw[i] = pzf·pw[i]·(depth - i)/(depth + 1); each new weight reads only old
    ones, so the loop is one step here, in the same order of operations."""
    depth = len(fidx)
    fidx, zf = fidx + [pfi], zf + [pzf]
    of = pof[None] if of is None else torch.cat([of, pof[None]])
    if depth == 0:
        return fidx, zf, of, torch.ones_like(of)
    n = pw.shape[1]
    den = div.plus_one(depth)
    j = torch.arange(depth + 1, dtype=torch.float64, device=pw.device)[:, None]
    a = (pzf * pw) * (depth - j[:depth]) / den
    b = (pof * pw) * j[1:] / den
    zero = torch.zeros((1, n), dtype=torch.float64, device=pw.device)
    new = torch.cat([a[:1], a[1:] + b[:-1], zero + b[-1:]])
    return fidx, zf, of, new


def _unwind(div: _Divisors, fidx: list, zf: list, of: torch.Tensor, pw: torch.Tensor, pi: int):
    """UnwindPath of position ``pi`` out of a path of ``depth`` + 1 positions."""
    depth = len(fidx) - 1
    one, zero = of[pi], zf[pi]
    nz = one != 0.0
    nxt = pw[depth]
    den = div.plus_one(depth)
    zero_den = torch.tensor([zero * (depth - i) for i in range(depth)], dtype=torch.float64,
                            device=pw.device)
    rows = list(pw.unbind(0))
    for i in range(depth - 1, -1, -1):
        tmp = rows[i]
        a = nxt * (depth + 1) / ((i + 1) * one)
        b = tmp * (depth + 1) / zero_den[i]
        rows[i] = torch.where(nz, a, b)
        nxt = torch.where(nz, tmp - a * zero * (depth - i) / den, nxt)
    keep = [p for p in range(depth + 1) if p != pi]
    return ([fidx[p] for p in keep], [zf[p] for p in keep], of[keep],
            torch.stack(rows[:depth]))


def _unwound_sums(div: _Divisors, zf: list, of: torch.Tensor, pw: torch.Tensor) -> torch.Tensor:
    """UnwoundPathSum of every position 1..depth at once: [depth, N]."""
    depth = len(zf) - 1
    one = of[1:]
    zero = torch.as_tensor(zf[1:], dtype=torch.float64, device=pw.device)[:, None]
    nz = one != 0.0
    nxt = pw[depth].expand_as(one)
    total = torch.zeros_like(one)
    ratios = div.ratios(depth)
    for i in range(depth - 1, -1, -1):
        c = ratios[i]
        tmp = nxt * (depth + 1) / ((i + 1) * one)
        total = total + torch.where(nz, tmp, (pw[i] / zero) / c)
        nxt = torch.where(nz, pw[i] - tmp * zero * c, nxt)
    return total


def tree_contrib(X: torch.Tensor, tree: Tree, num_features: int) -> torch.Tensor:
    """One tree's SHAP values of the f64 rows ``X`` [N, >= num_features]:
    ``[N, num_features + 1]`` f64, the last column its expected value, bit
    for bit ``Tree.predict_contrib``."""
    N = X.shape[0]
    F = num_features
    dev = X.device
    phi = torch.zeros((N, F + 2), dtype=torch.float64, device=dev)  # column F + 1 takes padding
    phi[:, F] += tree._expected_value_cached()
    if tree.num_leaves <= 1:
        return phi[:, :F + 1]
    go_left = node_decisions(X, tree)
    under = _subtree_leaves(tree)

    def leaves_under(child):
        return 1 if child < 0 else int(under[child])

    div = _Divisors(dev)
    leaves: List[tuple] = []  # (features, contributions [depth, N], rank [N])
    ones = torch.ones(N, dtype=torch.float64, device=dev)
    zeros_n = torch.zeros(N, dtype=torch.float64, device=dev)
    base0 = torch.zeros(N, dtype=torch.int64, device=dev)
    # frames: (node, parent path, pzf, pof [N], pfi, rank base [N])
    stack = [(0, ([], [], None, None), 1.0, ones, -1, base0)]
    while stack:
        node, (fidx, zf, of, pw), pzf, pof, pfi, base = stack.pop()
        fidx, zf, of, pw = _extend(div, fidx, zf, of, pw, pzf, pof, pfi)
        if node < 0:
            depth = len(fidx) - 1
            if depth > 0:
                leaf_out = float(tree.leaf_value[-(node + 1)])
                zf_t = torch.as_tensor(zf[1:], dtype=torch.float64, device=dev)[:, None]
                w = _unwound_sums(div, zf, of, pw)
                leaves.append((fidx[1:], (w * (of[1:] - zf_t)) * leaf_out, base))
            continue
        f = int(tree.split_feature[node])
        left, right = int(tree.left_child[node]), int(tree.right_child[node])
        w = tree._data_count(node)
        left_zf = (tree._data_count(left) / w) if w > 0 else 0.0
        right_zf = (tree._data_count(right) / w) if w > 0 else 0.0
        inc_zf, inc_of = 1.0, ones
        if f in fidx:
            pi = fidx.index(f)
            inc_zf, inc_of = zf[pi], of[pi]
            fidx, zf, of, pw = _unwind(div, fidx, zf, of, pw, pi)
        hot_left = go_left[:, node]
        path = (fidx, zf, of, pw)
        left_base = base + torch.where(hot_left, 0, leaves_under(right))
        right_base = base + torch.where(hot_left, leaves_under(left), 0)
        stack.append((right, path, right_zf * inc_zf, torch.where(hot_left, zeros_n, inc_of), f,
                      right_base))
        stack.append((left, path, left_zf * inc_zf, torch.where(hot_left, inc_of, zeros_n), f,
                      left_base))
    # each row's leaves in its own (hot child first) order, one scatter a rank
    D = max(len(feats) for feats, _, _ in leaves)
    L = len(leaves)
    contrib = torch.zeros((L, N, D), dtype=torch.float64, device=dev)
    index = torch.full((L, D), F + 1, dtype=torch.int64, device=dev)
    rank = torch.empty((L, N), dtype=torch.int64, device=dev)
    for li, (feats, c, r) in enumerate(leaves):
        contrib[li, :, :len(feats)] = c.t()
        index[li, :len(feats)] = torch.as_tensor(feats, dtype=torch.int64, device=dev)
        rank[li] = r
    order = torch.empty_like(rank)
    order.scatter_(0, rank, torch.arange(L, device=dev)[:, None].expand(L, N).contiguous())
    rows = torch.arange(N, device=dev)
    for j in range(L):
        li = order[j]
        phi.scatter_add_(1, index[li], contrib[li, rows])
    return phi[:, :F + 1]


def contrib_plain(X: torch.Tensor, trees: Sequence[Tree], num_class: int,
                  num_features: int) -> torch.Tensor:
    """[K, N, F + 1] f64 SHAP values of the f64 rows ``X`` over ``trees``:
    tree i's partial added into class i % K in tree order (the JAX package's
    ``GBDT.predict_contrib`` before its average and reshape)."""
    K = max(int(num_class), 1)
    out = torch.zeros((K, X.shape[0], num_features + 1), dtype=torch.float64, device=X.device)
    for i, t in enumerate(trees):
        out[i % K] += tree_contrib(X, t, num_features)
    return out
