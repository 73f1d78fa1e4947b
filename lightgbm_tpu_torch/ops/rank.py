"""LambdaRank's pairwise lambdas: the query plan and the plain PyTorch
version.

Counterpart of lightgbm_tpu/objective.py:842-969 (``_lambdarank_bucket``
and ``LambdarankNDCG._build_device_plans`` / ``get_gradients``): the
queries are grouped into power-of-two size buckets (at least 8), each
bucket's queries padded to its size S and cut into chunks of at most
``8 << 20`` pair cells, and each chunk's lambdas computed as dense
``[queries, S, S]`` pair tensors, then scattered back to the rows. It is the
plain version of csrc/lambdarank.cu (ops/rank_kernel.py) and the path taken
for CPU tensors; the two agree within rtol 2e-4, atol 2e-6 (the exp and the
summation order differ; both sum a row's terms in f64, since its gradient
is the difference of two sums that cancel).

:class:`RankPlan` holds what both read, built once at set-up on the
training device: the query boundaries, each row's integer label and f32
label gain, each query's f32 inverse max DCG and the row weights. The
buckets are built from it on first use of the plain version.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

#: pair cells of a bucket chunk (the TPU program's ``8 << 20``)
CHUNK_CELLS = 8 << 20


class RankPlan:
    """The query plan of one dataset on ``device``: ``qb`` [Q + 1] int32,
    ``qorder`` [Q] int32 (the queries by size, largest first: the kernel's
    block order), ``label`` [N] int32, ``gain`` [N] f32
    (``label_gain[label]``), ``invq`` [Q] f32 and ``weight`` [N] f32 or
    None; ``max_size``, the largest query."""

    def __init__(self, query_boundaries: np.ndarray, label: np.ndarray, label_gain: np.ndarray,
                 inverse_max_dcgs: np.ndarray, weight: Optional[np.ndarray],
                 device: torch.device) -> None:
        qb = np.asarray(query_boundaries, np.int64)
        li = np.asarray(label, np.int64)
        self.num_data = int(qb[-1])
        self.num_queries = len(qb) - 1
        self.max_size = int(np.diff(qb).max()) if self.num_queries else 0
        self._qb_np, self._label_np = qb, li
        self._gain_np = np.asarray(label_gain, np.float64)[li].astype(np.float32)
        self._invq_np = np.asarray(inverse_max_dcgs, np.float64).astype(np.float32)
        self._weight_np = None if weight is None else np.asarray(weight, np.float32)
        self.qb = torch.as_tensor(qb.astype(np.int32), device=device)
        self.qorder = torch.as_tensor(np.argsort(-np.diff(qb), kind="stable").astype(np.int32),
                                      device=device)
        self.label = torch.as_tensor(li.astype(np.int32), device=device)
        self.gain = torch.as_tensor(self._gain_np, device=device)
        self.invq = torch.as_tensor(self._invq_np, device=device)
        self.weight = None if weight is None else torch.as_tensor(self._weight_np, device=device)
        self.device = self.qb.device  # with its index (cuda:0 for cuda)
        self._buckets: Optional[List[Tuple]] = None

    def pairs(self) -> int:
        """Unordered pairs of rows with unequal labels in one query: the
        pairs whose lambda and hessian the function needs, once each (the
        kernel computes each from both of its rows)."""
        total = 0
        for q in range(self.num_queries):
            lab = self._label_np[self._qb_np[q]:self._qb_np[q + 1]]
            counts = np.bincount(lab)
            total += (len(lab) ** 2 - int(np.sum(counts.astype(np.int64) ** 2))) // 2
        return total

    def buckets(self) -> List[Tuple]:
        """The plain version's chunks: (idx [nq, S] int64 row ids, N for a
        pad; labs [nq, S] int32, -1 for a pad; gains [nq, S] f32; invq [nq]
        f32; weight [nq, S] f32 or None), queries of one row left out (no
        pairs: zero gradients)."""
        if self._buckets is not None:
            return self._buckets
        qb, n, dev = self._qb_np, self.num_data, self.device
        sizes = np.diff(qb)
        groups = {}
        for q, c in enumerate(sizes):
            if c > 1:
                groups.setdefault(1 << max(3, int(c - 1).bit_length()), []).append(q)
        out = []
        for S, qs in sorted(groups.items()):
            idx = np.full((len(qs), S), n, np.int64)
            for r, q in enumerate(qs):
                idx[r, :sizes[q]] = np.arange(qb[q], qb[q + 1])
            valid = idx < n
            safe = np.minimum(idx, n - 1)
            labs = np.where(valid, self._label_np[safe], -1)
            gains = np.where(valid, self._gain_np[safe], 0.0)
            invq = self._invq_np[qs]
            w = None if self._weight_np is None else np.where(valid, self._weight_np[safe], 0.0)
            chunk = max(1, CHUNK_CELLS // (S * S))
            for lo in range(0, len(qs), chunk):
                sl = slice(lo, lo + chunk)
                out.append((
                    torch.as_tensor(idx[sl], device=dev),
                    torch.as_tensor(labs[sl].astype(np.int32), device=dev),
                    torch.as_tensor(gains[sl].astype(np.float32), device=dev),
                    torch.as_tensor(invq[sl], device=dev),
                    None if w is None else torch.as_tensor(w[sl].astype(np.float32), device=dev),
                ))
        self._buckets = out
        return out


def bucket_lambdas(score: torch.Tensor, idx: torch.Tensor, labs: torch.Tensor, gains: torch.Tensor,
                   invq: torch.Tensor, weight: Optional[torch.Tensor], sigmoid: float):
    """(g, h) [nq, S] f32 of one bucket chunk (zeros in pad lanes): the TPU
    program's ``_lambdarank_bucket`` op for op, but for its four sums over
    a row's pairs, which accumulate in f64."""
    valid = labs >= 0
    s_raw = score[idx.clamp(max=score.shape[0] - 1)]
    s0 = torch.where(valid, s_raw, 0.0)
    # ranks: a stable descending sort of the real entries, pads last
    key = torch.where(valid, -s_raw, torch.inf)
    order = torch.argsort(key, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True).to(torch.float32)
    disc = torch.where(valid, torch.reciprocal(torch.log2(2.0 + rank)), 0.0)
    best = torch.where(valid, s_raw, -torch.inf).amax(1)
    worst = torch.where(valid, s_raw, torch.inf).amin(1)
    dl = (labs[:, :, None] > labs[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    ds = s0[:, :, None] - s0[:, None, :]
    dcg_gap = gains[:, :, None] - gains[:, None, :]
    paired_disc = torch.abs(disc[:, :, None] - disc[:, None, :])
    delta = dcg_gap * paired_disc * invq[:, None, None]
    delta = torch.where((best != worst)[:, None, None], delta / (0.01 + torch.abs(ds)), delta)
    # 2 / x as 2 * (1 / x): the same f32 value, the factor being a power of two
    p_lambda = 2.0 * torch.reciprocal(1.0 + torch.exp(2.0 * ds * sigmoid))
    p_hess = p_lambda * (2.0 - p_lambda)
    lam = torch.where(dl, -p_lambda * delta, 0.0)
    hes = torch.where(dl, p_hess * 2.0 * delta, 0.0)
    # the sums in f64, each result rounded to f32 once: g cancels, and a
    # query's terms run into the thousands (the kernel's order differs)
    f64 = torch.float64
    g = (lam.sum(2, dtype=f64) - lam.sum(1, dtype=f64)).to(torch.float32)
    h = (hes.sum(2, dtype=f64) + hes.sum(1, dtype=f64)).to(torch.float32)
    if weight is not None:
        g = g * weight
        h = h * weight
    return g, h


def lambdas(score: torch.Tensor, plan: RankPlan, sigmoid: float):
    """(grad, hess) [N] f32 of LambdaRank at ``score`` [N] f32: each bucket
    chunk's lambdas scattered to its rows (pads to a dropped row N)."""
    n = plan.num_data
    grad = torch.zeros(n + 1, dtype=torch.float32, device=score.device)
    hess = torch.zeros(n + 1, dtype=torch.float32, device=score.device)
    for idx, labs, gains, invq, w in plan.buckets():
        g, h = bucket_lambdas(score, idx, labs, gains, invq, w, sigmoid)
        flat = idx.reshape(-1)
        grad.scatter_(0, flat, g.reshape(-1))
        hess.scatter_(0, flat, h.reshape(-1))
    return grad[:n], hess[:n]
