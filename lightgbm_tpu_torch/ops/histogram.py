"""Per-leaf gradient/hessian histograms: the plain PyTorch version.

Counterpart of lightgbm_tpu/ops/histogram.py's ``leaf_histogram`` in its
``scatter`` form (one scatter-add per feature), ``leaf_values`` and the numpy
oracle ``histogram_reference``. The layout is ``[F, B, 3]`` f32 with channels
(sum_grad, sum_hess, count). This is the oracle of the hand-written CUDA
kernel in ops/hist_kernel.py and the path taken for tensors on the CPU.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def leaf_histogram(
    bins: torch.Tensor,
    values: torch.Tensor,
    num_bins: int,
    rows: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``[F, B, K]`` f32 histogram of ``values`` ([N, K]) over ``bins`` ([F, N]).

    ``rows`` (int indices) restricts the histogram to those rows of both
    ``bins`` and ``values`` (a leaf segment), in that order."""
    if rows is not None:
        rows = rows.long()
        bins = bins.index_select(1, rows)
        values = values.index_select(0, rows)
    F = bins.shape[0]
    K = values.shape[1]
    out = torch.zeros((F, num_bins, K), dtype=torch.float32, device=values.device)
    values = values.to(torch.float32)
    for f in range(F):
        out[f].index_add_(0, bins[f].long(), values)
    return out


def leaf_values(
    grad: torch.Tensor, hess: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Stack (grad, hess, 1) * mask into the [N, 3] accumuland matrix."""
    m = mask.to(torch.float32)
    return torch.stack([grad * m, hess * m, m], dim=1)


def histogram_reference(bins: np.ndarray, values: np.ndarray, num_bins: int) -> np.ndarray:
    """Numpy oracle for tests (f64 accumulation, rounded to f32 once)."""
    F = bins.shape[0]
    K = values.shape[1]
    out = np.zeros((F, num_bins, K), dtype=np.float64)
    for f in range(F):
        for k in range(K):
            np.add.at(out[f, :, k], bins[f].astype(np.int64), values[:, k])
    return out.astype(np.float32)
