"""Per-leaf gradient/hessian histograms: the plain PyTorch versions.

Counterpart of lightgbm_tpu/ops/histogram.py's ``leaf_histogram`` in its
``scatter`` form (one scatter-add per feature), ``leaf_values`` and the numpy
oracle ``histogram_reference``. The layout is ``[F, B, 3]`` f32 with channels
(sum_grad, sum_hess, count). These are the oracles of the hand-written CUDA
kernels in ops/hist_kernel.py and the path taken for tensors on the CPU.

``hist_dtype`` is the kernels' operand type: ``"float32"`` adds the values
as they are, ``"bfloat16"`` rounds every channel to bf16 (round to nearest
even) before the f32 accumulation, as the JAX kernels do with bf16 operands
and f32 ``preferred_element_type``. The count channel holds 0/1, which bf16
keeps exactly.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import grow_state as gs

HIST_DTYPES = ("float32", "bfloat16")


def operands(values: torch.Tensor, hist_dtype: str) -> torch.Tensor:
    """``values`` as f32 after the rounding ``hist_dtype`` asks for."""
    if hist_dtype not in HIST_DTYPES:
        raise ValueError("hist_dtype must be one of %s, got %r" % (HIST_DTYPES, hist_dtype))
    values = values.to(torch.float32)
    if hist_dtype == "bfloat16":
        values = values.to(torch.bfloat16).to(torch.float32)
    return values


def leaf_histogram(
    bins: torch.Tensor,
    values: torch.Tensor,
    num_bins: int,
    rows: Optional[torch.Tensor] = None,
    hist_dtype: str = "float32",
) -> torch.Tensor:
    """``[F, B, K]`` f32 histogram of ``values`` ([N, K]) over ``bins`` ([F, N]
    of any integer type: uint8, int16 or int32).

    ``rows`` (int indices) restricts the histogram to those rows of both
    ``bins`` and ``values`` (a leaf segment), in that order."""
    if rows is not None:
        rows = rows.long()
        bins = bins.index_select(1, rows)
        values = values.index_select(0, rows)
    F = bins.shape[0]
    K = values.shape[1]
    out = torch.zeros((F, num_bins, K), dtype=torch.float32, device=values.device)
    values = operands(values, hist_dtype)
    for f in range(F):
        out[f].index_add_(0, bins[f].long(), values)
    return out


def leaf_histogram_packed4_rows(
    bins_packed: torch.Tensor,
    values: torch.Tensor,
    num_bins: int,
    rows: Optional[torch.Tensor] = None,
    hist_dtype: str = "float32",
) -> torch.Tensor:
    """``[F, B, K]`` histogram read from nibble-packed bins by row
    (ops/hist_kernel.py ``pack_bins`` / ``pack4``): ``[F, ceil(N/2)]`` u8
    holding row 2j in the low and row 2j+1 in the high nibble, and the
    unpacked ``[N, K]`` values. Unpacks the nibble of each row r of ``rows``
    (all of 0..N-1 when None) into an ``[F, n]`` u8 matrix and takes
    :func:`leaf_histogram` of it and ``values[r]``: the sums run in row
    order, as ``leaf_histogram(bins, values, B, rows)`` runs them. A nibble
    >= B adds nothing, as in the kernels."""
    r = torch.arange(values.shape[0], device=values.device) if rows is None else rows.long()
    byte = bins_packed.index_select(1, r >> 1)
    bins = torch.where((r & 1).bool()[None, :], byte >> 4, byte & 15)
    if rows is not None:
        values = values.index_select(0, r)
    return leaf_histogram(bins, values, 16, None, hist_dtype)[:, :num_bins].contiguous()


def segment_histogram(s, parity: int = 0, large: bool = False) -> None:
    """The split loop's histogram of the smaller child on a
    :class:`~.grow_state.GrowState` ``s``: :func:`leaf_histogram` of the
    rows ``order[leaf_begin[l] : + leaf_count[l]]`` of leaf ``l =
    ctl[SMALL]`` into ``s.hist_out(parity)`` (``small[parity]``, or a
    bundled state's group-space ``small_g[parity]``), in ``s.hist_dtype``;
    nothing once ``ctl[ACTIVE]`` is 0. ``large``: the same on the pool's
    control vector ``s.pool_ctl`` into ``s.large[parity]`` (bundled:
    ``large_g[parity]``; the larger child, when its parent was evicted). The plain version of
    ops/hist_kernel.py ``histogram_segment``."""
    ctl, out = (s.pool_ctl if large else s.ctl), s.hist_out(parity, large)
    if not int(ctl[gs.ACTIVE]):
        return
    leaf = int(ctl[gs.SMALL])
    b, c = int(s.leaf_begin[leaf]), int(s.leaf_count[leaf])
    out.copy_(leaf_histogram(s.hist_bins, s.values, s.hist_width, s.order[b:b + c], s.hist_dtype))


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
