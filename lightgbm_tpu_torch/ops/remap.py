"""EFB-bundled histograms in feature space, and bundled columns decoded:
the plain PyTorch versions.

Counterpart of lightgbm_tpu/ops/grow.py:794-840 (``remap_hist`` and
``decode_col``, with the per-feature gather plan) for a dataset whose
``[G, N]`` bin matrix holds G groups of mutually exclusive features
(efb.py: group bin ``off(f) + s - (s > default_bin(f))`` for feature f at
sub-bin s != default_bin(f), 0 with every member at its default). The plan
is the feature meta's ``group_id`` and ``bin_offset`` with ``default_bin``
and ``num_bin``, int32 [F] on the device; its presence in the meta is the
switch, as in the JAX package.

``remap_hist`` is the plain version of csrc/efb_remap.cu
(ops/remap_kernel.py) and the path taken for CPU tensors: the default
bin's row sums the feature's other rows in the kernel's order (a pairwise
tree over 256 slots, 1024 past 256 bins), so the two agree bit for bit. ``remap_step`` and
``remap_root`` are its loop entries on a :class:`~.grow_state.GrowState`,
and ``remap_large`` the larger child's of a pooled step.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import grow_state as gs

#: slots of the default row's pairwise sum (csrc/efb_remap.cu kThreads),
#: and of a wide row's (its kWide instantiation, 4 slots a thread)
SLOTS = 256
WIDE_SLOTS = 1024


def slots(num_bins: int) -> int:
    """The tree's slots of a feature row of ``num_bins`` bins: :data:`SLOTS`
    up to 256 bins, :data:`WIDE_SLOTS` past them (csrc/efb_remap.cu's
    kWide instantiation)."""
    return SLOTS if num_bins <= SLOTS else WIDE_SLOTS


def pairwise_sum(x: torch.Tensor, width: int = SLOTS) -> torch.Tensor:
    """Sum over dim 1 of ``x`` [F, S, 3] (S <= ``width``), in the kernel's
    order: zero-padded to ``width`` slots, then at h = width/2, ..., 1 slot
    i takes slot[i] + slot[i + h]."""
    F, S, C = x.shape
    if S > width:
        raise ValueError("pairwise_sum: at most %d slots, got %d" % (width, S))
    x = torch.cat([x, x.new_zeros((F, width - S, C))], 1)
    h = width // 2
    while h:
        x = x[:, :h] + x[:, h:2 * h]
        h //= 2
    return x[:, 0]


def remap_hist(group_hist: torch.Tensor, totals: torch.Tensor,
               feature_meta: Dict[str, torch.Tensor], num_bins: int) -> torch.Tensor:
    """``[F, num_bins, 3]`` f32 feature histogram of the ``[G, Bg, 3]`` group
    histogram ``group_hist`` of a leaf whose (sum_grad, sum_hess, count) are
    ``totals`` [3]: sub-bin s != default of feature f reads group bin
    ``off(f) + s - (s > default)``, bins at or above ``num_bin(f)`` are 0,
    and the default bin's row is ``totals`` minus the other rows'
    :func:`pairwise_sum` over :func:`slots` of ``num_bins``."""
    dev = group_hist.device
    gid = feature_meta["group_id"].to(dev).long()
    off = feature_meta["bin_offset"].to(dev).long()
    dbin = feature_meta["default_bin"].to(dev).long()
    nbin = feature_meta["num_bin"].to(dev).long()
    F = gid.numel()
    s = torch.arange(num_bins, device=dev)[None, :]
    valid = (s < nbin[:, None]) & (s != dbin[:, None])
    gidx = torch.where(valid, off[:, None] + s - (s > dbin[:, None]).long(), 0)
    fh = group_hist[gid[:, None], gidx]
    fh = torch.where(valid[:, :, None], fh, torch.zeros((), dtype=fh.dtype, device=dev))
    rest = totals.to(device=dev, dtype=torch.float32)[None, :] - pairwise_sum(fh, slots(num_bins))
    fh[torch.arange(F, device=dev), dbin] = rest
    return fh


def decode_col(col: torch.Tensor, offset: int, default_bin: int, num_bin: int) -> torch.Tensor:
    """A group column's values as feature sub-bins (lightgbm_tpu/ops/grow.py
    ``decode_col``; efb.py ``decode_subbin``): ``r = col - offset``, then
    ``r + (r >= default_bin)`` where ``0 <= r < num_bin - 1``, else
    ``default_bin``."""
    r = col.long() - offset
    in_range = (r >= 0) & (r < num_bin - 1)
    return torch.where(in_range, r + (r >= default_bin).long(), default_bin)


def remap_step(s: gs.GrowState, parity: int) -> None:
    """A step of the loop on a bundled state: ``small[parity]`` the remap
    of ``small_g[parity]`` with the totals of ``laux[ctl[SMALL]]``, and
    ``small_g[1 - parity]`` zeroed for the next step's segment histogram.
    Nothing once ``ctl[ACTIVE]`` is 0."""
    if not int(s.ctl[gs.ACTIVE]):
        return
    totals = s.laux[int(s.ctl[gs.SMALL]), :3]
    s.small[parity].copy_(remap_hist(s.small_g[parity], totals, s.feature_meta, s.B))
    s.small_g[1 - parity].zero_()


def remap_root(s: gs.GrowState) -> None:
    """The root of a bundled state: ``hist[0]`` the remap of the root's
    group histogram ``small_g[1]`` with the root's sums ``laux[0]``, and
    ``small_g[0]`` zeroed for step 0."""
    if not int(s.ctl[gs.ACTIVE]):
        return
    s.hist[0].copy_(remap_hist(s.small_g[1], s.laux[0, :3], s.feature_meta, s.B))
    s.small_g[0].zero_()


def remap_large(s: gs.GrowState, parity: int) -> None:
    """A pooled step's larger child on a bundled state: ``large_g[1 -
    parity]`` zeroed for the next step, then, when the pick found the
    parent evicted (``pool_ctl[RUN]``), ``large[parity]`` the remap of
    ``large_g[parity]`` with the totals of ``laux[pool_ctl[LEAF]]`` (the
    larger child's record sums; lightgbm_tpu/ops/grow.py:1455-1476).
    Nothing once ``ctl[ACTIVE]`` is 0."""
    if not int(s.ctl[gs.ACTIVE]):
        return
    s.large_g[1 - parity].zero_()
    if not int(s.pool_ctl[gs.RUN]):
        return
    totals = s.laux[int(s.pool_ctl[gs.LEAF]), :3]
    s.large[parity].copy_(remap_hist(s.large_g[parity], totals, s.feature_meta, s.B))
