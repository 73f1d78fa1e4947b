"""Wrapper of the hand-written group-to-feature histogram remap of
EFB-bundled datasets (csrc/efb_remap.cu).

``efb_remap`` remaps one ``[G, Bg, 3]`` group histogram with host-given
totals (the host split loop); ``remap_root`` and ``remap_step`` are the
device loop's entries on a bundled :class:`~.grow_state.GrowState`, which
read the totals and the stop flag from the state in device memory, and
``remap_large`` the larger child's of a pooled step. Each launches the
kernel for CUDA tensors and runs its plain version (ops/remap.py) for CPU
tensors; any other device, anything the kernel does not take, and a failed
build or launch raise. ``launches`` counts the calls that launched the
kernel, by instantiation: ``efb_remap``, with ``_wide`` past 256 bins (the
1024-slot tree) and ``_large`` for a pooled step's larger child.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import cuda_build, grow_state as gs
from . import remap as plain

KERNELS = ("efb_remap", "efb_remap_wide", "efb_remap_large", "efb_remap_wide_large")
launches: Dict[str, int] = {}


def reset_launches() -> None:
    """Every launch count of this module to 0."""
    launches.update(dict.fromkeys(KERNELS, 0))


reset_launches()

#: the widest feature row and group row the kernel takes (4 sub-bins a thread past 256)
MAX_BINS = plain.WIDE_SLOTS
_PLAN_KEYS = ("group_id", "bin_offset", "default_bin", "num_bin")
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2


def _launch(inp: torch.Tensor, out: torch.Tensor, zero_g: Optional[torch.Tensor],
            totals: torch.Tensor, ctl: Optional[torch.Tensor], meta: Dict[str, torch.Tensor],
            row: int, stream, run: Optional[torch.Tensor] = None) -> None:
    G, Bg, _ = inp.shape
    F, B, _ = out.shape
    fn = cuda_build.entry("efb_remap", "lgbt_efb_remap", _ARGTYPES)
    cuda_build.check(fn(
        inp.data_ptr(), out.data_ptr(), None if zero_g is None else zero_g.data_ptr(),
        totals.data_ptr(), None if ctl is None else ctl.data_ptr(),
        *(meta[k].data_ptr() for k in _PLAN_KEYS), row, F, B, G, Bg,
        None if run is None else run.data_ptr(), stream,
    ), "efb_remap kernel")
    launches["efb_remap" + ("_wide" if B > plain.SLOTS else "")
             + ("" if run is None else "_large")] += 1


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, dev: torch.device, shape) -> None:
    if t.device != dev or t.dtype != dtype or not t.is_contiguous() or tuple(t.shape) != tuple(shape):
        raise ValueError("efb_remap: %s must be a contiguous %s %s tensor on %s, got %s %s on %s"
                         % (name, dtype, tuple(shape), dev, t.dtype, tuple(t.shape), t.device))


def efb_remap(group_hist: torch.Tensor, totals: torch.Tensor, feature_meta: Dict[str, torch.Tensor],
              num_bins: int) -> torch.Tensor:
    """``[F, num_bins, 3]`` f32 feature histogram of the ``[G, Bg, 3]`` f32
    group histogram of a leaf with (sum_grad, sum_hess, count) ``totals``
    [3] f32, through the meta's plan (ops/remap.py ``remap_hist``)."""
    dev = group_hist.device
    if dev.type == "cpu":
        return plain.remap_hist(group_hist, totals, feature_meta, num_bins)
    if dev.type != "cuda":
        raise ValueError("efb_remap: unsupported device %s" % dev)
    if group_hist.dim() != 3 or group_hist.shape[2] != 3:
        raise ValueError("efb_remap: group_hist must be [G, Bg, 3], got %s" % (tuple(group_hist.shape),))
    G, Bg, _ = group_hist.shape
    F = feature_meta["group_id"].numel()
    if not 1 <= num_bins <= MAX_BINS or not 1 <= Bg <= MAX_BINS:
        raise ValueError("efb_remap: the kernel takes at most %d bins a row, got B %d and Bg %d"
                         % (MAX_BINS, num_bins, Bg))
    _check("group_hist", group_hist, torch.float32, dev, (G, Bg, 3))
    _check("totals", totals, torch.float32, dev, (3,))
    for k in _PLAN_KEYS:
        _check(k, feature_meta[k], torch.int32, dev, (F,))
    out = torch.empty((F, num_bins, 3), dtype=torch.float32, device=dev)
    _launch(group_hist, out, None, totals, None, feature_meta, 0,
            torch.cuda.current_stream(dev).cuda_stream)
    return out


def _state_kernel(s: gs.GrowState, what: str) -> bool:
    """True for a CUDA state, False for a CPU one; raises otherwise, and for
    a state without groups."""
    if not s.G:
        raise ValueError("%s: the state holds no groups (an unbundled table)" % what)
    if s.device.type == "cuda":
        if s.B > MAX_BINS or s.Bg > MAX_BINS:
            raise ValueError("%s: the kernel takes at most %d bins a row, got B %d and Bg %d"
                             % (what, MAX_BINS, s.B, s.Bg))
        return True
    if s.device.type != "cpu":
        raise ValueError("%s: unsupported device %s" % (what, s.device))
    return False


def remap_root(s: gs.GrowState) -> None:
    """``hist[0]`` = the remap of the root's group histogram ``small_g[1]``
    with the root's sums ``laux[0]``; ``small_g[0]`` cleared for step 0."""
    if not _state_kernel(s, "remap_root"):
        plain.remap_root(s)
        return
    _launch(s.small_g[1], s.hist[0], s.small_g[0], s.laux, s.ctl, s.feature_meta, 0, s.stream)


def remap_step(s: gs.GrowState, parity: int) -> None:
    """A step's remap: ``small[parity]`` = the remap of ``small_g[parity]``
    with the totals of ``laux[ctl[SMALL]]`` (the smaller child's record
    sums), ``small_g[1 - parity]`` cleared for the next step; nothing once
    ``ctl[ACTIVE]`` is 0."""
    if not _state_kernel(s, "remap_step"):
        plain.remap_step(s, parity)
        return
    _launch(s.small_g[parity], s.small[parity], s.small_g[1 - parity], s.laux, s.ctl,
            s.feature_meta, -1, s.stream)


def remap_large(s: gs.GrowState, parity: int) -> None:
    """A pooled step's larger child: ``large_g[1 - parity]`` cleared, then
    on a miss (``pool_ctl[RUN]``) ``large[parity]`` = the remap of
    ``large_g[parity]`` with the totals of ``laux[pool_ctl[LEAF]]``; the
    launch returns at once on a hit, and before anything once
    ``ctl[ACTIVE]`` is 0 (ops/remap.py ``remap_large``)."""
    if not s.P:
        raise ValueError("remap_large: the larger child's remap needs a pool")
    if not _state_kernel(s, "remap_large"):
        plain.remap_large(s, parity)
        return
    _launch(s.large_g[parity], s.large[parity], s.large_g[1 - parity], s.laux, s.ctl,
            s.feature_meta, -1, s.stream, run=s.pool_ctl)
