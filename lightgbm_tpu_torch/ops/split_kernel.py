"""Wrapper of the hand-written CUDA two-child split scan (csrc/split_pair.cu).

``find_best_split_pair`` takes the kernel for CUDA tensors and the plain
PyTorch version (ops/split.py) for CPU tensors; any other device, and
anything the kernel does not take, raises. ``launches`` counts calls that
launched the kernel. ``split_pair_step`` is the device-resident split
loop's entry (``lgbt_split_pair_dev``): it reads the leaves, their sums,
windows and depth from a :class:`~.grow_state.GrowState` in device memory
and writes the records into its ``best_f`` / ``best_i``; ``step_launches``
counts it.

The kernel reads the children's rows out of the grower's ``[M, F, B, 3]``
histograms by leaf index (``leaves``), and picks each child's feature in the
same launch through a ticket counter per child: an int32 [2] tensor per
device, allocated zeroed once and kept, which every launch leaves at 0.
Calls on one device must therefore run in order on one stream, as every
caller in the port does (the device's current stream).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import cuda_build, grow_state as gs, split
from .split import SplitParams

launches = 0
step_launches = 0

MAX_BINS = 336  # the kernel's shared prefix row, the cap of csrc/histogram.cu
_META_KEYS = ("num_bin", "missing_type", "default_bin", "monotone")
_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 12
    + [ctypes.c_int] * 3 + [ctypes.c_float] * 6 + [ctypes.c_int, ctypes.c_void_p]
)
_tickets: Dict[torch.device, torch.Tensor] = {}




def _ticket_counter(dev: torch.device) -> torch.Tensor:
    count = _tickets.get(dev)
    if count is None:
        count = _tickets[dev] = torch.zeros(2, dtype=torch.int32, device=dev)
    return count


def find_best_split_pair(
    hist: torch.Tensor,
    sums: torch.Tensor,
    cons: torch.Tensor,
    feature_meta: Dict[str, torch.Tensor],
    feature_mask: torch.Tensor,
    params: SplitParams,
    two_way: bool = True,
    leaves: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best numerical split of each of C leaves; see ops/split.py.

    ``hist`` is [C, F, B, 3], or with ``leaves`` (C leaf indices) the
    grower's [M, F, B, 3], of which the scan reads rows ``leaves``. On CUDA:
    ``hist`` contiguous f32 with B <= 336 and C 1 or 2, ``sums`` [C, 3] and
    ``cons`` [C, 2] contiguous f32, the meta arrays contiguous int32 [F] and
    ``feature_mask`` bool [F], all on one device."""
    dev = hist.device
    if dev.type == "cpu":
        return split.find_best_split_pair(
            hist, sums, cons, feature_meta, feature_mask, params, two_way, leaves
        )
    if dev.type != "cuda":
        raise ValueError("find_best_split_pair: unsupported device %s" % dev)
    if hist.dim() != 4 or hist.shape[-1] != 3:
        raise ValueError("find_best_split_pair: hist must be [C, F, B, 3] or [M, F, B, 3]")
    M, F, B, _ = hist.shape
    leaves = list(range(M)) if leaves is None else [int(v) for v in leaves]
    C = len(leaves)
    if not 1 <= C <= 2 or not all(0 <= v < M for v in leaves):
        raise ValueError(
            "find_best_split_pair: the kernel scans 1 or 2 leaves of the %d given, not %s"
            % (M, leaves)
        )
    if B > MAX_BINS:
        raise ValueError("find_best_split_pair: the kernel takes B <= %d, not %d" % (MAX_BINS, B))
    for name, t, shape, dtype in (
        ("hist", hist, (M, F, B, 3), torch.float32),
        ("sums", sums, (C, 3), torch.float32),
        ("cons", cons, (C, 2), torch.float32),
        ("feature_mask", feature_mask, (F,), torch.bool),
        *((k, feature_meta[k], (F,), torch.int32) for k in _META_KEYS),
    ):
        if (
            t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()
        ):
            raise ValueError(
                "find_best_split_pair: %s must be a contiguous %s %s tensor on %s"
                % (name, dtype, shape, dev)
            )
    feat_f = torch.empty((C, F, 4), dtype=torch.float32, device=dev)
    feat_i = torch.empty((C, F, 2), dtype=torch.int32, device=dev)
    outf = torch.empty((C, 9), dtype=torch.float32, device=dev)
    outi = torch.empty((C, 4), dtype=torch.int32, device=dev)
    p = params
    code = cuda_build.entry("split_pair", "lgbt_split_pair", _ARGTYPES)(
        hist.data_ptr(), leaves[0], leaves[-1], sums.data_ptr(), cons.data_ptr(),
        *(feature_meta[k].data_ptr() for k in _META_KEYS),
        feature_mask.data_ptr(), feat_f.data_ptr(), feat_i.data_ptr(),
        outf.data_ptr(), outi.data_ptr(), _ticket_counter(dev).data_ptr(), C, F, B,
        p.lambda_l1, p.lambda_l2, p.max_delta_step, float(p.min_data_in_leaf),
        p.min_sum_hessian_in_leaf, p.min_gain_to_split, int(bool(two_way)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(code, "split_pair kernel")
    global launches
    launches += 1
    return outf, outi


_ARGTYPES_STEP = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
    + [ctypes.c_float] * 6 + [ctypes.c_int, ctypes.c_void_p]
)


def split_pair_step(s: gs.GrowState, C: int) -> None:
    """Best split of leaf ``ctl[BEST]`` (C = 1, the root) or of the children
    ``ctl[BEST]`` and ``ctl[NEW]`` (C = 2) of the state ``s``, written to
    their rows of ``s.best_f`` / ``s.best_i``, the gain -inf at a depth >=
    ``s.max_depth`` (> 0); nothing once ``ctl[ACTIVE]`` is 0. The kernel on
    a CUDA state (its inputs checked once a tree by ``GrowState.bind``), the
    plain version (ops/split.py ``split_pair_step``) on a CPU one."""
    dev = s.device
    if dev.type == "cpu":
        split.split_pair_step(s, C)
        return
    if dev.type != "cuda":
        raise ValueError("split_pair_step: unsupported device %s" % dev)
    if C not in (1, 2):
        raise ValueError("split_pair_step: C must be 1 or 2, not %r" % (C,))
    key = "split_pair_step%d" % C
    args = s.args.get(key)
    if args is None:
        if s.B > MAX_BINS:
            raise ValueError("split_pair_step: the kernel takes B <= %d, not %d" % (MAX_BINS, s.B))
        p, m = s.params, s.feature_meta
        args = s.args[key] = (
            s.hist.data_ptr(), s.ctl.data_ptr(), s.laux.data_ptr(), s.leaf_i.data_ptr(),
            s.max_depth, *(m[k].data_ptr() for k in _META_KEYS), s.feature_mask.data_ptr(),
            s.feat_f.data_ptr(), s.feat_i.data_ptr(), s.best_f.data_ptr(), s.best_i.data_ptr(),
            _ticket_counter(dev).data_ptr(), C, s.F, s.B, p.lambda_l1, p.lambda_l2,
            p.max_delta_step, float(p.min_data_in_leaf), p.min_sum_hessian_in_leaf,
            p.min_gain_to_split, int(s.two_way), s.stream,
        )
    fn = cuda_build.entry("split_pair", "lgbt_split_pair_dev", _ARGTYPES_STEP)
    cuda_build.check(fn(*args), "split_pair_step kernel")
    global step_launches
    step_launches += 1
