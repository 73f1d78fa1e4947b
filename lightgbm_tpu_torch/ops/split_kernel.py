"""Wrapper of the hand-written CUDA two-child split scan (csrc/split_pair.cu).

``find_best_split_pair`` takes the kernel for CUDA tensors and the plain
PyTorch version (ops/split.py) for CPU tensors; any other device, and
anything the kernel does not take, raises. ``launches`` counts calls that
launched the kernel pair.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import cuda_build, split
from .split import SplitParams

launches = 0

_META_KEYS = ("num_bin", "missing_type", "default_bin", "monotone")
_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [ctypes.c_float] * 6 + [
    ctypes.c_int, ctypes.c_void_p,
]


def _lib():
    lib = cuda_build.load("split_pair")
    lib.lgbt_split_pair.argtypes = _ARGTYPES
    lib.lgbt_split_pair.restype = ctypes.c_int
    return lib


def find_best_split_pair(
    hist: torch.Tensor,
    sums: torch.Tensor,
    cons: torch.Tensor,
    feature_meta: Dict[str, torch.Tensor],
    feature_mask: torch.Tensor,
    params: SplitParams,
    two_way: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best numerical split of each of C leaves; see ops/split.py.

    On CUDA: ``hist`` contiguous [C, F, B, 3] f32, ``sums`` [C, 3] and
    ``cons`` [C, 2] contiguous f32, the meta arrays contiguous int32 [F] and
    ``feature_mask`` bool [F], all on one device."""
    dev = hist.device
    if dev.type == "cpu":
        return split.find_best_split_pair(
            hist, sums, cons, feature_meta, feature_mask, params, two_way
        )
    if dev.type != "cuda":
        raise ValueError("find_best_split_pair: unsupported device %s" % dev)
    if hist.dim() != 4 or hist.shape[-1] != 3:
        raise ValueError("find_best_split_pair: hist must be [C, F, B, 3]")
    C, F, B, _ = hist.shape
    for name, t, shape, dtype in (
        ("hist", hist, (C, F, B, 3), torch.float32),
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
    code = _lib().lgbt_split_pair(
        hist.data_ptr(), sums.data_ptr(), cons.data_ptr(),
        *(feature_meta[k].data_ptr() for k in _META_KEYS),
        feature_mask.data_ptr(), feat_f.data_ptr(), feat_i.data_ptr(),
        outf.data_ptr(), outi.data_ptr(), C, F, B,
        p.lambda_l1, p.lambda_l2, p.max_delta_step, float(p.min_data_in_leaf),
        p.min_sum_hessian_in_leaf, p.min_gain_to_split, int(bool(two_way)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(code, "split_pair kernel")
    global launches
    launches += 1
    return outf, outi
