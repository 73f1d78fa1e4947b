"""Wrapper of the hand-written CUDA leaf-histogram kernel (csrc/histogram.cu).

``histogram`` takes the kernel for CUDA tensors and the plain PyTorch
version (ops/histogram.py) for CPU tensors; any other device, and anything
the kernel does not take, raises. There is no fallback from one to the
other. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build
from .histogram import leaf_histogram

MAX_BINS = 256

launches = 0

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p,
]


def _lib():
    lib = cuda_build.load("histogram")
    lib.lgbt_histogram.argtypes = _ARGTYPES
    lib.lgbt_histogram.restype = ctypes.c_int
    return lib


def histogram(
    bins: torch.Tensor,
    values: torch.Tensor,
    num_bins: int,
    rows: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``[F, B, 3]`` f32 histogram of ``values`` ([N, 3]) over ``bins``.

    ``bins`` is an ``[F, N]`` uint8 view with any strides, so the transposed
    ``[N, F]`` copy passes as ``bins_nf.t()``. ``rows`` is an optional int32
    vector of row indices (a leaf segment) into both inputs."""
    if bins.device.type == "cpu":
        return leaf_histogram(bins, values, num_bins, rows)
    if bins.device.type != "cuda":
        raise ValueError("histogram: unsupported device %s" % bins.device)
    if bins.dtype != torch.uint8 or bins.dim() != 2:
        raise ValueError("histogram: bins must be a 2-D uint8 tensor")
    if not 1 <= num_bins <= MAX_BINS:
        raise ValueError("histogram: num_bins must be in [1, %d], got %d" % (MAX_BINS, num_bins))
    N = bins.shape[1]
    if (
        values.device != bins.device
        or values.dtype != torch.float32
        or values.shape != (N, 3)
        or not values.is_contiguous()
    ):
        raise ValueError("histogram: values must be a contiguous [N, 3] f32 tensor on the bins' device")
    n = N
    if rows is not None:
        if (
            rows.device != bins.device
            or rows.dtype != torch.int32
            or rows.dim() != 1
            or not rows.is_contiguous()
        ):
            raise ValueError("histogram: rows must be a contiguous 1-D int32 tensor on the bins' device")
        n = rows.numel()
    F = bins.shape[0]
    out = torch.zeros((F, num_bins, 3), dtype=torch.float32, device=bins.device)
    if n == 0:
        return out
    lib = _lib()
    code = lib.lgbt_histogram(
        bins.data_ptr(), bins.stride(0), bins.stride(1), values.data_ptr(),
        rows.data_ptr() if rows is not None else None, n, F, num_bins,
        out.data_ptr(), torch.cuda.current_stream(bins.device).cuda_stream,
    )
    cuda_build.check(code, "histogram kernel")
    global launches
    launches += 1
    return out
