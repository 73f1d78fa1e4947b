"""Wrapper of the hand-written LambdaRank lambda kernel (csrc/lambdarank.cu).

``lambdarank`` gives LambdaRank's gradients and hessians at a score over a
:class:`~.rank.RankPlan`: the kernel (one block a query) when the score lies
on a CUDA device, its plain version (ops/rank.py ``lambdas``, the TPU
program's bucketed pair tensors) when it lies on the CPU; any other device,
anything the kernel does not take, and a failed build or launch raise.
``launches["lambdarank"]`` counts the calls that launched the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import cuda_build
from . import rank as plain

launches: Dict[str, int] = {"lambdarank": 0}


def reset_launches() -> None:
    launches["lambdarank"] = 0


_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
#: rows of a query the kernel keeps in shared memory (csrc/lambdarank.cu
#: kSmemRows); a longer query reads global memory and a scratch of N floats
SMEM_ROWS = 2560


def lambdarank(score: torch.Tensor, plan: plain.RankPlan, sigmoid: float,
               scratch: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grad, hess), new [N] f32 tensors, of LambdaRank at ``score`` [N] f32
    contiguous on the plan's device, on the current stream; reads nothing
    back. ``scratch`` ([N] f32) serves the queries above :data:`SMEM_ROWS`
    rows (one is made when it is needed and not given)."""
    dev = score.device
    if dev != plan.device:
        raise ValueError("lambdarank: the score lies on %s, the plan on %s" % (dev, plan.device))
    if dev.type == "cpu":
        return plain.lambdas(score, plan, sigmoid)
    if dev.type != "cuda":
        raise ValueError("lambdarank: unsupported device %s" % dev)
    n = plan.num_data
    if score.dtype != torch.float32 or tuple(score.shape) != (n,) or not score.is_contiguous():
        raise ValueError("lambdarank: score must be a contiguous float32 [%d] tensor, got %s %s"
                         % (n, score.dtype, tuple(score.shape)))
    if plan.max_size > SMEM_ROWS and scratch is None:
        scratch = torch.empty(n, dtype=torch.float32, device=dev)
    if scratch is not None and (scratch.dtype != torch.float32 or scratch.numel() < n
                                or scratch.device != dev or not scratch.is_contiguous()):
        raise ValueError("lambdarank: scratch must be a contiguous float32 tensor of %d values on %s"
                         % (n, dev))
    grad = torch.empty(n, dtype=torch.float32, device=dev)
    hess = torch.empty(n, dtype=torch.float32, device=dev)
    fn = cuda_build.entry("lambdarank", "lgbt_lambdarank", _ARGTYPES)
    cuda_build.check(fn(
        score.data_ptr(), plan.label.data_ptr(), plan.gain.data_ptr(),
        None if plan.weight is None else plan.weight.data_ptr(), plan.qb.data_ptr(),
        plan.qorder.data_ptr(), plan.invq.data_ptr(), grad.data_ptr(), hess.data_ptr(),
        None if scratch is None else scratch.data_ptr(), float(sigmoid), plan.num_queries,
        torch.cuda.current_stream(dev).cuda_stream,
    ), "lambdarank kernel")
    launches["lambdarank"] += 1
    return grad, hess
