"""Wrappers of the hand-written CUDA split-loop kernels of csrc/grow_step.cu.

``subtract`` (the ``hist_subtract`` kernel: the larger child's histogram as
the parent's minus the smaller one's) and ``leaf_ids`` (the ``leaf_ids``
kernel: each row's leaf once the tree is grown) act on a
:class:`~.grow_state.GrowState`: the kernels when it lies on a CUDA device,
the plain PyTorch versions (ops/grow_step.py) when it lies on the CPU; any
other device raises. ``launches`` counts each wrapper's launches. (The
step's pick runs fused with the partition, ops/partition_kernel.py.)

The arguments are checked once a tree by ``GrowState.bind``; the launch
arguments are built on a tree's first call and reused.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import cuda_build, grow_state as gs
from . import grow_step as plain

launches: Dict[str, int] = {"hist_subtract": 0, "leaf_ids": 0}

_ARGTYPES = {
    "lgbt_hist_subtract": [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    "lgbt_leaf_ids": [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_void_p] * 2,
}
SUBTRACT_THREADS = 256


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _fn(symbol: str):
    return cuda_build.entry("grow_step", symbol, _ARGTYPES[symbol])


def _device(s: gs.GrowState, what: str) -> bool:
    """True for a CUDA state, False for a CPU one; raises otherwise."""
    if s.device.type == "cuda":
        return True
    if s.device.type != "cpu":
        raise ValueError("%s: unsupported device %s" % (what, s.device))
    return False


def subtract(s: gs.GrowState) -> None:
    """The step's histogram subtraction; see csrc/grow_step.cu."""
    if not _device(s, "hist_subtract"):
        plain.subtract(s)
        return
    args = s.args.get("hist_subtract")
    if args is None:
        cells = s.small.numel()
        args = s.args["hist_subtract"] = (
            s.ctl.data_ptr(), s.hist.data_ptr(), s.small.data_ptr(), cells,
            -(-cells // SUBTRACT_THREADS), s.stream,
        )
    cuda_build.check(_fn("lgbt_hist_subtract")(*args), "hist_subtract kernel")
    launches["hist_subtract"] += 1


def leaf_ids(s: gs.GrowState) -> torch.Tensor:
    """Each row's leaf, a new [N] int64 tensor, from the state's segment
    layout, on the current stream; see csrc/grow_step.cu. Reads nothing
    back."""
    if not _device(s, "leaf_ids"):
        return plain.leaf_ids(s)
    leaf_id = torch.empty(s.N, dtype=torch.int64, device=s.device)
    cuda_build.check(_fn("lgbt_leaf_ids")(
        s.ctl.data_ptr(), s.order.data_ptr(), s.leaf_begin.data_ptr(), s.leaf_count.data_ptr(),
        s.M, s.N, leaf_id.data_ptr(), torch.cuda.current_stream(s.device).cuda_stream,
    ), "leaf_ids kernel")
    launches["leaf_ids"] += 1
    return leaf_id
