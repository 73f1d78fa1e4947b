"""Wrapper of the hand-written CUDA stable partition (csrc/partition.cu).

``partition`` runs the split loop's partition step on a
:class:`~.grow_state.GrowState`: the kernel when the state lies on a CUDA
device, the plain PyTorch version (ops/partition.py) when it lies on the
CPU; any other device raises. ``launches`` counts calls that launched the
kernel (its three passes: count, scan, scatter).

The arguments are checked once a tree by ``GrowState.bind``; the launch
arguments are built on the first call of a tree and reused, so a split
pays one C call and allocates nothing.
"""
from __future__ import annotations

import ctypes

from . import cuda_build, grow_state as gs, hist_kernel
from . import partition as plain

launches = 0

_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_void_p] * 11
    + [ctypes.c_int, ctypes.c_void_p]
)


def grid(s: gs.GrowState) -> int:
    """Blocks of the count and scatter passes: PARTITION_BLOCKS_PER_SM an SM,
    fewer when the state's N has fewer tiles."""
    tiles = -(-s.N // gs.PARTITION_TILE)
    return max(min(gs.PARTITION_BLOCKS_PER_SM * hist_kernel._sm_count(s.device), tiles), 1)


def partition(s: gs.GrowState) -> None:
    """Stably partition the segment of leaf ``ctl[BEST]`` by its split
    record and write the children's (begin, count); see csrc/partition.cu."""
    dev = s.device
    if dev.type == "cpu":
        plain.partition(s)
        return
    if dev.type != "cuda":
        raise ValueError("partition: unsupported device %s" % dev)
    args = s.args.get("partition")
    if args is None:
        m = s.feature_meta
        args = s.args["partition"] = (
            s.bins.data_ptr(), s.bins.stride(0), s.bins.stride(1), s.order.data_ptr(),
            s.scratch.data_ptr(), s.flags.data_ptr(), s.tiles.data_ptr(), s.ctl.data_ptr(),
            s.best_i.data_ptr(), m["missing_type"].data_ptr(), m["default_bin"].data_ptr(),
            m["num_bin"].data_ptr(), s.leaf_begin.data_ptr(), s.leaf_count.data_ptr(),
            grid(s), s.stream,
        )
    cuda_build.check(cuda_build.entry("partition", "lgbt_partition", _ARGTYPES)(*args),
                     "partition kernel")
    global launches
    launches += 1
