"""Wrappers of the hand-written CUDA kernels of csrc/grow_step.cu.

``leaf_ids`` (each row's leaf, after the split loop), ``score_update``
(each row's score plus its leaf's value, what the captured boosting
iteration runs once a tree) and ``cegb_lazy`` (lazy CEGB's bookkeeping,
each step and at the root) act on a
:class:`~.grow_state.GrowState`: the kernels when it lies on a CUDA device,
the plain PyTorch versions (ops/grow_step.py) when it lies on the CPU; any
other device raises. ``launches`` counts each wrapper's launches. (The
step's pick runs fused with the partition, ops/partition_kernel.py, and the
histogram subtraction inside the split scan, ops/split_kernel.py.)

``tile_mirror`` replays the kernels' lookup on the host: the tile of
positions each block owns, the leaves it lists and sorts by begin, and the
binary search that gives each position its leaf, so that the CPU tests hold
the decomposition to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional

import numpy as np
import torch

from . import cuda_build, grow_state as gs
from . import grow_step as plain

launches: Dict[str, int] = {"leaf_ids": 0, "score_update": 0, "cegb_lazy": 0}

_ARGTYPES = {
    "lgbt_leaf_ids": [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_void_p] * 2,
    "lgbt_score_update": [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong]
    + [ctypes.c_void_p] * 3,
    "lgbt_cegb_lazy": [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p],
}
#: blocks of a lazy pass a multiprocessor (csrc/grow_step.cu cegb_lazy, a fixed grid)
LAZY_BLOCKS_PER_SM = 2
#: positions of ``order`` a block owns (csrc/grow_step.cu kTile)
TILE = 1024


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


def cegb_lazy(s: gs.GrowState, root: bool = False) -> None:
    """The lazy CEGB bookkeeping of the step just partitioned (its bagged
    rows pay the split's feature in the training's ``used_in_data``, and the
    children's unpaid counts go to ``s.unused_cnt``), or of the tree's root
    (``root``: every row's count into ``unused_cnt[0]``): the kernel of
    csrc/grow_step.cu on a CUDA state, one fixed grid; the plain version
    (ops/grow_step.py ``cegb_lazy``) on a CPU one. Needs a state bound with
    lazy CEGB. Reads nothing back."""
    c = s.cegb
    if c is None or c.used_in_data is None:
        raise ValueError("cegb_lazy: a state bound with lazy CEGB penalties")
    if not _device(s, "cegb_lazy"):
        plain.cegb_lazy(s, root)
        return
    key = "cegb_lazy_root" if root else "cegb_lazy"
    args = s.args.get(key)
    if args is None:
        sms = torch.cuda.get_device_properties(s.device).multi_processor_count
        grid = max(1, min(sms * LAZY_BLOCKS_PER_SM, -(-s.N // 256)))
        args = s.args[key] = (
            s.ctl.data_ptr(), s.node_i.data_ptr(), s.order.data_ptr(), s.values.data_ptr(),
            c.used_in_data.data_ptr(), s.F, s.N, int(root), s.lazy_acc.data_ptr(),
            s.lazy_ticket.data_ptr(), s.unused_cnt.data_ptr(), grid, s.stream)
    cuda_build.check(_fn("lgbt_cegb_lazy")(*args), "cegb_lazy kernel")
    launches["cegb_lazy"] += 1


def score_update(s: gs.GrowState, value: torch.Tensor, score: torch.Tensor) -> None:
    """``score[r] += value[leaf of row r]`` for every row of the state's
    tree, in place, on the current stream: ``value`` a contiguous [M] f32
    tensor, ``score`` a contiguous [N] f32 one, both on the state's device.
    The kernels (csrc/grow_step.cu: the lookup writes each row's leaf into
    the state's ``leaf_scratch``, then a pass in row order adds the values)
    count as one launch. Reads nothing back."""
    for name, t, n in (("value", value, s.M), ("score", score, s.N)):
        if t.device != s.device or t.dtype != torch.float32 or t.shape != (n,) or not t.is_contiguous():
            raise ValueError("score_update: %s must be a contiguous float32 [%d] tensor on %s"
                             % (name, n, s.device))
    if not _device(s, "score_update"):
        plain.score_update(s, value, score)
        return
    cuda_build.check(_fn("lgbt_score_update")(
        s.ctl.data_ptr(), s.order.data_ptr(), s.leaf_begin.data_ptr(), s.leaf_count.data_ptr(),
        value.data_ptr(), s.M, s.N, s.leaf_scratch.data_ptr(), score.data_ptr(),
        torch.cuda.current_stream(s.device).cuda_stream,
    ), "score_update kernels")
    launches["score_update"] += 1


def tile_mirror(s: gs.GrowState, tile: int = TILE) -> Dict:
    """csrc/grow_step.cu's lookup on a CPU state, tile by tile: block t owns
    positions [t * tile, min((t + 1) * tile, N)); it lists the leaves l <
    ``ctl[NUM_LEAVES]`` whose non-empty segment meets its tile, ranks each
    by the listed begins below its own, and gives each position the last
    listed begin <= it (a binary search). Returns ``leaf_id`` ([N] int64,
    what leaf_ids writes; -1 where no leaf holds a row) and ``listed`` (each
    tile's leaves in begin order)."""
    if s.device.type != "cpu":
        raise ValueError("tile_mirror: a CPU state")
    nl = min(int(s.ctl[gs.NUM_LEAVES]), s.M)
    begin = s.leaf_begin.numpy().astype(np.int64)
    end = begin + s.leaf_count.numpy()
    order = s.order.numpy()
    leaf_id = np.full(s.N, -1, dtype=np.int64)
    listed: List[List[int]] = []
    for lo in range(0, s.N, tile):
        hi = min(lo + tile, s.N)
        meet = [l for l in range(nl) if end[l] > begin[l] and begin[l] < hi and end[l] > lo]
        assert len(meet) <= tile, ("a tile lists more leaves than it has positions", lo)
        sorted_leaves: List[Optional[int]] = [None] * len(meet)
        for l in meet:
            sorted_leaves[sum(begin[k] < begin[l] for k in meet)] = l
        assert None not in sorted_leaves, ("two listed leaves share a begin", lo)
        listed.append(sorted_leaves)
        if not meet:
            continue
        sorted_begin = begin[sorted_leaves]
        pos = np.arange(lo, hi)
        at = np.searchsorted(sorted_begin, pos, side="right") - 1
        ok = at >= 0
        leaf_id[order[pos[ok]]] = np.asarray(sorted_leaves)[at[ok]]
    return {"leaf_id": torch.from_numpy(leaf_id), "listed": listed}
