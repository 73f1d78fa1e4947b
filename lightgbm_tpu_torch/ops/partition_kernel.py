"""Wrapper of the hand-written CUDA step of the split loop (csrc/partition.cu):
the pick, the tree wiring and the stable partition of the picked leaf's
segment, in one cooperative launch.

``pick_partition`` runs one step's pick and partition on a
:class:`~.grow_state.GrowState`: the kernel when the state lies on a CUDA
device, the plain PyTorch versions (ops/grow_step.py ``pick``, then
ops/partition.py ``partition``) when it lies on the CPU; any other device
raises, and so does a launch the card refuses. ``launches`` counts the
calls that launched the kernel, by instantiation (:data:`KERNELS`):
``pick_partition``, with ``_wide`` for int16 bins, ``_pool`` for a
histogram pool's (the LRU update in the wiring thread) and ``_ext`` for
the instantiation of a run with forced splits or coupled CEGB (the forced
record on a forced step, the paid features), then ``_efb`` for a bundled
table's int16 groups or pool (the byte unpooled bundled instantiation
counts as the unbundled one); each launch counts under one key.

``block_mirror`` replays the kernel's block decomposition on the host: the
chunk each block owns, its left count, the scan of the block totals each
block makes itself, and the warp-ballot ranks tile by tile, so that the CPU
tests hold the decomposition to the plain version at any grid.

The arguments are checked once a tree by ``GrowState.bind``; the launch
arguments are built on the first call of a tree and reused, so a step pays
one C call and allocates nothing.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from . import cuda_build, grow_state as gs
from . import grow_step as plain_step
from . import partition as plain
from .split import MISSING_NAN, MISSING_ZERO

#: the launch keys. A bundled pick counts under an ``_efb`` key only with
#: int16 groups (``_wide``) or a pool (``_pool``): the byte, unpooled
#: bundled pick counts under ``pick_partition`` (and ``_ext``), the name it
#: had before those instantiations, which the older kernels-line rows and
#: phases read.
KERNELS = tuple("pick_partition" + wide + pool + ext + efb
                for efb in ("", "_efb") for wide in ("", "_wide") for pool in ("", "_pool")
                for ext in ("", "_ext") if not (efb and not wide and not pool))
launches: Dict[str, int] = {}


def reset_launches() -> None:
    """Every launch count of this module to 0."""
    launches.update(dict.fromkeys(KERNELS, 0))


reset_launches()

#: csrc/partition.cu's block shape: threads, rows a thread a tile, rows a
#: block keeps in shared memory
THREADS = gs.PICK_PARTITION_THREADS
ITEMS = 8
TILE = THREADS * ITEMS
CAP = 10240
#: the bundled instantiation's: its plan takes 1024 words of that room
EFB_CAP = CAP - 1024

ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_void_p] * 24
    + [ctypes.c_int] * 6 + [ctypes.c_float] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    + [ctypes.c_int] + [ctypes.c_void_p] * 2
)
#: the position of the ``forced`` argument in :func:`launch_args`
_FORCED_ARG = len(ARGTYPES) - 3
_grids: Dict[tuple, int] = {}


def co_resident_grid(device: torch.device, categorical: bool = False,
                     bundled: bool = False, wide: bool = False, pooled: bool = False,
                     ext: bool = False) -> int:
    """The blocks of pick_partition's instantiation (numerical or
    categorical, unbundled or bundled, uint8 or int16 bins, with or without
    a histogram pool) that fit on the card at once
    (``lgbt_pick_partition_grid``: the occupancy a multiprocessor times the
    multiprocessor count), read once per device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, bool(categorical), bool(bundled), bool(wide), bool(pooled), bool(ext))
    if key not in _grids:
        fn = cuda_build.entry("partition", "lgbt_pick_partition_grid",
                              [ctypes.c_void_p, ctypes.c_int])
        out = ctypes.c_int(0)
        kind = (int(bool(categorical)) | (int(bool(bundled)) << 1) | (int(bool(wide)) << 2)
                | (int(bool(pooled)) << 3) | (int(bool(ext)) << 4))
        with torch.cuda.device(index):
            cuda_build.check(fn(ctypes.addressof(out), kind), "pick_partition occupancy")
        _grids[key] = out.value
    return _grids[key]


def extended(s: gs.GrowState) -> bool:
    """Does the state's run take the kExt instantiation (a forced-split
    table, or coupled CEGB penalties)?"""
    return s.forced is not None or (s.cegb is not None and s.cegb.params.has_coupled)


def pick_partition(s: gs.GrowState, forced: bool = False) -> None:
    """One step of the split loop: pick the leaf with the largest best gain
    and wire its split into the tree, or clear ``ctl[ACTIVE]``; then stably
    partition its segment and write the children's (begin, count) and
    ``ctl[PBEGIN/PCOUNT/LEFT]``. Nothing once ``ctl[ACTIVE]`` is 0.
    ``forced``: a step of the forced-split preamble, which takes the forced
    record unless the preamble has aborted (ops/grow_step.py ``pick``). On
    CUDA every block that fits (:func:`co_resident_grid`), launched
    cooperatively; see csrc/partition.cu."""
    dev = s.device
    if forced and s.forced is None:
        raise ValueError("pick_partition: a forced step needs a state bound with forced splits")
    if dev.type == "cpu":
        plain_step.pick(s, forced)
        plain.partition(s)
        return
    if dev.type != "cuda":
        raise ValueError("pick_partition: unsupported device %s" % dev)
    key = "pick_partition_forced" if forced else "pick_partition"
    args = s.args.get(key)
    if args is None:
        args = launch_args(s)
        if forced:
            args = args[:_FORCED_ARG] + (1,) + args[_FORCED_ARG + 1:]
        s.args[key] = args
    cuda_build.check(entry()(*args), "pick_partition kernel")
    wide = s.bins.dtype == torch.int16
    launches["pick_partition" + ("_wide" if wide else "") + ("_pool" if s.P else "")
             + ("_ext" if extended(s) else "") + ("_efb" if s.G and (wide or s.P) else "")] += 1


def entry():
    """The C entry ``lgbt_pick_partition`` (arguments :func:`launch_args`)."""
    return cuda_build.entry("partition", "lgbt_pick_partition", ARGTYPES)


def launch_args(s: gs.GrowState, grid: Optional[int] = None) -> tuple:
    """The arguments of ``lgbt_pick_partition`` (types :data:`ARGTYPES`)
    for the CUDA state ``s`` and ``grid`` blocks (default: every block that
    fits; the card tests take fewer); raises for a grid that does not fit."""
    cat = s.is_cat is not None
    efb = s.G > 0
    wide = s.bins.dtype == torch.int16
    ext = extended(s)
    coupled = s.cegb is not None and s.cegb.params.has_coupled
    fits = co_resident_grid(s.device, cat, efb, wide, s.P > 0, ext)
    blocks = fits if grid is None else int(grid)
    if not 1 <= blocks <= min(s.block_left.numel(), fits):
        raise ValueError("pick_partition: a grid of %d blocks does not fit on the card" % blocks)
    m, p = s.feature_meta, s.params
    return (
        s.bins.data_ptr(), s.bins.stride(0), s.bins.stride(1), s.order.data_ptr(),
        s.scratch.data_ptr(), s.ctl.data_ptr(), s.best_f.data_ptr(), s.best_i.data_ptr(),
        s.node_i.data_ptr(), s.node_f.data_ptr(), s.leaf_f.data_ptr(), s.leaf_i.data_ptr(),
        s.laux.data_ptr(), m["missing_type"].data_ptr(), m["default_bin"].data_ptr(),
        m["num_bin"].data_ptr(), m["monotone"].data_ptr(), s.leaf_begin.data_ptr(),
        s.leaf_count.data_ptr(), s.block_left.data_ptr(), s.bar.data_ptr(),
        s.best_b.data_ptr() if cat else None, s.node_b.data_ptr() if cat else None,
        s.is_cat.data_ptr() if cat else None,
        m["group_id"].data_ptr() if efb else None, m["bin_offset"].data_ptr() if efb else None,
        s.pool.data_ptr() if s.P else None, s.P, int(s.subtract), 2 if wide else 1,
        s.M, s.F, s.W,
        p.lambda_l1, p.lambda_l2, p.max_delta_step, blocks, int(ext),
        s.frec_f.data_ptr() if ext else None, s.frec_i.data_ptr() if ext else None,
        s.frec_b.data_ptr() if ext and cat else None, 0,
        s.cegb.feature_used.data_ptr() if coupled else None, s.stream,
    )


def block_mirror(s: gs.GrowState, grid: int) -> Dict:
    """csrc/partition.cu's step on a CPU state, block by block: the pick
    (the plain version's; every block makes the same), then the partition as
    ``grid`` blocks do it. Block b owns rows [b * chunk, (b + 1) * chunk) of
    the segment, chunk = max(THREADS, ceil(count / grid)); it counts its
    lefts and stages its rows (in shared memory up to CAP rows, EFB_CAP on a
    bundled state, else in
    scratch); after the barrier it sums the totals of the blocks before it
    and of all blocks, and ranks its rows tile by tile: row i of a tile is
    lane i % 32 of warp (i // 32) % 32 at item i // THREADS, its rank the
    lefts of the lower lanes of its warp's ballot, its warp's offset an
    exclusive scan of the tile's (item, warp) counts. Writes what the kernel
    writes and returns the decomposition: ``chunk``, ``blocks`` (those with
    rows), ``block_left``, ``before`` (each block's scan), ``staged``."""
    if s.device.type != "cpu":
        raise ValueError("block_mirror: a CPU state")
    ctl = s.ctl
    if not int(ctl[gs.ACTIVE]):
        return {}
    plain_step.pick(s)
    if not int(ctl[gs.ACTIVE]):
        return {"stopped": True}
    leaf, new = int(ctl[gs.BEST]), int(ctl[gs.NEW])
    f, thr, _, dl = (int(v) for v in s.best_i[leaf])
    b0, cnt = int(s.leaf_begin[leaf]), int(s.leaf_count[leaf])
    meta = {k: int(s.feature_meta[k][f]) for k in ("missing_type", "default_bin", "num_bin")}
    seg = s.order[b0:b0 + cnt].numpy().astype(np.int64)
    if s.G:  # the group row, decoded as the kernel's kEfb instantiation does
        r = s.bins[int(s.feature_meta["group_id"][f])].numpy()[seg].astype(np.int64) \
            - int(s.feature_meta["bin_offset"][f])
        col = np.where((r >= 0) & (r < meta["num_bin"] - 1), r + (r >= meta["default_bin"]),
                       meta["default_bin"])
    else:
        col = s.bins[f].numpy()[seg].astype(np.int64)
    gl = col <= thr
    if meta["missing_type"] == MISSING_ZERO:
        gl = np.where(col == meta["default_bin"], bool(dl), gl)
    elif meta["missing_type"] == MISSING_NAN:
        gl = np.where(col == meta["num_bin"] - 1, bool(dl), gl)
    if s.is_cat is not None and bool(s.is_cat[f]):  # one word a row: a shift and a mask
        words = s.best_b[leaf].numpy().astype(np.int64)
        gl = ((words[col >> 5] >> (col & 31)) & 1) == 1

    chunk = max(THREADS, -(-cnt // grid))
    nb = max(-(-cnt // chunk), 1)
    bounds = [(b * chunk, max(min(cnt - b * chunk, chunk), 0)) for b in range(nb)]
    # before the barrier: each block's rows, decisions in the top bit, and left count
    staged = [seg[lo:lo + n] | (gl[lo:lo + n].astype(np.int64) << 31) for lo, n in bounds]
    block_left = [int((v >> 31).sum()) for v in staged]
    cap = EFB_CAP if s.G else CAP
    where = ["shared" if n <= cap else "scratch" for _, n in bounds]
    # after it: each block's own scan of the totals, then its ranks and writes
    out = np.full(cnt, -1, dtype=np.int64)
    befores = []
    total = sum(block_left)
    for b, (lo, n) in enumerate(bounds):
        before = sum(block_left[:b])
        befores.append(before)
        tile_base = before
        for t in range(-(-n // TILE)):
            i = t * TILE + np.arange(TILE)
            ok = i < n
            v = np.zeros(TILE, dtype=np.int64)
            v[ok] = staged[b][i[ok]]
            left = ok & ((v >> 31) == 1)
            ballot = left.reshape(ITEMS, THREADS // 32, 32)
            rank = np.cumsum(ballot, axis=2) - ballot
            counts = ballot.sum(axis=2).reshape(-1)
            woff = (np.cumsum(counts) - counts).reshape(ITEMS, THREADS // 32, 1)
            left_before = (tile_base + woff + rank).reshape(-1)
            pos = np.where(left, left_before, total + lo + i - left_before)
            out[pos[ok]] = v[ok] & 0x7FFFFFFF
            tile_base += int(counts.sum())
    assert (out >= 0).all(), "block_mirror: a position written by no row"
    s.order[b0:b0 + cnt] = torch.from_numpy(out.astype(np.int32))
    ctl[gs.PBEGIN], ctl[gs.PCOUNT], ctl[gs.LEFT] = b0, cnt, total
    s.leaf_count[leaf] = total
    s.leaf_begin[new] = b0 + total
    s.leaf_count[new] = cnt - total
    return {"chunk": chunk, "blocks": nb, "block_left": block_left, "before": befores,
            "staged": where}
