"""One step's pick, tree wiring and histogram subtraction of the split
loop, and each row's leaf after it: the plain PyTorch versions.

Counterpart of lightgbm_tpu/ops/grow.py's while_loop ``cond``/``body`` and
``apply_split`` (the node and leaf arrays, depth, ``internal_value``, the
children's sums and monotone windows, the smaller-child choice), then the
histogram subtraction trick (serial_tree_learner.cpp:510), and the per-row
leaf index rebuilt from the segment layout (lightgbm_tpu/ops/grow.py:
1880-1893) with the score update it feeds. They act on a
:class:`~.grow_state.GrowState` and are the oracles of the kernels
(``pick``, with ops/partition.py ``partition``, of csrc/partition.cu's
pick_partition, ops/partition_kernel.py; ``split_pair_fold``, ``subtract``
then the split scan, of csrc/split_pair.cu's folded entry,
ops/split_kernel.py; ``leaf_ids`` and ``score_update`` of
csrc/grow_step.cu, ops/grow_step_kernel.py) and the path taken for CPU
tensors. The operations are those of the host loop (ops/grow.py
``grow_tree``), in f32.
"""
from __future__ import annotations

import torch

from . import grow_state as gs
from .split import calculate_leaf_output, split_pair_step

# packed record columns (ops/split.py BEST_F / BEST_I)
_GAIN, _LG, _LH, _LC, _RG, _RH, _RC, _LO, _RO = range(9)


def pick(s: gs.GrowState, forced: bool = False) -> None:
    """Pick the leaf with the largest best gain (the first among equal
    ones) and wire its split into the tree as node ``ctl[STEP]``; clear
    ``ctl[ACTIVE]`` instead when that gain is not > 0 or M - 1 splits are
    done. Nothing once ``ctl[ACTIVE]`` is 0. ``forced`` (a step of the
    forced-split preamble): unless ``ctl[ABORT]`` is set, the leaf
    ``ctl[FLEAF]`` with the forced record ``frec_*`` instead, whatever the
    gains. With coupled CEGB the split's feature is marked paid and
    ``ctl[NEWLY]`` says whether it was new."""
    ctl = s.ctl
    if not int(ctl[gs.ACTIVE]):
        return
    node = int(ctl[gs.STEP])
    take_forced = forced and not int(ctl[gs.ABORT])
    if take_forced:
        best = int(ctl[gs.FLEAF])
        rec, rec_i, rec_b = s.frec_f.clone(), s.frec_i.clone(), s.frec_b.clone()
        go = node < s.M - 1
    else:
        best = int(torch.argmax(s.best_f[:, _GAIN]))
        rec, rec_i, rec_b = s.best_f[best].clone(), s.best_i[best].clone(), s.best_b[best].clone()
        go = bool(s.best_f[best, _GAIN] > 0.0) and node < s.M - 1
    if not go:
        ctl[gs.ACTIVE] = 0
        return
    new = int(ctl[gs.NUM_LEAVES])
    f, thr, _, dl = (int(v) for v in rec_i)
    if s.cegb is not None and s.cegb.params.has_coupled:
        ctl[gs.NEWLY] = int(not bool(s.cegb.feature_used[f]))
        s.cegb.feature_used[f] = True
    parent = int(s.leaf_i[best, 0])
    if parent >= 0:
        for c in (2, 3):
            if int(s.node_i[parent, c]) == -(best + 1):
                s.node_i[parent, c] = node
    depth = int(s.leaf_i[best, 1]) + 1
    paux = s.laux[best].clone()
    s.node_i[node] = torch.tensor([f, thr, -(best + 1), -(new + 1), dl], dtype=torch.int32)
    s.node_b[node] = rec_b
    s.node_f[node] = torch.stack(
        [rec[_GAIN], calculate_leaf_output(paux[0], paux[1], s.params), paux[2]]
    )
    s.leaf_f[best] = rec[[_LO, _LC, _LH]]
    s.leaf_f[new] = rec[[_RO, _RC, _RH]]
    s.leaf_i[best] = torch.tensor([node, depth], dtype=torch.int32)
    s.leaf_i[new] = torch.tensor([node, depth], dtype=torch.int32)

    # children's sums and monotone windows (serial_tree_learner.cpp:841-850)
    mono = int(s.feature_meta["monotone"][f])
    mid = (rec[_LO] + rec[_RO]) / 2.0
    pmin, pmax = paux[3], paux[4]
    l_min = mid if mono < 0 else pmin
    l_max = mid if mono > 0 else pmax
    r_min = mid if mono > 0 else pmin
    r_max = mid if mono < 0 else pmax
    s.laux[best] = torch.stack([rec[_LG], rec[_LH], rec[_LC], l_min, l_max])
    s.laux[new] = torch.stack([rec[_RG], rec[_RH], rec[_RC], r_min, r_max])

    left_smaller = bool(rec[_LC] <= rec[_RC])
    small, large = (best, new) if left_smaller else (new, best)
    ctl[gs.BEST], ctl[gs.NEW], ctl[gs.SMALL], ctl[gs.LARGE] = best, new, small, large
    ctl[gs.NUM_LEAVES] = new + 1
    ctl[gs.STEP] = node + 1
    if s.P:
        pool_update(s, best, small, large, node)


def pool_update(s: gs.GrowState, best: int, small: int, large: int, node: int) -> None:
    """The histogram pool's LRU update of the split of leaf ``best`` at node
    ``node`` (lightgbm_tpu/ops/grow.py:1479-1536, HistogramPool::Get): the
    larger child takes the parent's slot when the parent is resident and
    the subtraction is on (a hit), else the least recently used slot; the
    smaller child the least recently used of the others (the lowest slot
    among equal ages, as ``jnp.argmin``); both slots' occupants evicted,
    any other slot naming a child freed, both stamped ``node + 2``. The
    slots and the hit go to ``s.pool_ctl``, and RUN = not hit with LEAF =
    the larger child for the step's second segment histogram. The plain
    version of csrc/partition.cu's ``pool_update``."""
    age = s.slot_age
    pslot = int(s.slot_of[best])
    hit = s.subtract and pslot >= 0
    lslot = pslot if hit else int(torch.argmin(age))
    others = age.clone()
    others[lslot] = torch.iinfo(torch.int32).max
    sslot = int(torch.argmin(others))
    for occ in (int(s.slot_leaf[lslot]), int(s.slot_leaf[sslot])):
        if occ >= 0:
            s.slot_of[occ] = -1
    s.slot_of[small], s.slot_of[large] = sslot, lslot
    s.slot_leaf[(s.slot_leaf == small) | (s.slot_leaf == large)] = -1
    s.slot_leaf[sslot], s.slot_leaf[lslot] = small, large
    s.slot_age[sslot] = s.slot_age[lslot] = node + 2
    c = s.pool_ctl
    c[gs.RUN], c[gs.LEAF], c[gs.HIT] = int(not hit), large, int(hit)
    c[gs.SSLOT], c[gs.LSLOT], c[gs.PSLOT] = sslot, lslot, pslot


def subtract(s: gs.GrowState, parity: int) -> None:
    """``hist[LARGE] = hist[BEST] - small[parity]; hist[SMALL] =
    small[parity]``, then ``small[1 - parity]`` zeroed for the next step
    (step k's histogram is ``small[k % 2]``). With a pool the rows are the
    slots of ``pool_ctl``, and on a miss the larger child's row is its own
    histogram ``large[parity]`` (``large[1 - parity]`` zeroed too).
    Nothing once ``ctl[ACTIVE]`` is 0."""
    ctl = s.ctl
    if not int(ctl[gs.ACTIVE]):
        return
    if s.P:  # slots: the subtraction on a hit, the larger child's own histogram on a miss
        c = s.pool_ctl
        hit = bool(c[gs.HIT])
        large = s.hist[int(c[gs.PSLOT])] - s.small[parity] if hit else s.large[parity].clone()
        s.hist[int(c[gs.LSLOT])] = large
        s.hist[int(c[gs.SSLOT])] = s.small[parity]
        s.small[1 - parity].zero_()
        s.large[1 - parity].zero_()
        return
    best, small, large = int(ctl[gs.BEST]), int(ctl[gs.SMALL]), int(ctl[gs.LARGE])
    parent = s.hist[best].clone()
    s.hist[large] = parent - s.small[parity]
    s.hist[small] = s.small[parity]
    s.small[1 - parity].zero_()


def split_pair_fold(s: gs.GrowState, parity: int) -> None:
    """A step's subtraction (:func:`subtract`) and both children's split
    scan (ops/split.py ``split_pair_step``, C = 2): the plain version of the
    folded scan, ops/split_kernel.py ``split_pair_fold``. A pooled step's
    scan is not penalised under CEGB (``GrowState.pooled_rescan``)."""
    subtract(s, parity)
    split_pair_step(s, 2, penalised=not s.pooled_rescan)


def leaf_ids(s: gs.GrowState) -> torch.Tensor:
    """Per-row leaf index [N] int64 from the segment layout of the state's
    first ``ctl[NUM_LEAVES]`` leaves, with no sync: the leaves in order of
    their begin, each repeated over its count (``output_size`` N, so
    nothing sizes it on the host), scattered to the rows of ``order``."""
    by_begin = torch.argsort(s.leaf_begin)
    pos_leaf = torch.repeat_interleave(by_begin, s.leaf_count[by_begin], output_size=s.N)
    leaf_id = torch.empty(s.N, dtype=torch.int64, device=s.device)
    return leaf_id.scatter_(0, s.order.long(), pos_leaf)


def score_update(s: gs.GrowState, value: torch.Tensor, score: torch.Tensor) -> None:
    """``score += value[leaf_ids(s)]``: each row's score [N] f32 plus the
    value [M] f32 of its leaf, one f32 add a row, in place."""
    score.add_(value[leaf_ids(s)])


def cegb_lazy(s: gs.GrowState, root: bool = False) -> None:
    """The lazy CEGB bookkeeping (lightgbm_tpu/ops/grow.py:1392-1420): on a
    step, every bagged row of the split segment ``order[PBEGIN : +
    PCOUNT]`` pays the split's feature (``used_in_data[row, f]``), then
    each child's (the segment's left part ``BEST``, its right part ``NEW``)
    count of bagged rows not yet paid for each feature goes to its row of
    ``unused_cnt``; nothing once ``ctl[ACTIVE]`` is 0. ``root``: every
    row's count into ``unused_cnt[0]`` (:1146-1150), paying nothing. The
    plain version of csrc/grow_step.cu's ``cegb_lazy``."""
    used = s.cegb.used_in_data
    bag = s.values[:, 2] > 0
    if root:
        s.unused_cnt[0] = ((~used) & bag[:, None]).sum(0).to(torch.float32)
        return
    ctl = s.ctl
    if not int(ctl[gs.ACTIVE]):
        return
    b0, cnt, left = int(ctl[gs.PBEGIN]), int(ctl[gs.PCOUNT]), int(ctl[gs.LEFT])
    f = int(s.node_i[int(ctl[gs.STEP]) - 1, 0])
    rows = s.order[b0:b0 + cnt].long()
    in_bag = bag[rows]
    used[rows[in_bag], f] = True
    unpaid = (~used[rows]) & in_bag[:, None]
    s.unused_cnt[int(ctl[gs.BEST])] = unpaid[:left].sum(0).to(torch.float32)
    s.unused_cnt[int(ctl[gs.NEW])] = unpaid[left:].sum(0).to(torch.float32)
