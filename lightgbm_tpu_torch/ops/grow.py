"""Leaf-wise (best-first) tree growth, sequential bucketed mode.

Counterpart of lightgbm_tpu/ops/grow.py ``grow_tree`` (SerialTreeLearner::
Train, serial_tree_learner.cpp:173-237) for numerical and categorical
features, unbundled or EFB-bundled:

 * a DataPartition-style row permutation: each split stably partitions the
   leaf's contiguous segment of ``order`` (data_partition.hpp:111);
 * one histogram of the root, then per split one histogram of the smaller
   child read in place through its segment of ``order``; the larger child's
   histogram is the parent's minus the smaller one's (serial_tree_learner.
   cpp:510);
 * both children's best splits from one two-child scan, which reads their
   rows of the [M, F, B, 3] histogram buffer by leaf index;
 * monotone-constraint windows per leaf (serial_tree_learner.cpp:841-850)
   and ``max_depth``;
 * categorical splits: a node's decision is its left-side bin membership,
   a bitset over bins (``cat_member``), looked up at the row's bin with no
   default direction (lightgbm_tpu/ops/grow.py:284-296);
 * EFB-bundled tables (the meta's ``group_id`` and ``bin_offset``,
   ops/remap.py): the histograms run over the ``[G, N]`` groups at the
   group width ``num_group_bins`` and are remapped into feature space, the
   root's with the root's sums and each smaller child's with its split
   record's sums, before the larger child is the parent's minus the smaller
   one's in feature space (lightgbm_tpu/ops/grow.py:1133-1140, 1439-1449);
   a split's decision reads its feature's group row and decodes it
   (``decode_col``, :1298-1301).

Two split loops grow the same tree, bit for bit:

 * ``grow_tree_device``, the device-resident loop, the counterpart of the
   reference's one ``lax.while_loop`` (lightgbm_tpu/ops/grow.py:1877): the
   loop's state lives in device memory for the whole tree
   (ops/grow_state.py ``GrowState``), the host computes the root and then
   launches the M - 1 steps without reading anything back, each step being
   the pick, the wiring and the stable partition in one launch
   (ops/partition_kernel.py ``pick_partition``), the smaller child's histogram
   (ops/hist_kernel.py ``histogram_segment``) into one of two scratch
   buffers by step parity, and the subtraction folded into both children's
   split scan (ops/split_kernel.py ``split_pair_fold``): three launches,
   every one reading its leaf indices and bounds from the state; a bundled
   table's step adds a fourth before the scan, the remap of the group
   histogram (ops/remap_kernel.py ``remap_step``). Once the
   best gain is not > 0 the kernels of the later steps return at once. Each
   row's leaf comes from the segment layout (``leaf_ids``, csrc/grow_step.cu;
   the boosting iteration adds its leaves' values to the scores from the
   same layout instead, ``grow_step_kernel.score_update``) and one
   device-to-host copy reads the tree back at the end. Every histogram call
   is ``csrc/histogram.cu``. Nothing of it reads back or allocates on the
   host, so models/gbdt.py captures a whole boosting iteration around
   ``launch_tree`` as one CUDA graph.
 * ``grow_tree``, the host loop: per split it reads the partition's left
   count and the children's packed split records back (two small syncs),
   picks the best leaf with a host argmax, and wires the tree in host
   tensors. Each histogram call is routed on its own shape: the root by
   ``rows_bucket(N)``, each smaller child by ``rows_bucket`` of its
   segment, through the run's frozen ``HistRoute`` and ``hist_dtype``
   (ops/hist_kernel.py ``routed_histogram``); at B <= 16 ``cuda_packed4``
   reads the segment out of the nibble-packed copy made at set-up.

A histogram pool (``hist_pool_slots`` P < M, the reference's
``histogram_pool_size``, lightgbm_tpu/ops/grow.py:1479-1536) keeps P
histograms in LRU slots on the device loop: the pick's wiring thread picks
the children's slots (csrc/partition.cu), a second segment launch builds
the larger child from its rows when the parent's slot was evicted (and
returns at once otherwise), and the folded scan reads the rows by slot,
skipping the subtraction on such a step: four launches a step. A bundled
table's larger child is built over the groups and remapped with its own
sums (lightgbm_tpu/ops/grow.py:1455-1476). ``use_subtract=False`` builds
both children of every split so, with P = M slots when there is no cap.
The host loop takes no pool.

The device loop also runs the reference's forced splits and CEGB
(lightgbm_tpu/ops/grow.py:1010-1047, 1392-1420, 1600-1637):

 * forced splits (``forced``, the training's [K, 3] table): K steps queued
   before the M - 1 best-gain ones, each opening with the forced record
   (ops/split_kernel.py ``forced_record``), which the step's pick takes in
   place of the argmax; an invalid one aborts the preamble, whose later
   steps are best-gain steps (csrc/partition.cu's kExt instantiation);
 * CEGB (``cegb``, the training's ops/grow_state.py ``Cegb``): the root's
   and the folded scan subtract each feature's penalty before their argmax,
   the pick marks a coupled feature paid, a step that paid one first
   rescans every other leaf (``split_pair_all``; under a pool at every
   step, the children and the resident leaves: ``GrowState.rescans_all``),
   and with lazy penalties a
   pass over the split segment pays its rows and counts each child's unpaid
   rows (ops/grow_step_kernel.py ``cegb_lazy``; at the root, every row).

The reference's masked histogram mode (lightgbm_tpu/ops/grow.py:13-20) is
its in-package oracle and grows the bucketed mode's trees; models/gbdt.py
takes ``tpu_hist_mode=masked`` as a name for these histograms.

models/gbdt.py takes the device loop when the run's route sends every row
class to ``cuda`` (``device_loop_routable``), the host loop otherwise. The
kernels run on CUDA tensors and their plain versions on CPU tensors, so
both loops run on the CPU too. The output is the JAX package's bin-space
``TreeArrays`` plus the per-row leaf index.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import grow_state as gs
from . import grow_step_kernel, hist_kernel, partition_kernel, remap_kernel, split_kernel
from .histogram import leaf_values
from .partition import stable_partition
from .split import SplitParams, calculate_leaf_output, num_words, words_member


class TreeArrays(NamedTuple):
    """Flat-array decision tree (bin-space thresholds), mirroring tree.h:58-522.
    Host (CPU) tensors; layout and dtypes of lightgbm_tpu/ops/grow.py."""

    num_leaves: torch.Tensor  # scalar int32: leaves actually grown
    split_feature: torch.Tensor  # [M-1] int32 (used-feature index)
    threshold_bin: torch.Tensor  # [M-1] int32
    default_left: torch.Tensor  # [M-1] bool
    left_child: torch.Tensor  # [M-1] int32 (node idx, or -(leaf+1) for leaves)
    right_child: torch.Tensor  # [M-1] int32
    split_gain: torch.Tensor  # [M-1] f32
    internal_value: torch.Tensor  # [M-1] f32
    internal_count: torch.Tensor  # [M-1] f32
    leaf_value: torch.Tensor  # [M] f32
    leaf_count: torch.Tensor  # [M] f32
    leaf_weight: torch.Tensor  # [M] f32 (sum of hessians)
    leaf_parent: torch.Tensor  # [M] int32
    leaf_depth: torch.Tensor  # [M] int32
    cat_member: torch.Tensor  # [M-1, B] bool: left-side bin membership


# packed record columns (ops/split.py BEST_F / BEST_I)
_GAIN, _LG, _LH, _LC, _RG, _RH, _RC, _LO, _RO = range(9)
_FEAT, _THR, _NCAT, _DL = range(4)


def grow_tree(
    bins: torch.Tensor,  # [F, N] uint8 (int16 past 256 bins)
    grad: torch.Tensor,  # [N] f32
    hess: torch.Tensor,  # [N] f32
    feature_mask: torch.Tensor,  # [F] bool
    feature_meta: Dict[str, torch.Tensor],  # int32 [F]: num_bin/missing_type/default_bin/monotone
    num_leaves: int,
    max_depth: int,
    num_bins: int,
    params: SplitParams,
    two_way: bool = True,
    bins_nf: Optional[torch.Tensor] = None,  # [N, F] copy of bins for the histograms
    route: Optional[hist_kernel.HistRoute] = None,
    hist_dtype: str = "float32",
    bins_packed: Optional[torch.Tensor] = None,  # [ceil(N/2), F] nibble-packed copy (B <= 16)
    bag: Optional[torch.Tensor] = None,  # [N] f32, 1.0 = in the bag; None: every row
    grouped: bool = False,  # csrc/histogram.cu's grouped form (hist_kernel.grouped_adds)
    num_group_bins: Optional[int] = None,  # the histograms' width of a bundled table
) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one tree; returns (TreeArrays, leaf_id [N] int64 on the bins' device).
    Rows outside the ``bag`` stay in their segments with zero weight: every
    histogram, sum and count (so the smaller child and ``min_data_in_leaf``)
    is the bag's, and ``leaf_id`` still covers every row. With an EFB plan
    in the meta, ``bins`` is the ``[G, N]`` bundled matrix and the
    histograms are built at ``num_group_bins`` (default ``num_bins``)."""
    dev = bins.device
    N = bins.shape[1]
    F = feature_meta["num_bin"].numel()
    M = num_leaves
    B = num_bins
    bundled = "group_id" in feature_meta
    Bh = num_group_bins if bundled and num_group_bins else B
    f32 = torch.float32
    meta_h = {k: v.cpu() for k, v in feature_meta.items()}
    hist_bins = bins_nf.t() if bins_nf is not None else bins
    hist_packed = bins_packed.t() if bins_packed is not None else None

    def split2(idx, laux_rows):
        aux = laux_rows.to(dev)
        out = split_kernel.find_best_split_pair(
            hist, aux[:, :3].contiguous(), aux[:, 3:].contiguous(),
            feature_meta, feature_mask, params, two_way, leaves=idx,
        )
        return tuple(o.cpu() for o in out)

    # ---- root ------------------------------------------------------------
    vals_all = leaf_values(grad, hess, torch.ones(N, dtype=f32, device=dev) if bag is None else bag)
    hist = torch.empty((M, F, B, 3), dtype=f32, device=dev)
    root = root_sums(grad, hess, vals_all, bag)
    root_hist = hist_kernel.routed_histogram(
        hist_bins, vals_all, Bh, hist_dtype=hist_dtype, route=route, bins_packed=hist_packed,
        grouped=grouped,
    )
    # a bundled table's group histogram in feature space, with the root's sums
    hist[0] = remap_kernel.efb_remap(root_hist, root, feature_meta, B) if bundled else root_hist
    root = root.cpu()

    # [M, 5] leaf aux: sum_grad, sum_hess, num_data, monotone min, max
    laux = torch.zeros((M, 5), dtype=f32)
    laux[0, :3] = root
    laux[:, 3] = -math.inf
    laux[:, 4] = math.inf
    node_f = torch.zeros((M, 3), dtype=f32)  # split_gain, internal_value, internal_count
    node_i = torch.zeros((M, 4), dtype=torch.int32)  # feature, threshold, left, right
    node_b = torch.zeros((M, 1 + B), dtype=torch.bool)  # default_left | cat_member
    leaf_f = torch.zeros((M, 3), dtype=f32)  # leaf_value, leaf_count, leaf_weight
    leaf_i = torch.zeros((M, 2), dtype=torch.int32)  # leaf_parent, leaf_depth
    leaf_i[:, 0] = -1
    leaf_f[0] = torch.stack([calculate_leaf_output(root[0], root[1], params), root[2], root[1]])
    best_f = torch.zeros((M, 9), dtype=f32)
    best_f[:, _GAIN] = -math.inf
    best_i = torch.zeros((M, 4), dtype=torch.int32)
    best_b = torch.zeros((M, num_words(B, "is_categorical" in feature_meta)), dtype=torch.int32)
    if M > 1:
        best_f[:1], best_i[:1], best_b[:1] = split2([0], laux[:1])

    order = torch.arange(N, dtype=torch.int32, device=dev)
    leaf_begin = [0] * M
    leaf_phys = [0] * M
    leaf_phys[0] = N
    nl = 1
    for node in range(M - 1):
        best_leaf = int(torch.argmax(best_f[:, _GAIN]))
        if not best_f[best_leaf, _GAIN] > 0.0:
            break
        rec_f = best_f[best_leaf].clone()
        f, thr, _, dl = (int(v) for v in best_i[best_leaf])
        new_leaf = nl

        # ---- stable partition of the leaf's segment ----------------------
        b0, cnt = leaf_begin[best_leaf], leaf_phys[best_leaf]
        bits = best_b[best_leaf].clone()
        left_phys = stable_partition(order, bins, b0, cnt, f, thr, dl, meta_h, bits)

        # ---- wire the tree ------------------------------------------------
        parent = int(leaf_i[best_leaf, 0])
        if parent >= 0:
            for c in (2, 3):
                if int(node_i[parent, c]) == -(best_leaf + 1):
                    node_i[parent, c] = node
        depth = int(leaf_i[best_leaf, 1]) + 1
        paux = laux[best_leaf].clone()
        node_i[node] = torch.tensor([f, thr, -(best_leaf + 1), -(new_leaf + 1)], dtype=torch.int32)
        node_f[node] = torch.stack(
            [rec_f[_GAIN], calculate_leaf_output(paux[0], paux[1], params), paux[2]]
        )
        node_b[node, 0] = bool(dl)
        if bits.numel():
            node_b[node, 1:] = words_member(bits, B)
        else:
            node_b[node, 1 + thr] = True  # one-hot of the threshold (numerical split)
        leaf_f[best_leaf] = rec_f[[_LO, _LC, _LH]]
        leaf_f[new_leaf] = rec_f[[_RO, _RC, _RH]]
        leaf_i[best_leaf] = torch.tensor([node, depth], dtype=torch.int32)
        leaf_i[new_leaf] = torch.tensor([node, depth], dtype=torch.int32)

        # ---- leaf sums + monotone windows --------------------------------
        mono = int(meta_h["monotone"][f])
        mid = (rec_f[_LO] + rec_f[_RO]) / 2.0
        pmin, pmax = paux[3], paux[4]
        l_min = mid if mono < 0 else pmin
        l_max = mid if mono > 0 else pmax
        r_min = mid if mono > 0 else pmin
        r_max = mid if mono < 0 else pmax
        laux[best_leaf] = torch.stack([rec_f[_LG], rec_f[_LH], rec_f[_LC], l_min, l_max])
        laux[new_leaf] = torch.stack([rec_f[_RG], rec_f[_RH], rec_f[_RC], r_min, r_max])
        leaf_begin[new_leaf] = b0 + left_phys
        leaf_phys[best_leaf] = left_phys
        leaf_phys[new_leaf] = cnt - left_phys

        # ---- histograms: smaller child from data, larger by subtraction --
        left_smaller = bool(rec_f[_LC] <= rec_f[_RC])
        small_idx, large_idx = (best_leaf, new_leaf) if left_smaller else (new_leaf, best_leaf)
        s_begin = leaf_begin[small_idx]
        small = hist_kernel.routed_histogram(
            hist_bins, vals_all, Bh, rows=order[s_begin:s_begin + leaf_phys[small_idx]],
            hist_dtype=hist_dtype, route=route, bins_packed=hist_packed, grouped=grouped,
        )
        if bundled:  # remapped with the smaller child's record sums, then subtracted
            small = remap_kernel.efb_remap(small, laux[small_idx, :3].to(dev), feature_meta, B)
        large = hist[best_leaf] - small
        hist[small_idx] = small
        hist[large_idx] = large
        nl += 1

        # ---- both children's best splits ---------------------------------
        ch = [best_leaf, new_leaf]
        outf, outi, outb = split2(ch, laux[ch])
        if max_depth > 0 and depth >= max_depth:
            outf[:, _GAIN] = -math.inf
        best_f[ch] = outf
        best_i[ch] = outi
        best_b[ch] = outb

    # per-row leaf index from the segment layout
    begins = torch.tensor(leaf_begin[:nl])
    by_begin = torch.argsort(begins)
    counts = torch.tensor(leaf_phys[:nl])[by_begin]
    pos_leaf = torch.repeat_interleave(by_begin, counts).to(dev)
    leaf_id = torch.empty(N, dtype=torch.int64, device=dev)
    leaf_id[order.long()] = pos_leaf
    tree = TreeArrays(
        num_leaves=torch.tensor(nl, dtype=torch.int32),
        split_feature=node_i[: M - 1, 0],
        threshold_bin=node_i[: M - 1, 1],
        default_left=node_b[: M - 1, 0],
        left_child=node_i[: M - 1, 2],
        right_child=node_i[: M - 1, 3],
        split_gain=node_f[: M - 1, 0],
        internal_value=node_f[: M - 1, 1],
        internal_count=node_f[: M - 1, 2],
        leaf_value=leaf_f[:, 0],
        leaf_count=leaf_f[:, 1],
        leaf_weight=leaf_f[:, 2],
        leaf_parent=leaf_i[:, 0],
        leaf_depth=leaf_i[:, 1],
        cat_member=node_b[: M - 1, 1:],
    )
    return tree, leaf_id


def root_sums(grad: torch.Tensor, hess: torch.Tensor, vals_all: torch.Tensor,
              bag: Optional[torch.Tensor]) -> torch.Tensor:
    """The root's (sum_grad, sum_hess, count) [3] f32: of the bag's rows,
    ``sum(grad * bag)`` as the reference sums them
    (lightgbm_tpu/ops/grow.py:1123-1125), or of every row without a bag."""
    if bag is None:
        return torch.stack([grad.sum(), hess.sum(), vals_all[:, 2].sum()])
    return torch.stack([(grad * bag).sum(), (hess * bag).sum(), bag.sum()])


def device_loop_routable(
    N: int, num_bins: int, hist_dtype: str, route: Optional[hist_kernel.HistRoute],
    device: torch.device, needs_device: bool = False,
) -> bool:
    """Does every histogram call of a run on ``device`` go to ``cuda``
    (csrc/histogram.cu), the one kernel the device loop launches? True when
    the router (:func:`~.hist_kernel.resolve_impl`) names ``cuda`` for every
    row class of the N-row lattice at (``num_bins``, K = 3, ``hist_dtype``)
    under the run's frozen ``route`` and the env override: always on CUDA
    without a table, and on the CPU when ``cuda`` is forced (its plain
    version then runs). ``needs_device``: the run has what only the device
    loop grows (forced splits, CEGB, ``tpu_hist_mode=masked``, a pool), so
    on the CPU with neither a table nor an override it takes the device
    loop on the plain versions; the CPU's other runs keep the host loop."""
    if (needs_device and device.type == "cpu" and route is None
            and hist_kernel.env_impl() is None):
        return True
    return all(
        hist_kernel.resolve_impl("auto", rows, num_bins, 3, hist_dtype, route, device.type)[0]
        == "cuda"
        for rows in hist_kernel.bucket_sizes(N)
    )


def start_tree(
    s: gs.GrowState,
    bins: torch.Tensor,
    grad: torch.Tensor,
    hess: torch.Tensor,
    feature_mask: torch.Tensor,
    feature_meta: Dict[str, torch.Tensor],
    max_depth: int,
    params: SplitParams,
    two_way: bool = True,
    bins_nf: Optional[torch.Tensor] = None,
    hist_dtype: str = "float32",
    bag: Optional[torch.Tensor] = None,
    grouped: bool = False,
    use_subtract: bool = True,
    forced: Optional[torch.Tensor] = None,
    cegb: Optional[gs.Cegb] = None,
) -> None:
    """Bind a tree's inputs to the state ``s``, reset it, and queue the
    root: its sums and leaf output, its histogram (of a bundled state: over
    the groups, then remapped with those sums), with lazy CEGB its rows'
    unpaid counts, and (M > 1) its split scan. Reads nothing back. ``bag``
    ([N] f32) and ``grouped`` as in :func:`grow_tree`: the segments
    (``leaf_count``) stay physical, the records' counts are the bag's.
    ``use_subtract`` False (a state with a pool) builds both children of
    every split from their rows. ``forced`` and ``cegb`` as in
    :func:`grow_tree_device`."""
    N = s.N
    hist_bins = bins_nf.t() if bins_nf is not None else bins
    ones = torch.ones(N, dtype=torch.float32, device=s.device) if bag is None else bag
    vals_all = leaf_values(grad, hess, ones)
    s.bind(bins, hist_bins, vals_all, feature_meta, feature_mask, params, two_way, max_depth,
           hist_dtype, grouped, use_subtract, forced, cegb)
    s.reset()
    root = root_sums(grad, hess, vals_all, bag)
    s.laux[0, :3] = root
    s.leaf_f[0] = torch.stack([calculate_leaf_output(root[0], root[1], params), root[2], root[1]])
    if s.G:  # the group histogram (small_g[1], zeroed by reset), remapped with laux[0]
        hist_kernel.histogram(hist_bins, vals_all, s.Bg, None, hist_dtype, out=s.small_g[1],
                              grouped=grouped)
        remap_kernel.remap_root(s)
    else:
        root_hist = s.hist[0]
        root_hist.zero_()
        hist_kernel.histogram(hist_bins, vals_all, s.B, None, hist_dtype, out=root_hist,
                              grouped=grouped)
    if s.M < 2:
        return
    if cegb is not None and cegb.used_in_data is not None:
        grow_step_kernel.cegb_lazy(s, root=True)
    split_kernel.split_pair_step(s, 1)


def run_step(s: gs.GrowState, forced_step: Optional[int] = None) -> None:
    """Queue the next step of the loop: pick, wiring and partition (one
    launch), the smaller child's histogram into ``s.small[k % 2]`` for the
    k-th step since the root (``s.queued_steps``), and the subtraction with
    both children's split scan (one launch, which clears the other buffer
    for step k + 1). A bundled state's histogram goes into
    ``s.small_g[k % 2]`` and one more launch remaps it into ``s.small[k %
    2]`` with the smaller child's sums (and clears ``s.small_g`` for step
    k + 1). A state with a histogram pool launches the segment entry a
    second time for the larger child, which returns at once unless the
    pick found its parent evicted (or the subtraction off), and the scan
    reads the rows by slot; a bundled one also remaps that histogram with
    the larger child's sums (a launch that returns at once on a hit): six
    launches a pooled bundled step. Every kernel returns at once when the
    loop has stopped. ``forced_step`` k: step k of the forced-split
    preamble, which opens with its forced record. Under CEGB the scans are
    penalised (a pooled step's fold is not: ``GrowState.pooled_rescan``), a
    lazy pass follows the partition and the all-leaves rescan the scan
    (``GrowState.rescans_all``)."""
    parity = s.queued_steps % 2
    s.queued_steps += 1
    if forced_step is None:
        partition_kernel.pick_partition(s)
    else:
        split_kernel.forced_record(s, forced_step)
        partition_kernel.pick_partition(s, forced=True)
    cegb = s.cegb
    if cegb is not None and cegb.used_in_data is not None:
        grow_step_kernel.cegb_lazy(s)
    hist_kernel.histogram_segment(s, parity)
    if s.P:
        hist_kernel.histogram_segment(s, parity, large=True)
    if s.G:
        remap_kernel.remap_step(s, parity)
        if s.P:
            remap_kernel.remap_large(s, parity)
    split_kernel.split_pair_fold(s, parity)
    if s.rescans_all:
        split_kernel.split_pair_all(s)


def launch_tree(s: gs.GrowState, *args, **kwargs) -> None:
    """Queue one tree's split loop on the state ``s``, from the root
    (:func:`start_tree`, which takes these arguments) to its M - 1 steps
    (:func:`run_step`), reading nothing back; with a forced table of K rows,
    min(K, M - 1) forced steps before them, so that M - 1 best-gain steps
    remain after an abort. The state then holds the tree."""
    start_tree(s, *args, **kwargs)
    K = 0 if s.forced is None else min(int(s.forced.shape[0]), s.M - 1)
    for k in range(K):
        run_step(s, k)
    for _ in range(s.M - 1):
        run_step(s)


def forced_table(forced_splits, device: torch.device) -> Optional[torch.Tensor]:
    """The forced-split table, a sequence of (leaf, used feature, threshold
    bin), as a contiguous [K, 3] int32 tensor on ``device`` (None for no
    forced split)."""
    if not forced_splits:
        return None
    return torch.tensor([list(map(int, r)) for r in forced_splits], dtype=torch.int32,
                        device=device).reshape(-1, 3)


def pool_slots(hist_pool_slots: Optional[int], num_leaves: int, use_subtract: bool = True) -> int:
    """The state's pool slots P for the reference's ``hist_pool_slots`` (a
    pool only when fewer than the leaves) and ``use_subtract``: 0 without a
    pool, M slots (no eviction) when the subtraction is off."""
    if hist_pool_slots is not None and hist_pool_slots < num_leaves:
        if hist_pool_slots < 2:
            raise ValueError("histogram pool needs at least 2 slots, got %d" % hist_pool_slots)
        return int(hist_pool_slots)
    return 0 if use_subtract else num_leaves


def leaf_ids(s: gs.GrowState) -> torch.Tensor:
    """Per-row leaf index [N] int64 of the tree the state holds, on the
    state's device with no sync (ops/grow_step_kernel.py ``leaf_ids``: the
    kernel of csrc/grow_step.cu on CUDA, the plain version on the CPU)."""
    return grow_step_kernel.leaf_ids(s)


def tree_from_packed(host: torch.Tensor, M: int, B: int, W: int) -> TreeArrays:
    """Host TreeArrays of an M-leaf tree from a host copy of a state's packed
    int32 buffer of W membership words a node (ops/grow_state.py
    ``unpack``); the arrays are views of ``host``. ``cat_member`` is each
    node's membership (W > 0), else the one-hot of its threshold."""
    ctl, node_i, leaf_i, node_f, leaf_f, node_b = gs.unpack(host, M, W)
    nl = int(ctl[gs.NUM_LEAVES])
    if W:
        cat_member = words_member(node_b, B)
    else:
        cat_member = torch.zeros((M - 1, B), dtype=torch.bool)
        splits = torch.arange(nl - 1)
        cat_member[splits, node_i[: nl - 1, 1].long()] = True  # one-hot of each split's threshold
    return TreeArrays(
        num_leaves=torch.tensor(nl, dtype=torch.int32),
        split_feature=node_i[: M - 1, 0],
        threshold_bin=node_i[: M - 1, 1],
        default_left=node_i[: M - 1, 4] != 0,
        left_child=node_i[: M - 1, 2],
        right_child=node_i[: M - 1, 3],
        split_gain=node_f[: M - 1, 0],
        internal_value=node_f[: M - 1, 1],
        internal_count=node_f[: M - 1, 2],
        leaf_value=leaf_f[:, 0],
        leaf_count=leaf_f[:, 1],
        leaf_weight=leaf_f[:, 2],
        leaf_parent=leaf_i[:, 0],
        leaf_depth=leaf_i[:, 1],
        cat_member=cat_member,
    )


def read_tree(s: gs.GrowState) -> TreeArrays:
    """The grown tree as host TreeArrays, from one device-to-host copy of
    the state's packed buffer."""
    # a copy on the CPU too: the state is reused
    return tree_from_packed(s.packed.to("cpu", copy=True), s.M, s.B, s.W)


def grow_tree_device(
    bins: torch.Tensor,  # [F, N] uint8 (int16 past 256 bins)
    grad: torch.Tensor,  # [N] f32
    hess: torch.Tensor,  # [N] f32
    feature_mask: torch.Tensor,  # [F] bool
    feature_meta: Dict[str, torch.Tensor],  # int32 [F]: num_bin/missing_type/default_bin/monotone
    num_leaves: int,
    max_depth: int,
    num_bins: int,
    params: SplitParams,
    two_way: bool = True,
    bins_nf: Optional[torch.Tensor] = None,  # [N, F] copy of bins for the histograms
    hist_dtype: str = "float32",
    state: Optional[gs.GrowState] = None,
    bag: Optional[torch.Tensor] = None,
    grouped: bool = False,
    num_group_bins: Optional[int] = None,
    hist_pool_slots: Optional[int] = None,
    use_subtract: bool = True,
    forced_splits=(),  # [(leaf, used feature, threshold bin), ...]
    cegb: Optional[gs.Cegb] = None,
) -> Tuple[TreeArrays, torch.Tensor, gs.GrowState]:
    """Grow one tree with the device-resident split loop; returns
    (TreeArrays, leaf_id [N] int64 on the bins' device, the state). Pass the
    returned state back as ``state`` to reuse its buffers for the next tree
    (a state of another shape is replaced). Takes the arguments of
    :func:`grow_tree` but no route: every histogram call is ``cuda``; and
    those of the reference's ``grow_tree``: ``hist_pool_slots`` (a pool of
    that many LRU slots when fewer than the leaves) and ``use_subtract``
    (False: both children of every split from their rows); ``forced_splits``
    (the BFS table of models/gbdt.py ``parse_forced_splits``), ``cegb`` (the
    training's CEGB state, carried from tree to tree: its paid features and
    rows are updated in place)."""
    R, N = bins.shape
    F = feature_meta["num_bin"].numel()
    G = R if "group_id" in feature_meta else 0
    Bg = (num_group_bins or num_bins) if G else 0
    W = num_words(num_bins, "is_categorical" in feature_meta)
    P = pool_slots(hist_pool_slots, num_leaves, use_subtract)
    forced = forced_table(forced_splits, bins.device)
    if P and forced is not None and P < forced.shape[0] + 2:
        raise ValueError("histogram pool too small for the forced-splits preamble: "
                         "need >= %d slots" % (forced.shape[0] + 2))
    shape = (N, F, num_bins, num_leaves, W, G, Bg, P, cegb is not None)
    if state is None or not state.fits(bins.device, *shape):
        state = gs.GrowState(bins.device, *shape)
    launch_tree(state, bins, grad, hess, feature_mask, feature_meta, max_depth,
                params, two_way, bins_nf, hist_dtype, bag, grouped, use_subtract, forced, cegb)
    leaf_id = leaf_ids(state)
    return read_tree(state), leaf_id, state
