"""The device-resident state of one tree's split loop (ops/grow.py
``grow_tree_device``).

Counterpart of ``GrowState`` (lightgbm_tpu/ops/grow.py): every tensor the
loop reads or writes between the root and the readback, preallocated once
and reset on the device at the start of each tree, so that a split
allocates nothing and the host reads nothing back until the tree is done.

``ctl`` is the loop's control vector, int32 [CTL]; the kernels
(csrc/partition.cu, csrc/grow_step.cu, csrc/histogram.cu's segment entry,
csrc/split_pair.cu's device-indexed entry) name its slots by the same
numbers:

=========  =====================================================
ACTIVE     1 while the loop runs; the pick clears it to stop
NUM_LEAVES leaves grown so far
STEP       the node index of the next split
BEST       the leaf being split (0 for the root's scan)
NEW        the new leaf of the split (the right child)
SMALL      the child whose histogram is built from its rows
LARGE      the child whose histogram is the parent's minus SMALL's
PBEGIN     the split segment's begin, count and left count,
PCOUNT     written by the step's pick and partition
LEFT
FLEAF      the leaf of the step's forced split (its forced record)
ABORT      1 once a forced split of the preamble was invalid
NEWLY      1 when the step's split paid a coupled CEGB feature first
=========  =====================================================

Forced splits (``bind(forced=)``: the training's ``[K, 3]`` int32 table of
(leaf, used feature, threshold bin), on the device) add the step's forced
record ``frec_f`` [9] f32, ``frec_i`` [4] int32 and ``frec_b`` [W] int32,
which csrc/split_pair.cu's forced record writes and csrc/partition.cu's
pick reads. CEGB (``bind(cegb=)``, a :class:`Cegb` the training keeps: the
paid features ``feature_used`` [F] and, with lazy penalties, the paid rows
``used_in_data`` [N, F], both carried across trees and classes) adds a
state built with ``cegb=True``: ``unused_cnt`` [M, F] f32 (each leaf's
bagged rows that have not paid for each feature, reset each tree), the
all-leaves scan's scratch ``feat_f_all`` [M, F, 4], ``feat_i_all`` [M, F,
2], ``feat_b_all`` [M, F, W] and tickets ``tickets_all`` [M], and the lazy
pass's ``lazy_acc`` [2, F] int32 and ``lazy_ticket`` [1].

The tree's arrays and ``ctl`` share one int32 buffer, ``packed`` (the f32
arrays are float views of it), so the readback is one device-to-host copy.
With categorical features each node's left-side bin membership rides in it
too, W = ceil(B / 32) words a node (``node_b``); without them W is 0.

A histogram pool (``histogram_pool_size``, P > 0 slots, P < M; or P = M
when the subtraction is off) keeps ``hist`` as [P, F, B, 3] slots, not
leaves, and the LRU bookkeeping of lightgbm_tpu/ops/grow.py:269-272 in one
int32 buffer, ``pool``: its own control vector ``pool_ctl`` [CTL] (the
slots the CUDA kernels read: RUN and LEAF for the step's second segment
histogram, which reads ``pool_ctl`` as its control vector, then HIT,
SSLOT, LSLOT, PSLOT), ``slot_of`` [M] (each leaf's slot, -1 evicted),
``slot_leaf`` [P] (each slot's leaf, -1 free) and ``slot_age`` [P] (LRU
stamps, 0 never used). The pick's wiring thread updates them
(csrc/partition.cu ``pool_update``); ``large`` [2, F, B, 3] holds the
larger child's histogram of a step whose parent was evicted, by parity.

The bins are uint8, or int16 at more than 256 bins a feature (up to 1024).

An EFB-bundled table (G > 0 groups of Bg bins, ops/remap.py) keeps the
histograms and the pool in feature space; its histograms are built over
the ``[G, N]`` groups (uint8, or int16 past 256 bins a group) into
``small_g`` and remapped into ``small`` and the root's ``hist[0]``
(ops/remap_kernel.py); with a pool, the larger child of a step whose
parent was evicted is built into ``large_g`` [2, G, Bg, 3] and remapped
into ``large``. An unbundled state has G = 0 and no group buffer.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

ACTIVE, NUM_LEAVES, STEP, BEST, NEW, SMALL, LARGE, PBEGIN, PCOUNT, LEFT = range(10)
FLEAF, ABORT, NEWLY = 10, 11, 12
CTL = 16
#: slots of a pool's control vector ``pool_ctl``: the step's second segment
#: histogram runs (RUN) on leaf LEAF (the larger child; its control vector's
#: ACTIVE and SMALL slots), whether the parent's histogram was resident
#: (HIT), the smaller and the larger child's slots and the parent's
RUN, LEAF, HIT, SSLOT, LSLOT, PSLOT = ACTIVE, SMALL, 10, 11, 12, 13
#: the bin types of a state: bytes, and int16 past 256 bins a feature
BIN_DTYPES = (torch.uint8, torch.int16)

#: threads of a pick_partition block (csrc/partition.cu kThreads); at most
#: 2048 threads, so 2 such blocks, fit on an SM of sm_90
PICK_PARTITION_THREADS = 1024
PICK_PARTITION_BLOCKS_PER_SM = 2048 // PICK_PARTITION_THREADS
_META_KEYS = ("num_bin", "missing_type", "default_bin", "monotone")
_PLAN_KEYS = ("group_id", "bin_offset")


def unpack(packed: torch.Tensor, M: int, W: int):
    """Views of the packed int32 buffer of an M-leaf state: ``ctl`` [CTL],
    ``node_i`` [M, 5], ``leaf_i`` [M, 2], ``node_f`` [M, 3] f32, ``leaf_f``
    [M, 3] f32 and ``node_b`` [M - 1, W] (each node's membership words)."""
    ctl, node_i, leaf_i, node_f, leaf_f, node_b = torch.split(
        packed, (CTL, 5 * M, 2 * M, 3 * M, 3 * M, W * (M - 1)))
    return (ctl, node_i.view(M, 5), leaf_i.view(M, 2), node_f.view(torch.float32).view(M, 3),
            leaf_f.view(torch.float32).view(M, 3), node_b.view(M - 1, W))


class Cegb:
    """A training's CEGB state on ``device`` (lightgbm_tpu/models/gbdt.py
    ``_setup_cegb``): the switches ``params`` (ops/split.py ``CegbParams``),
    the penalty vectors times the tradeoff in f32 (``coupled_t``,
    ``lazy_t`` [F], None when not given), and what has been paid:
    ``feature_used`` [F] bool and, with lazy penalties, ``used_in_data``
    [N, F] bool (the reference's [F, N], transposed so that a row's flags
    are contiguous). One state serves every tree and class of a training; a
    new training (``init_model`` too) makes a new one."""

    def __init__(self, params, F: int, N: int, coupled: Optional[np.ndarray],
                 lazy: Optional[np.ndarray], device: torch.device) -> None:
        self.params = params
        t = np.float32(params.tradeoff)

        def scaled(v):
            return None if v is None else torch.from_numpy(
                (t * np.asarray(v, np.float32)).astype(np.float32)).to(device)

        self.coupled_t = scaled(coupled) if params.has_coupled else None
        self.lazy_t = scaled(lazy) if params.has_lazy else None
        #: f32 tradeoff * penalty_split
        self.split = float(np.float32(params.tradeoff * params.penalty_split))
        self.feature_used = torch.zeros(F, dtype=torch.bool, device=device)
        self.used_in_data = (torch.zeros((N, F), dtype=torch.bool, device=device)
                             if params.has_lazy else None)


class GrowState:
    """Preallocated state of the split loop for trees of ``num_leaves``
    leaves over ``N`` rows of ``F`` features with ``B`` bins on ``device``,
    ``W`` membership words a record (ops/split.py ``num_words``: 0 without
    categorical features).

    Tree arrays (layout of ops/grow.py ``TreeArrays``): ``node_i`` [M, 5]
    int32 (feature, threshold, left, right, default_left), ``node_f`` [M, 3]
    f32 (split_gain, internal_value, internal_count), ``leaf_f`` [M, 3] f32
    (value, count, weight), ``leaf_i`` [M, 2] int32 (parent, depth),
    ``node_b`` [M - 1, W] int32 (membership words). Loop state: ``best_f``
    [M, 9] f32, ``best_i`` [M, 4] int32 and ``best_b`` [M, W] int32 (each
    leaf's best split record), ``laux`` [M, 5] f32 (sum_grad, sum_hess, count,
    monotone min, max), ``leaf_begin`` / ``leaf_count`` [M] int32 (each
    leaf's segment of ``order``), ``order`` [N] int32, ``hist`` [M, F, B, 3]
    f32 ([P, F, B, 3] with a pool of ``P`` slots, and its bookkeeping in
    ``pool``, ``large`` [2, F, B, 3]: see the module's docstring) and
    ``small`` [2, F, B, 3] f32 (the smaller child's histogram of
    step k in ``small[k % 2]``, which step k - 1's scan leaves zeroed).
    Bundled (``G`` groups of ``Bg`` bins, ``G`` > 0): ``small_g`` [2, G,
    Bg, 3] f32, the group-space histograms: step k's segment histogram adds
    into ``small_g[k % 2]`` (which step k - 1's remap leaves zeroed), and the
    root's into ``small_g[1]``. Scratch of the kernels: ``scratch`` [N] int32 (the
    rows a pick_partition block stages beyond its shared memory),
    ``block_left`` int64 (each block's word at its grid barrier: the
    launch's epoch above the block's left count, one a block that fits on
    the card) and ``bar`` [1] int32 (the epoch of its last launch that
    split), ``feat_f`` / ``feat_i`` / ``feat_b`` (the split scan's
    per-feature records), ``leaf_scratch`` [N] (each row's leaf between the two
    launches of the score update: uint8 up to 256 leaves, else int32)."""

    #: the tensors that hold the loop's result (not the kernels' scratch)
    STATE = ("packed", "best_f", "best_i", "best_b", "laux", "leaf_begin", "leaf_count", "order",
             "hist", "small", "small_g", "pool", "large", "large_g", "frec_f", "frec_i", "frec_b",
             "unused_cnt")

    def __init__(self, device: torch.device, N: int, F: int, B: int, num_leaves: int,
                 W: int = 0, G: int = 0, Bg: int = 0, P: int = 0, cegb: bool = False) -> None:
        M = num_leaves
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if P and not 2 <= P <= M:
            raise ValueError("GrowState: a pool of %d slots for %d leaves (2 <= P <= M)" % (P, M))
        self.device, self.N, self.F, self.B, self.M, self.W = device, N, F, B, M, W
        self.G, self.Bg = (G, Bg) if G else (0, 0)
        self.P = P
        i32, f32 = torch.int32, torch.float32
        self.packed = torch.zeros(CTL + 13 * M + W * (M - 1), dtype=i32, device=device)
        (self.ctl, self.node_i, self.leaf_i, self.node_f, self.leaf_f,
         self.node_b) = unpack(self.packed, M, W)
        self.best_f = torch.zeros((M, 9), dtype=f32, device=device)
        self.best_i = torch.zeros((M, 4), dtype=i32, device=device)
        self.best_b = torch.zeros((M, W), dtype=i32, device=device)
        self.laux = torch.zeros((M, 5), dtype=f32, device=device)
        self.leaf_begin = torch.zeros(M, dtype=i32, device=device)
        self.leaf_count = torch.zeros(M, dtype=i32, device=device)
        self.order = torch.zeros(N, dtype=i32, device=device)
        self.hist = torch.zeros((P or M, F, B, 3), dtype=f32, device=device)
        self.small = torch.zeros((2, F, B, 3), dtype=f32, device=device)
        self.pool = torch.zeros(CTL + M + 2 * P if P else 0, dtype=i32, device=device)
        (self.pool_ctl, self.slot_of, self.slot_leaf,
         self.slot_age) = self._pool_views(self.pool)
        self.large = torch.zeros((2 if P else 0, F, B, 3), dtype=f32, device=device)
        self.small_g = torch.zeros((2, self.G, self.Bg, 3), dtype=f32, device=device)
        self.large_g = torch.zeros((2 if P and G else 0, self.G, self.Bg, 3), dtype=f32,
                                   device=device)
        self.scratch = torch.empty(N, dtype=i32, device=device)
        blocks = 1
        if device.type == "cuda":
            sms = torch.cuda.get_device_properties(device).multi_processor_count
            blocks = sms * PICK_PARTITION_BLOCKS_PER_SM
        self.block_left = torch.zeros(blocks, dtype=torch.int64, device=device)
        self.bar = torch.zeros(1, dtype=i32, device=device)
        self.feat_f = torch.empty((2, F, 4), dtype=f32, device=device)
        self.feat_i = torch.empty((2, F, 2), dtype=i32, device=device)
        self.feat_b = torch.empty((2, F, W), dtype=i32, device=device)
        self.leaf_scratch = torch.empty(N, dtype=torch.uint8 if M <= 256 else i32, device=device)
        # forced splits: the step's record
        self.frec_f = torch.zeros(9, dtype=f32, device=device)
        self.frec_i = torch.zeros(4, dtype=i32, device=device)
        self.frec_b = torch.zeros(W, dtype=i32, device=device)
        # CEGB (a state built with cegb=True)
        self.cegb_on = bool(cegb)
        Mc, Fc = (M, F) if cegb else (0, 0)
        self.unused_cnt = torch.zeros((Mc, Fc), dtype=f32, device=device)
        self.feat_f_all = torch.empty((Mc, Fc, 4), dtype=f32, device=device)
        self.feat_i_all = torch.empty((Mc, Fc, 2), dtype=i32, device=device)
        self.feat_b_all = torch.empty((Mc, Fc, W), dtype=i32, device=device)
        self.tickets_all = torch.zeros(Mc, dtype=i32, device=device)
        self.lazy_acc = torch.zeros((2 if cegb else 0, Fc), dtype=i32, device=device)
        self.lazy_ticket = torch.zeros(1 if cegb else 0, dtype=i32, device=device)
        # the inputs of the tree being grown, set by bind()
        self.bins: Optional[torch.Tensor] = None
        self.hist_bins: Optional[torch.Tensor] = None
        self.values: Optional[torch.Tensor] = None
        self.feature_meta: Dict[str, torch.Tensor] = {}
        #: bool [F] with categorical features (W > 0), else None
        self.is_cat: Optional[torch.Tensor] = None
        self.feature_mask: Optional[torch.Tensor] = None
        self.params = None  # ops/split.py SplitParams
        self.two_way = True
        self.max_depth = -1
        self.hist_dtype = "float32"
        #: the histogram entries' grouped form (ops/hist_kernel.py grouped_adds)
        self.grouped = False
        #: the smaller child's histogram is subtracted from a resident
        #: parent's (use_subtract; off needs a pool: P = M without a cap)
        self.subtract = True
        #: launch arguments of each C entry, built once a tree by its wrapper
        self.args: Dict[str, tuple] = {}
        self.stream = None
        #: steps queued since the tree's root (ops/grow.py ``run_step``): the
        #: parity of the next one picks its ``small`` buffer
        self.queued_steps = 0
        #: the training's forced table [K, 3] int32 on the device, or None
        self.forced: Optional[torch.Tensor] = None
        #: the training's CEGB state (:class:`Cegb`), or None
        self.cegb: Optional[Cegb] = None

    def _pool_views(self, pool: torch.Tensor):
        """``pool_ctl``, ``slot_of``, ``slot_leaf`` and ``slot_age`` of a pool
        buffer (empty views without a pool)."""
        P = self.P
        return torch.split(pool, (CTL, self.M, P, P)) if P else (pool,) * 4

    def fits(self, device: torch.device, N: int, F: int, B: int, num_leaves: int, W: int,
             G: int = 0, Bg: int = 0, P: int = 0, cegb: bool = False) -> bool:
        return (self.device, self.N, self.F, self.B, self.M, self.W, self.G, self.Bg,
                self.P, self.cegb_on) == (
                    device, N, F, B, num_leaves, W, G, Bg if G else 0, P, bool(cegb))

    def hist_row(self, leaf: int) -> int:
        """The row of ``hist`` that holds ``leaf``'s histogram (read on the
        host): the leaf itself, or its pool slot."""
        return int(self.slot_of[leaf]) if self.P else int(leaf)

    @property
    def pooled_rescan(self) -> bool:
        """Does the pooled all-leaves rescan own the step's penalised records?
        Under CEGB with a pool: a pooled step's folded scan is the pool's
        unpenalised one (a penalised pooled fold spilled registers in its
        categorical instantiation), and ops/split_kernel.py
        ``split_pair_all`` rescans the step's children under the penalties
        at every step (and the other resident leaves after a first coupled
        payment)."""
        return self.cegb is not None and self.P > 0

    @property
    def rescans_all(self) -> bool:
        """Does each step end with the all-leaves launch? Under a pool's
        CEGB (:attr:`pooled_rescan`), or with coupled penalties (the
        rescan after a first payment)."""
        return self.pooled_rescan or (self.cegb is not None and self.cegb.params.has_coupled)

    @property
    def hist_rows(self) -> int:
        """Rows of the bin matrix the histograms read: G bundled, else F."""
        return self.G or self.F

    @property
    def hist_width(self) -> int:
        """Bins of a histogram row as built: Bg bundled, else B."""
        return self.Bg or self.B

    def hist_out(self, parity: int, large: bool = False) -> torch.Tensor:
        """The buffer step ``parity``'s segment histogram adds into:
        ``small_g[parity]`` bundled, else ``small[parity]``; ``large``, a
        pool's larger child: ``large_g[parity]`` bundled, else
        ``large[parity]``."""
        if large:
            return self.large_g[parity] if self.G else self.large[parity]
        return self.small_g[parity] if self.G else self.small[parity]

    def bind(
        self,
        bins: torch.Tensor,
        hist_bins: torch.Tensor,
        values: torch.Tensor,
        feature_meta: Dict[str, torch.Tensor],
        feature_mask: torch.Tensor,
        params,
        two_way: bool,
        max_depth: int,
        hist_dtype: str,
        grouped: bool = False,
        subtract: bool = True,
        forced: Optional[torch.Tensor] = None,
        cegb: Optional[Cegb] = None,
    ) -> None:
        """Take this tree's inputs and check them once: ``bins`` [R, N]
        uint8 or int16 contiguous (the partition's columns), ``hist_bins`` an
        [R, N] view of the same type with any strides (the histograms'
        rows), R the state's
        :attr:`hist_rows`, ``values`` [N, 3] f32 contiguous, the meta arrays
        int32 [F] and ``feature_mask`` bool [F] contiguous, all on the
        state's device; ``is_categorical`` bool [F] in the meta exactly when
        the state has W > 0, and the EFB plan (``group_id``, ``bin_offset``
        int32 [F]) exactly when it has G > 0. The kernels' launch
        arguments are rebuilt from them on first use and the stream is the
        one current now. ``grouped``: the histograms take their grouped form
        (ops/hist_kernel.py :func:`~.hist_kernel.grouped_adds`).
        ``subtract`` False builds both children of every split from their
        rows (the reference's ``use_subtract=false``), which needs a pool.
        ``forced``: the forced-split table ([K, 3] int32 contiguous on the
        state's device); ``cegb``: the training's :class:`Cegb`, which needs
        a state built with ``cegb=True``."""
        dev, N, F, R = self.device, self.N, self.F, self.hist_rows
        if not subtract and not self.P:
            raise ValueError("grow_tree_device: use_subtract=False needs a state with pool slots "
                             "(P = M for no cap)")
        if ("group_id" in feature_meta) != (self.G > 0):
            raise ValueError("grow_tree_device: a state of %d groups and %s EFB plan"
                             % (self.G, "an" if "group_id" in feature_meta else "no"))
        plan = _PLAN_KEYS if self.G else ()
        if bins.dtype not in BIN_DTYPES:
            raise ValueError("grow_tree_device: bins must be uint8 or int16, got %s" % bins.dtype)
        for name, t, shape, dtype in (
            ("bins", bins, (R, N), bins.dtype),
            ("values", values, (N, 3), torch.float32),
            ("feature_mask", feature_mask, (F,), torch.bool),
            *((k, feature_meta[k], (F,), torch.int32) for k in _META_KEYS + plan),
        ):
            if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(
                    "grow_tree_device: %s must be a contiguous %s %s tensor on %s"
                    % (name, dtype, shape, dev)
                )
        is_cat = feature_meta.get("is_categorical")
        if (is_cat is not None) != (self.W > 0):
            raise ValueError("grow_tree_device: a state of %d membership words and %s "
                             "is_categorical" % (self.W, "an" if is_cat is not None else "no"))
        if is_cat is not None and (is_cat.device != dev or is_cat.dtype != torch.bool
                                   or tuple(is_cat.shape) != (F,) or not is_cat.is_contiguous()):
            raise ValueError("grow_tree_device: is_categorical must be a contiguous bool [%d] "
                             "tensor on %s" % (F, dev))
        if hist_bins.device != dev or hist_bins.dtype != bins.dtype or tuple(hist_bins.shape) != (R, N):
            raise ValueError("grow_tree_device: hist_bins must be an [%d, N] %s view on %s"
                             % (R, bins.dtype, dev))
        if forced is not None and (forced.device != dev or forced.dtype != torch.int32
                                   or forced.dim() != 2 or forced.shape[1] != 3
                                   or not forced.is_contiguous()):
            raise ValueError("grow_tree_device: forced must be a contiguous int32 [K, 3] tensor "
                             "on %s" % dev)
        if cegb is not None:
            if not self.cegb_on:
                raise ValueError("grow_tree_device: CEGB needs a state built with cegb=True")
            if cegb.feature_used.device != dev or cegb.feature_used.shape != (F,) or (
                    cegb.used_in_data is not None and cegb.used_in_data.shape != (N, F)):
                raise ValueError("grow_tree_device: a CEGB state of another shape or device")
        self.forced, self.cegb = forced, cegb
        self.bins, self.hist_bins, self.values = bins, hist_bins, values
        self.feature_meta = {k: feature_meta[k] for k in _META_KEYS + plan}
        self.is_cat = is_cat
        if is_cat is not None:
            self.feature_meta["is_categorical"] = is_cat
        self.feature_mask = feature_mask
        self.params, self.two_way, self.max_depth = params, bool(two_way), int(max_depth)
        self.hist_dtype = hist_dtype
        self.grouped = bool(grouped)
        self.subtract = bool(subtract)
        self.args = {}
        self.stream = torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None
        self.queued_steps = 0

    def reset(self) -> None:
        """Start a tree: one leaf holding every row, no split, the loop
        active. Device fills only (no host-to-device copy)."""
        self.packed.zero_()
        self.ctl[ACTIVE:NUM_LEAVES + 1].fill_(1)
        self.leaf_i[:, 0].fill_(-1)
        self.best_f.zero_()
        self.best_f[:, 0].fill_(-math.inf)
        self.best_i.zero_()
        self.best_b.zero_()
        self.laux.zero_()
        self.laux[:, 3].fill_(-math.inf)
        self.laux[:, 4].fill_(math.inf)
        self.leaf_begin.zero_()
        self.leaf_count.zero_()
        self.leaf_count[:1].fill_(self.N)
        torch.arange(self.N, out=self.order)
        self.small.zero_()
        if self.G:
            self.small_g.zero_()
        if self.cegb_on:
            self.unused_cnt.zero_()
        if self.P:  # the root in slot 0, stamped 1; every other slot free
            self.pool.fill_(-1)
            self.pool_ctl.zero_()
            self.slot_of[:1].zero_()
            self.slot_leaf[:1].zero_()
            self.slot_age.zero_()
            self.slot_age[:1].fill_(1)
            self.large.zero_()
            self.large_g.zero_()

    def clone(self) -> "GrowState":
        """A copy of every tensor of the state with the same bound inputs:
        for running a kernel and its plain version from one state."""
        other = GrowState.__new__(GrowState)
        other.__dict__.update(self.__dict__)
        other.packed = self.packed.clone()
        (other.ctl, other.node_i, other.leaf_i, other.node_f, other.leaf_f,
         other.node_b) = unpack(other.packed, self.M, self.W)
        for name in ("best_f", "best_i", "best_b", "laux", "leaf_begin", "leaf_count", "order",
                     "hist", "small", "small_g", "scratch", "block_left", "bar", "feat_f", "feat_i", "feat_b",
                     "leaf_scratch", "pool", "large", "large_g", "frec_f", "frec_i", "frec_b", "unused_cnt",
                     "feat_f_all", "feat_i_all", "feat_b_all", "tickets_all", "lazy_acc",
                     "lazy_ticket"):
            setattr(other, name, getattr(self, name).clone())
        (other.pool_ctl, other.slot_of, other.slot_leaf,
         other.slot_age) = other._pool_views(other.pool)
        if self.cegb is not None:  # the training's state too, so that the copy runs alone
            other.cegb = Cegb.__new__(Cegb)
            other.cegb.__dict__.update(self.cegb.__dict__)
            other.cegb.feature_used = self.cegb.feature_used.clone()
            if self.cegb.used_in_data is not None:
                other.cegb.used_in_data = self.cegb.used_in_data.clone()
        other.args = {}
        return other
