"""GBDT boosting loop (gbdt.cpp) for the PyTorch port.

Counterpart of lightgbm_tpu/models/gbdt.py for one slice of it: the serial
learner, the objectives of objective.py (K = ``num_model_per_iteration``
trees an iteration: one, or one a class for multiclass and
multiclassova), row bagging and feature_fraction, validation sets,
rollback, f32 or bf16 histogram
operands (``tpu_hist_dtype``), and measured histogram routing: the tune
table named by ``hist_tune`` or LIGHTGBM_TPU_HIST_TUNE is frozen once at
set-up into a ``HistRoute`` (``_resolve_hist_route``). The split loop is
chosen once at set-up too (``grow_loop``): the device-resident loop
(ops/grow.py ``launch_tree``) when that route sends every row class
to ``cuda``, which it always does on CUDA without a table
(``device_loop_routable``); else the host loop (``grow_tree``), which
routes each call. Per iteration: the
boost-from-average init score of each class on the first one
(gbdt.cpp:308-331), objective gradients of every class at the current
scores, then for each class that trains (``class_need_train``) one grown
tree (ops/grow.py), shrinkage, and the score update of its class through
the per-row leaf index (score_updater.hpp:80). Scores live on the training
device as ``[K, N]`` f32; trees stay as host TreeArrays until they are
materialised into model Trees for text output or prediction, K an
iteration in class order.

On the device loop the whole iteration is queued with nothing read back
(``_device_iteration``: the gradients, then each class's tree, shrinkage
and score update on the device, its packed tree copied into a ring row).
On CUDA it is captured once as a CUDA graph (ops/cuda_graph.py) and each
later iteration is one replay; ``train_chunk(n)`` (``device_chunk_size``
= n, the reference's device-resident chunked boosting) queues n replays
and reads the n·K trees back with one copy, bit for bit the trees and
scores of n single iterations. An iteration in which no class split stops
training.

Validation sets (``add_valid``) keep a ``[K, Nv]`` f32 score on the device
and an ``[Nv, F]`` copy of their bins; each tree is added to its class's
row by the bin-space predict kernel (ops/predict_kernel.py,
csrc/predict_bins.cu) inside the device iteration, reading the tree from
the split loop's state, so the captured graph and every replay of a chunk
carry them. The learning rate is a device scalar the iteration reads, so a
per-iteration schedule (``reset_parameter``) replays the same graph. The
bag (``bagging_fraction`` / ``bagging_freq``) is the JAX package's draw, a
function of (``bagging_seed``, iteration) alone (:func:`draw_bag`), drawn
on the device between replays into the buffer the iteration reads, the
same for every class; feature_fraction masks are drawn on the host with
the JAX package's generator and order (iteration-major, class-minor), a
chunk's at once, uploaded in one copy and read by each tree at its ring
slot.

An EFB-bundled training set (scipy input, dataset.py ``_construct_sparse``)
keeps its ``[G, N]`` group matrix on the device and its plan (``group_id``,
``bin_offset``) in the feature meta: the histograms run at the group width
``max_group_bins`` and are remapped into feature space (ops/remap.py), the
partition and both predicts decode each group byte; a validation set must
carry the training set's layout.

The boosting modes (models/goss.py, dart.py, rf.py; basic.py picks the
class from ``boosting``) override the hooks both split loops call:
``_before_train_iter`` and ``_after_train_iter`` around an iteration
(DART's drops and Normalize), ``_prepare_bag`` between replays and
``_bagging`` on the gradients inside the iteration (GOSS's sample),
``_compute_gradients`` and ``_leaf_output`` (random forest's constant
scores and leaves). A mode runs one iteration at a time
(``device_chunk_fallback_reason``), as in the JAX package; an
``average_output`` model (random forest) predicts the average of its trees.

A custom objective's gradients (``train_one_iter(gradients, hessians)``,
no objective) reach the captured iteration through a ``[2, K, N]`` device
buffer that one copy from pinned memory fills before each replay
(``_upload_gradients``); the graph is captured once. Continued training
(``init_model``) puts the predictor's trees in front with no bin-space
copy (``_merge_from``): its init scores already carry them, as the f32
replay ``warmstart_scores`` gives them, and a validation set attached
later replays them from its raw rows (``add_valid``).

Prediction (``predict_raw``, ``predict_leaf_index``, ``predict_contrib``)
walks the host trees' arrays on the model's device: raw scores summed in
f64 in boosting order (with prediction early stopping, the rows past the
margin stop taking trees), SHAP values from the TreeSHAP kernel
(ops/shap_kernel.py). ``merge_models_from`` and ``refit`` re-estimate a
model's leaves on a new training set (``Booster.refit``).

Wide bins: past 256 bins a feature (up to 1024) the training device's bin
copies are int16, half the JAX package's int32, and every kernel of the
device loop runs its int16 instantiation. ``histogram_pool_size`` caps the
device loop's histograms to LRU slots (ops/grow.py); the host loop takes
no pool.

Forced splits (``forcedsplits_filename``, parsed at set-up into the JAX
package's BFS table, kept on the device), CEGB (``cegb_*``: one
ops/grow_state.py ``Cegb`` for the whole training, its paid features and
rows carried across trees, classes, replays and chunks, left as it is by a
rollback) run on the device loop, in the captured iteration and its
chunks (ops/grow.py). So does ``tpu_hist_mode=masked``, the reference's
in-package oracle, which grows the bucketed mode's trees
(tests/test_hist_modes.py): the device loop takes it as a name for the
histograms it builds for ``bucketed``. The host loop takes none of the
three, and CEGB takes no histogram pool.

Every parameter this slice does not implement raises NotImplementedError
naming it, instead of training something else.
"""
from __future__ import annotations

import json
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..dataset import BinnedDataset
from ..metric import Metric
from ..objective import ObjectiveFunction
from ..obs import tune as tune_mod
from ..ops import cuda_graph, grow_state, grow_step_kernel, hist_kernel, predict_kernel, shap_kernel
from ..ops.grow import (
    TreeArrays, device_loop_routable, forced_table, grow_tree, launch_tree, tree_from_packed,
)
from ..ops.histogram import HIST_DTYPES
from ..ops.predict import ensemble_predict_raw, raw_predict_leaf
from ..ops.split import CegbParams, SplitParams, calculate_leaf_output, member_words, num_words
from ..utils import log
from ..utils.vfile import vopen
from .tree import Tree

K_EPSILON = 1e-15
_M32 = 0xFFFFFFFF
#: threefry2x32's rotations, alternating by group of four rounds
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash of 20 rounds (jax/_src/prng.py
    ``_threefry2x32_lowering``) of the count words (``x0``, ``x1``) under
    the key (``k0``, ``k1``). Every word is a uint32 value held in an int64
    tensor or a Python int, masked to 32 bits after each add and shift, so
    the bits are exact and the same on every device."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def draw_permutation(seed: int, iteration: int, n: int, device) -> torch.Tensor:
    """An [n] int64 permutation of ``range(n)``, bit for bit the JAX
    package's ``jax.random.permutation(fold_in(PRNGKey(seed & 0x7FFFFFFF),
    iteration), n)`` under partitionable threefry. The key is (0, seed);
    ``fold_in`` hashes the count (0, iteration) under it; each of the
    ``ceil(3 ln n / ln(2^32 - 1))`` shuffle rounds splits the key (counts
    (0, 0) and (0, 1)), draws the 32-bit word ``x0 ^ x1`` of the count
    (0, i) for each position i, and sorts the order so far by those words,
    stably. The key's words are Python ints, the rows' words int64 tensors
    on ``device``. A function of (``seed``, ``iteration``, ``n``) alone:
    the bag (:func:`draw_bag`) and GOSS's sample (models/goss.py) draw it."""
    key = threefry2x32(0, seed & 0x7FFFFFFF, 0, iteration & _M32)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    count = torch.arange(n, dtype=torch.int64, device=device)
    perm = count
    for _ in range(rounds):
        key, sub = threefry2x32(*key, 0, 0), threefry2x32(*key, 0, 1)
        b0, b1 = threefry2x32(*sub, 0, count)
        perm = perm[torch.sort(b0 ^ b1, stable=True).indices]
    return perm


def draw_bag(seed: int, iteration: int, n: int, bag_cnt: int, device,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The bag of one iteration: an [n] f32 mask with exactly ``bag_cnt``
    ones (gbdt.cpp:179-240 as a mask), bit for bit the JAX package's
    ``_device_bag_mask(fold_in(PRNGKey(seed & 0x7FFFFFFF), iteration), n,
    bag_cnt)``: the first ``bag_cnt`` rows of :func:`draw_permutation`. A
    chunk of n draws the bags of n single iterations. Written into ``out``
    when given."""
    perm = draw_permutation(seed, iteration, n, device)
    if out is None:
        out = torch.empty(n, dtype=torch.float32, device=device)
    out.zero_()
    return out.index_fill_(0, perm[:bag_cnt], 1.0)


def check_supported(config: Config) -> None:
    """Raise NotImplementedError for every parameter this slice does not run."""
    refused = []
    if config.tree_learner != "serial":
        refused.append("tree_learner=%s" % config.tree_learner)
    if config.tpu_hist_mode not in ("bucketed", "masked"):
        refused.append("tpu_hist_mode=%s" % config.tpu_hist_mode)
    if config.tpu_hist_dtype not in HIST_DTYPES:
        refused.append("tpu_hist_dtype=%s" % config.tpu_hist_dtype)
    if refused:
        raise NotImplementedError(
            "not ported to lightgbm_tpu_torch yet: %s" % ", ".join(refused)
        )


def cegb_setup(cfg: Config, train_set: BinnedDataset, device) -> Optional[grow_state.Cegb]:
    """The training's CEGB state (lightgbm_tpu/models/gbdt.py
    ``_setup_cegb``): the penalty vectors, each of one entry a column of the
    raw data (else fatal), taken on the used features; None when no penalty
    is set."""
    F = train_set.num_features
    coupled = list(cfg.cegb_penalty_feature_coupled or [])
    lazy = list(cfg.cegb_penalty_feature_lazy or [])
    for name, vec in (("coupled", coupled), ("lazy", lazy)):
        if vec and len(vec) != train_set.num_total_features:
            log.fatal(
                "cegb_penalty_feature_%s has %d entries but the data has %d "
                "total features" % (name, len(vec), train_set.num_total_features)
            )
    params = CegbParams(tradeoff=cfg.cegb_tradeoff, penalty_split=cfg.cegb_penalty_split,
                        has_coupled=bool(coupled), has_lazy=bool(lazy))
    if not params.enabled:
        return None
    used = train_set.used_feature_idx

    def on_used(vec):
        return np.array([vec[j] for j in used], np.float32) if vec else None

    return grow_state.Cegb(params, F, train_set.num_data, on_used(coupled), on_used(lazy), device)


def parse_forced_splits(cfg: Config, train_set: BinnedDataset) -> tuple:
    """``forcedsplits_filename``'s JSON as the BFS tuple of (leaf, used
    feature, threshold bin) of lightgbm_tpu/models/gbdt.py
    ``_parse_forced_splits`` (ForceSplits, serial_tree_learner.cpp:597): the
    left child keeps the leaf's index and the right child takes the next
    one; a node on an unknown or trivial feature warns and ends the whole
    rest of the BFS."""
    fname = cfg.forcedsplits_filename
    if not fname:
        return ()
    with vopen(fname) as fh:
        root = json.load(fh)
    if not root:
        return ()
    feat_to_used = {j: i for i, j in enumerate(train_set.used_feature_idx)}
    out = []
    queue = [(root, 0)]
    next_leaf = 1
    while queue:
        node, leaf = queue.pop(0)
        f_orig = int(node["feature"])
        thr = float(node["threshold"])
        if f_orig not in feat_to_used:
            log.warning(
                "Forced split on trivial/unknown feature %d aborts the "
                "remaining forced splits" % f_orig
            )
            break
        f_used = feat_to_used[f_orig]
        out.append((leaf, f_used, int(train_set.mappers[f_used].value_to_bin(thr))))
        right_leaf = next_leaf
        next_leaf += 1
        if isinstance(node.get("left"), dict):
            queue.append((node["left"], leaf))
        if isinstance(node.get("right"), dict):
            queue.append((node["right"], right_leaf))
    return tuple(out)


def split_params(cfg: Config) -> SplitParams:
    return SplitParams(
        lambda_l1=cfg.lambda_l1,
        lambda_l2=cfg.lambda_l2,
        max_delta_step=cfg.max_delta_step,
        min_data_in_leaf=cfg.min_data_in_leaf,
        min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf,
        min_gain_to_split=cfg.min_gain_to_split,
        max_cat_to_onehot=cfg.max_cat_to_onehot,
        cat_smooth=cfg.cat_smooth,
        cat_l2=cfg.cat_l2,
        max_cat_threshold=cfg.max_cat_threshold,
        min_data_per_group=cfg.min_data_per_group,
    )


def check_dataset_supported(train_set: BinnedDataset) -> None:
    """Raise NotImplementedError for a binned dataset this slice does not
    train: more than ``hist_kernel.MAX_WIDE_BINS`` (1024) bins a feature
    (``max_bin``: csrc/histogram.cu's int16 cells), or an EFB group of
    more than that many (``enable_bundle``)."""
    if train_set.max_num_bin > hist_kernel.MAX_WIDE_BINS:
        raise NotImplementedError(
            "max_bin: more than %d bins per feature (%d) is not ported to lightgbm_tpu_torch yet"
            % (hist_kernel.MAX_WIDE_BINS, train_set.max_num_bin))
    if train_set.is_bundled and train_set.max_group_bins > hist_kernel.MAX_WIDE_BINS:
        raise NotImplementedError(
            "enable_bundle: an EFB bundle of more than %d bins (%d) is not ported to "
            "lightgbm_tpu_torch yet" % (hist_kernel.MAX_WIDE_BINS, train_set.max_group_bins))


def bin_dtype(num_bins: int) -> np.dtype:
    """The training device's bin type: bytes up to 256 bins a feature, int16
    past them (half the bytes of the JAX package's int32 bins)."""
    return np.dtype(np.uint8 if num_bins <= 256 else np.int16)


def device_bin_dtype(binned: BinnedDataset) -> np.dtype:
    """:func:`bin_dtype` of a binned table's rows as the device holds them:
    a bundled table's from its group width (``max_group_bins``, which may
    pass every member's bins), an unbundled one's from its widest feature.
    The host table keeps the JAX package's types (int32 groups past 256
    bins)."""
    return bin_dtype(binned.max_group_bins)


class GBDT:
    """Gradient Boosting Decision Tree trainer/model (gbdt.h:37-501)."""

    #: the training scores are the plain ordered f32 sum of the stored
    #: trees, so :meth:`warmstart_scores` reproduces them (DART rescales
    #: past trees: False there; random forest is excluded by ``average_output``)
    _carry_is_tree_sum = True

    def __init__(
        self,
        config: Config,
        train_set: Optional[BinnedDataset],
        objective: Optional[ObjectiveFunction],
        training_metrics: Optional[List[Metric]] = None,
        device: torch.device = torch.device("cpu"),
    ) -> None:
        self.config = config
        self.objective = objective
        self.train_set = train_set
        self.training_metrics = training_metrics or []
        self.device = device
        self.iter_ = 0
        self.models: List[Optional[Tree]] = []  # host trees, materialised lazily
        self._tree_arrays: List[Optional[TreeArrays]] = []
        self.num_class = config.num_class
        self.num_tree_per_iteration = (
            objective.num_model_per_iteration if objective is not None else config.num_class)
        self.shrinkage_rate = config.learning_rate
        self.max_feature_idx = 0
        self.label_idx = 0
        self.average_output = False
        self._stopped = False
        self.valid_metrics: List[List[Metric]] = []
        self.valid_names: List[str] = []
        self.valid_scores: List[torch.Tensor] = []  # [K, Nv] f32 each, on the device
        self._valid_bins: List[torch.Tensor] = []  # [Nv, F] each, on the device, as bins_dev
        #: each class's boost-from-average score: in the scores, folded into
        #: the class's first tree's leaf values only when that tree is
        #: materialised
        self._init_fold = [0.0] * self.num_tree_per_iteration
        self._init_readded = False  # a first iteration that did not split re-added it
        if train_set is not None:
            self._setup_train(train_set)

    # ------------------------------------------------------------------
    def _setup_train(self, train_set: BinnedDataset) -> None:
        cfg = self.config
        check_supported(cfg)
        check_dataset_supported(train_set)
        dev = self.device
        K = self.num_tree_per_iteration
        self.num_data = train_set.num_data
        self.max_feature_idx = train_set.num_total_features - 1
        bins = np.ascontiguousarray(train_set.bins, dtype=device_bin_dtype(train_set))
        self.bins_dev = torch.from_numpy(bins).to(dev)
        # [N, F] copy: a row's bins are contiguous for the segment gathers
        self.bins_nf = self.bins_dev.t().contiguous()
        meta = train_set.feature_meta_arrays()
        self.feature_meta = {
            k: torch.as_tensor(meta[k].astype(np.int32), device=dev)
            for k in ("num_bin", "missing_type", "default_bin", "monotone")
        }
        if "is_categorical" in meta:  # its presence is the switch, as in the JAX package
            self.feature_meta["is_categorical"] = torch.as_tensor(meta["is_categorical"], device=dev)
        if train_set.is_bundled:  # the EFB plan; its presence is the switch too
            for k in ("group_id", "bin_offset"):
                self.feature_meta[k] = torch.as_tensor(meta[k].astype(np.int32), device=dev)
        # the dir=+1 scan exists only for missing-value handling
        self._two_way = bool(
            np.any((meta["missing_type"] != 0) & (meta["num_bin"] > 2))
        )
        self.num_bins = int(train_set.max_num_bin)
        #: the histograms' width: the group width of a bundled table
        #: (lightgbm_tpu/models/gbdt.py:155-157), else num_bins
        self.hist_width = int(train_set.max_group_bins) if train_set.is_bundled else self.num_bins
        #: groups of a bundled table (0 unbundled)
        self.num_groups = train_set.num_groups if train_set.is_bundled else 0
        #: membership words a split record and node carry (0 without categorical features)
        self.num_words = num_words(self.num_bins, "is_categorical" in meta)
        #: the histogram kernel's grouped form, for tables with features
        #: whose rows crowd into few bins (one-hot columns)
        self.grouped_adds = hist_kernel.grouped_adds(bins)
        # [ceil(N/2), F] nibble-packed copy that cuda_packed4 reads by row
        # (N * F / 2 bytes), made once here rather than on every call
        self.bins_p4 = hist_kernel.pack_bins(self.bins_nf) if self.hist_width <= 16 else None
        self.hist_route = self._resolve_hist_route()
        extras = [name for name, on in (
            ("forcedsplits_filename", cfg.forcedsplits_filename),
            ("cegb_penalty_*", cfg.cegb_penalty_split != 0.0 or cfg.cegb_penalty_feature_coupled
             or cfg.cegb_penalty_feature_lazy),
            ("tpu_hist_mode=masked", cfg.tpu_hist_mode == "masked")) if on]
        #: "device" (launch_tree) or "host" (grow_tree); a dispatch on
        #: the frozen route, fixed here. Tools that time both loops set it.
        self.grow_loop = "device" if device_loop_routable(
            self.num_data, self.hist_width, cfg.tpu_hist_dtype, self.hist_route, dev,
            needs_device=bool(extras) or self._hist_pool_slots(0) is not None) else "host"
        self._refuse_on_host(extras)
        #: the forced-split preamble (``forcedsplits_filename``): the BFS
        #: table, and as a [K, 3] int32 tensor on the device (None: none)
        self._forced_splits = parse_forced_splits(cfg, train_set)
        self._forced_dev = forced_table(self._forced_splits, dev)
        #: the training's CEGB state (``cegb_*``; None without a penalty)
        self._cegb = cegb_setup(cfg, train_set, dev)
        #: the device loop's histogram pool slots (``histogram_pool_size``),
        #: None for no cap
        self.hist_pool_slots = self._hist_pool_slots()
        self._refuse_on_host(["histogram_pool_size"] if self.hist_pool_slots is not None else [])
        #: on CUDA the device loop replays its iteration as one captured
        #: CUDA graph; tools that time the eager launches set it False
        self.iteration_graph = dev.type == "cuda"
        self._grow_state = None  # the device loop's buffers, kept between trees
        self._ring = None  # [rows, packed] int32: the trees of a chunk, read back at once
        self._ring_host = None  # its pinned host copy (CUDA)
        self._ring_slot = torch.zeros(1, dtype=torch.int64, device=dev)  # the next row
        # set once an iteration of the chunk grew no tree: later ones add zeros
        self._chunk_stopped = torch.zeros(1, dtype=torch.bool, device=dev)
        self._graph = None  # (key, cuda_graph.Graph) of the captured iteration
        self.captures = 0  # graphs captured (a new key captures again)
        #: an iteration of the device loop ran eagerly: its kernels are
        #: built and loaded, so the next one may be captured
        self._warmed = False
        #: the iteration reads a custom objective's gradients (``_grad_buf``)
        self._custom_grads = False
        self._grad_buf = None  # [2, K, N] f32 on the device: gradients, hessians
        self._grad_host = None  # its pinned staging copy (CUDA)
        self._grad_sent = None  # CUDA event: the last upload out of the staging copy is done
        self.feature_mask = torch.ones(train_set.num_features, dtype=torch.bool, device=dev)
        # the iteration reads the learning rate from the device: a schedule
        # replays the same graph
        self._rate_value = float(np.float32(self.shrinkage_rate))
        self._rate = torch.full((1,), self._rate_value, dtype=torch.float32, device=dev)
        # [N] f32 bag mask with bagging (None without), read by both loops
        self._bag = torch.ones(self.num_data, dtype=torch.float32, device=dev) \
            if self._bagging_on() else None
        self._bag_iter = -1  # the iteration whose draw the bag holds
        # feature_fraction: the JAX package's generator and draw order
        self._feat_rng = np.random.RandomState(cfg.feature_fraction_seed & 0x7FFFFFFF)
        self._feature_masks = None  # [ring rows, F] bool: a chunk's masks, read by ring slot
        self._feature_masks_host = None  # their pinned staging copy (CUDA)
        self._masked = False  # a mask was drawn: feature_mask may hold zeros
        self.split_params = split_params(cfg)
        self._has_init_score = train_set.metadata.init_score is not None
        self.scores = self._initial_scores(train_set.metadata.init_score, self.num_data)
        if self.objective is not None:
            self.objective.init(train_set.metadata, self.num_data, dev)
        #: the objective renews each tree's leaf outputs (regression_l1, quantile, mape)
        self._renew = self.objective is not None and self.objective.is_renew_tree_output
        #: the classes that grow trees (class_need_train); an untrained
        #: class keeps a constant tree
        self._train_classes = [k for k in range(K)
                               if self.objective is None or self.objective.class_need_train(k)]
        for m in self.training_metrics:
            m.init(train_set.metadata, self.num_data)

    def _initial_scores(self, init, n: int) -> torch.Tensor:
        """[K, n] f32 scores: the init score (n values, the same for each
        class, or K·n class-major), else zeros."""
        K = self.num_tree_per_iteration
        if init is None:
            return torch.zeros((K, n), dtype=torch.float32, device=self.device)
        arr = np.asarray(init, np.float64).reshape(-1)
        arr = np.tile(arr, (K, 1)) if len(arr) == n else arr.reshape(K, n)
        return torch.as_tensor(arr, dtype=torch.float32, device=self.device)

    def _refuse_on_host(self, names: List[str]) -> None:
        """Raise NotImplementedError naming ``names``, what only the device
        loop grows, when the run takes the host loop."""
        if names and self.grow_loop != "device":
            raise NotImplementedError(
                "%s on the host split loop (a run whose histogram route sends a row class to "
                "another kernel than cuda) is not ported to lightgbm_tpu_torch yet"
                % ", ".join(names))

    def _hist_pool_slots(self, num_forced: Optional[int] = None) -> Optional[int]:
        """histogram_pool_size (MB) -> LRU slots of ``F * B * 3 * 4`` bytes,
        at least 2, or None when that is no fewer than the leaves (the
        SerialTreeLearner ctor, serial_tree_learner.cpp:56-69; the JAX
        package's ``_hist_pool_slots``), at least the forced preamble's K + 2
        (``num_forced`` K, default the run's forced splits)."""
        cfg = self.config
        if cfg.histogram_pool_size <= 0:
            return None
        if num_forced is None:
            num_forced = len(self._forced_splits)
        per_leaf = self.train_set.num_features * self.num_bins * 3 * 4  # f32 sums and count
        slots = int(cfg.histogram_pool_size * 1024 * 1024 / max(per_leaf, 1))
        slots = max(2 + num_forced, slots)
        return slots if slots < cfg.num_leaves else None

    def _resolve_hist_route(self) -> Optional[hist_kernel.HistRoute]:
        """Load and freeze the measured histogram routing table of this run:
        the ``hist_tune`` param (an explicit path; load failures raise), else
        LIGHTGBM_TPU_HIST_TUNE (failures warn once and fall back to default
        routing); ``hist_tune="off"`` disables both. The table is filtered to
        this run's backend and device family, and to impls that serve each
        shape (ops/hist_kernel.py ``resolve_route``)."""
        table, src = tune_mod.active_table(self.config.hist_tune)
        if table is None:
            return None
        return hist_kernel.resolve_route(table, self.device, source=src)

    # ------------------------------------------------------------------
    def _boost_from_average(self, class_id: int) -> float:
        """gbdt.cpp:308-331, for one class."""
        if self.models or self._has_init_score or self.objective is None:
            return 0.0
        if self.config.boost_from_average or self.train_set.num_features == 0:
            init_score = self.objective.boost_from_score(class_id)
            if abs(init_score) > K_EPSILON:
                self._add_constant(init_score, class_id)
                log.info("Start training from score %f" % init_score)
                return init_score
        return 0.0

    def _add_constant(self, value: float, class_id: int) -> None:
        """Add ``value`` (as f32) to the class's training and validation scores."""
        self.scores[class_id] += np.float32(value)
        for score in self.valid_scores:
            score[class_id] += np.float32(value)

    # ------------------------------------------------------------------
    # row bagging and feature_fraction
    # ------------------------------------------------------------------
    def _bagging_on(self) -> bool:
        cfg = self.config
        return cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0

    def _prepare_bag(self, iteration: int) -> None:
        """Make the bag buffer hold iteration ``iteration``'s bag: the draw
        of the last iteration that is a multiple of ``bagging_freq``
        (gbdt.cpp:179-240), queued on the device, and only when the buffer
        holds another draw."""
        if not self._bagging_on():
            return
        cfg = self.config
        want = iteration - iteration % cfg.bagging_freq
        if self._bag is None:
            self._bag = torch.ones(self.num_data, dtype=torch.float32, device=self.device)
        if want != self._bag_iter:
            draw_bag(cfg.bagging_seed, want, self.num_data, int(cfg.bagging_fraction * self.num_data),
                     self.device, out=self._bag)
            self._bag_iter = want

    def _sample_feature_masks(self, n: int) -> Optional[np.ndarray]:
        """The feature_fraction masks of the next ``n`` iterations' trees,
        ``[n * T, F]`` bool for T trained classes, drawn as the JAX package
        draws them (``_sample_features`` / ``_sample_feature_masks``:
        ``choice(F, k, replace=False)`` of one ``RandomState(
        feature_fraction_seed)`` a tree, iteration-major and class-minor);
        None without feature_fraction."""
        cfg = self.config
        if cfg.feature_fraction >= 1.0:
            return None
        F = self.train_set.num_features
        k = max(1, int(cfg.feature_fraction * F))
        masks = np.zeros((n * len(self._train_classes), F), bool)
        for i in range(masks.shape[0]):
            masks[i, self._feat_rng.choice(F, size=k, replace=False)] = True
        self._masked = True
        return masks

    def _compute_gradients(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Boosting() (gbdt.cpp:148): objective gradients and hessians of
        every class at the current scores, [K, N] each."""
        if self.num_tree_per_iteration > 1:
            return self.objective.get_gradients(self.scores)
        grad, hess = self.objective.get_gradients(self.scores[0])
        return grad[None], hess[None]

    def _train_tree(self, grad: torch.Tensor, hess: torch.Tensor):
        """One tree of the host split loop and each row's leaf."""
        cfg = self.config
        return grow_tree(
            self.bins_dev, grad, hess, self.feature_mask, self.feature_meta,
            num_leaves=cfg.num_leaves, max_depth=cfg.max_depth,
            num_bins=self.num_bins, params=self.split_params,
            two_way=self._two_way, bins_nf=self.bins_nf,
            route=self.hist_route, hist_dtype=cfg.tpu_hist_dtype, bins_packed=self.bins_p4,
            bag=self._bag, grouped=self.grouped_adds, num_group_bins=self.hist_width,
        )

    def _set_rate(self) -> None:
        """The device rate scalar to the current ``shrinkage_rate`` (a fill
        only when it changed)."""
        rate = float(np.float32(self.shrinkage_rate))
        if rate != self._rate_value:
            self._rate.fill_(rate)
            self._rate_value = rate

    # ------------------------------------------------------------------
    # the boosting modes' hooks (models/dart.py, goss.py, rf.py override
    # them); both split loops call each, so a mode is written once
    # ------------------------------------------------------------------
    def _before_train_iter(self) -> None:
        """Before an iteration's gradients (DART drops trees here)."""

    def _after_train_iter(self) -> None:
        """After an iteration that did not stop (DART's Normalize)."""

    def _bagging(self, grad: torch.Tensor, hess: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The gradients the trees take, after :meth:`_prepare_bag` (GOSS
        samples and amplifies them here; the bag is drawn before)."""
        return grad, hess

    def _renew_scores(self, k: int) -> torch.Tensor:
        """The scores class ``k``'s leaf renewal reads its residuals at: the
        scores before the tree (random forest: its constant scores)."""
        return self.scores[k]

    def _leaf_output(self, leaf: torch.Tensor, k: int, rate) -> torch.Tensor:
        """The finish step's leaf values (the reference's ``_finish_step``)
        of class ``k``'s tree where it split: its leaf values times
        ``rate``, the device rate scalar inside the iteration or the same
        f32 on the host (:meth:`_shrink`)."""
        return leaf * rate

    def _shrink(self, tree: TreeArrays, k: int) -> TreeArrays:
        """Class ``k``'s tree's host arrays after the finish step: leaf values
        where it split (:meth:`_leaf_output`, else zeros) and internal values
        times the learning rate, the same f32 ops the device finish takes."""
        rate = np.float32(self.shrinkage_rate)
        if int(tree.num_leaves) > 1:
            leaf_value = self._leaf_output(tree.leaf_value, k, rate)
        else:
            leaf_value = torch.zeros_like(tree.leaf_value)
        return tree._replace(leaf_value=leaf_value, internal_value=tree.internal_value * rate)

    # ------------------------------------------------------------------
    # the device loop's iteration: queued whole, captured once on CUDA
    # ------------------------------------------------------------------
    def _device_buffers(self, rows: int) -> None:
        """The split loop's state and a ring of at least ``rows`` packed trees."""
        cfg = self.config
        N, F = self.num_data, self.train_set.num_features
        s = self._grow_state
        shape = (N, F, self.num_bins, cfg.num_leaves, self.num_words, self.num_groups,
                 self.hist_width, self.hist_pool_slots or 0, self._cegb is not None)
        if s is None or not s.fits(self.bins_dev.device, *shape):
            s = self._grow_state = grow_state.GrowState(self.bins_dev.device, *shape)
        if self._ring is None or self._ring.shape[0] < rows or self._ring.shape[1] != s.packed.numel():
            chunk_rows = cfg.device_chunk_size * len(self._train_classes)
            shape = (max(rows, chunk_rows, 1), s.packed.numel())
            self._ring = torch.zeros(shape, dtype=torch.int32, device=self.device)
            if self.device.type == "cuda":
                self._ring_host = torch.empty(shape, dtype=torch.int32, pin_memory=True)
        if cfg.feature_fraction < 1.0 and (
                self._feature_masks is None or self._feature_masks.shape[0] != self._ring.shape[0]):
            self._feature_masks = torch.ones((self._ring.shape[0], F), dtype=torch.bool,
                                             device=self.device)
            if self.device.type == "cuda":  # the staging copy of an upload without a sync
                self._feature_masks_host = torch.empty(self._feature_masks.shape, dtype=torch.bool,
                                                       pin_memory=True)

    def _device_iteration(self) -> None:
        """Queue one boosting iteration on the device loop, reading nothing
        back: the gradients of every class at the current scores, then for
        each trained class its tree (ops/grow.py ``launch_tree``, one state
        serving the classes in stream order), the shrinkage and the score
        update of its class on the device (each row's leaf value added from
        the loop's segment layout, ops/grow_step_kernel.py
        ``score_update``), the tree copied into the ring's next row. The
        reference's chunked scan body (``_chunk_fn``, ``_finish_step``): a
        tree that did not split, and every tree after an iteration of the
        chunk in which no class split (``_chunk_stopped``), adds exact zeros;
        the score update is a plain f32 add, never a multiply-add. With
        feature_fraction each tree first copies its mask out of the chunk's
        masks at its ring slot; with bagging every tree reads the bag
        buffer; each validation set's class score takes the same values
        through the predict kernel, which reads the tree from the state."""
        cfg = self.config
        s = self._grow_state
        grad, hess = self._bagging(*(self._grad_buf if self._custom_grads
                                     else self._compute_gradients()))
        grew_any = None
        for k in self._train_classes:
            if self._feature_masks is not None:
                self.feature_mask.copy_(self._feature_masks.index_select(0, self._ring_slot)[0])
            launch_tree(s, self.bins_dev, grad[k], hess[k], self.feature_mask, self.feature_meta,
                        cfg.max_depth, self.split_params, self._two_way, self.bins_nf,
                        cfg.tpu_hist_dtype, self._bag, self.grouped_adds,
                        forced=self._forced_dev, cegb=self._cegb)
            num_leaves = s.ctl[grow_state.NUM_LEAVES:grow_state.NUM_LEAVES + 1]
            grew = num_leaves > 1
            if self._renew:  # RenewTreeOutput, before the ring copy reads the leaf values
                s.leaf_f[:, 0].copy_(self.objective.renew_leaf_outputs(
                    self._renew_scores(k), grow_step_kernel.leaf_ids(s), self._bag, s.M,
                    s.leaf_f[:, 0]))
            value = torch.where(grew & ~self._chunk_stopped,
                                self._leaf_output(s.leaf_f[:, 0], k, self._rate), 0.0)
            grow_step_kernel.score_update(s, value, self.scores[k])
            for bins, score in zip(self._valid_bins, self.valid_scores):
                predict_kernel.add_tree_value(bins, s.node_i[:s.M - 1], num_leaves,
                                              self.feature_meta, value, score[k], node_b=s.node_b)
            grew_any = grew if grew_any is None else grew_any | grew
            self._ring.index_copy_(0, self._ring_slot, s.packed[None])
            self._ring_slot += 1
        self._chunk_stopped |= ~grew_any

    def _iteration_key(self) -> tuple:
        """What the captured iteration bakes in (the reference's ``_chunk_fn``
        cache key): a change of any of it captures again."""
        cfg = self.config
        return (self.num_data, self.bins_dev.shape[0], self.num_bins, cfg.num_leaves,
                cfg.max_depth, self.split_params, self._two_way, cfg.tpu_hist_dtype,
                self.num_tree_per_iteration, tuple(self._train_classes),
                id(self._grow_state), id(self._ring), id(self.scores), id(self._bag),
                id(self._feature_masks), tuple(map(id, self.valid_scores)),
                tuple(map(id, self._valid_bins)), self._custom_grads, id(self._grad_buf),
                id(self._forced_dev), id(self._cegb), self.device)

    def _captured_iteration(self) -> cuda_graph.Graph:
        key = self._iteration_key()
        if self._graph is None or self._graph[0] != key:
            self._graph = None  # the old graph's memory goes first
            graph = cuda_graph.Graph(self._device_iteration, self.device)
            self.captures += 1
            # the buffers the key names by id stay alive as long as the graph
            self._graph = (key, graph, (self._grow_state, self._ring, self.scores, self._bag,
                                        self._feature_masks, list(self.valid_scores),
                                        list(self._valid_bins), self._grad_buf))
        return self._graph[1]

    def launch_iterations(self, n: int, eager: bool = False) -> None:
        """Queue ``n`` iterations of the device loop, reading nothing back:
        the ring and the stop flag reset on the device, the chunk's
        feature_fraction masks uploaded in one copy, then ``n`` replays of
        the captured iteration (CUDA with ``iteration_graph``; captured at
        the first call) or ``n`` eager iterations (``eager``, the CPU, or
        ``iteration_graph`` False), each after its bag is drawn on the
        device when it changes. The first iteration this GBDT runs is eager
        (it builds and loads the kernels a capture must not).
        :meth:`collect_iterations` reads the trees back."""
        rows = n * len(self._train_classes)
        self._device_buffers(rows)
        self._ring_slot.zero_()
        self._chunk_stopped.zero_()
        self._set_rate()
        masks = self._sample_feature_masks(n)
        if masks is not None:
            if self.device.type == "cuda":
                # the last chunk's upload is done: its readback waited for every replay
                self._feature_masks_host[:rows].numpy()[:] = masks
                self._feature_masks[:rows].copy_(self._feature_masks_host[:rows], non_blocking=True)
            else:
                self._feature_masks[:rows].copy_(torch.from_numpy(masks))
        for i in range(n):
            self._prepare_bag(self.iter_ + i)
            if not eager and self._warmed and self.iteration_graph:
                self._captured_iteration().replay()
            else:
                self._device_iteration()
                self._warmed = True

    def collect_iterations(self, n: int) -> List[TreeArrays]:
        """The ``n`` iterations' trees of the last :meth:`launch_iterations`
        (one a trained class, in iteration and class order), shrunk, from
        one device-to-host copy of the ring (on CUDA into pinned memory,
        waited for on an event: no synchronizing call)."""
        rows = n * len(self._train_classes)
        if self.device.type == "cuda":
            host = self._ring_host[:rows]
            host.copy_(self._ring[:rows], non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            done.synchronize()
            host = host.clone()  # the pinned ring is refilled by the next chunk
        else:
            host = self._ring[:rows].clone()
        M, B, T = self.config.num_leaves, self.num_bins, len(self._train_classes)
        return [self._shrink(tree_from_packed(host[i], M, B, self.num_words), self._train_classes[i % T])
                for i in range(rows)]

    def _append_iteration(self, grown: dict) -> None:
        """Append one iteration's K trees in class order: each trained
        class's shrunk tree (``grown``, by class), else a constant tree, on
        the first iteration the class's ``boost_from_score``, added to its
        scores (gbdt.cpp:375-400), later a zero one."""
        first = not self.models
        for k in range(self.num_tree_per_iteration):
            if k in grown:
                self.models.append(None)
                self._tree_arrays.append(grown[k])
                continue
            t = Tree(1)
            if first:
                t.leaf_value[0] = self.objective.boost_from_score(k)
                if t.leaf_value[0] != 0.0:
                    self._add_constant(t.leaf_value[0], k)
            self.models.append(t)
            self._tree_arrays.append(None)

    def _keep_trees(self, trees: List[TreeArrays]) -> bool:
        """Append the shrunk trees of iterations run in order (one a trained
        class an iteration); at the first iteration in which no class split,
        drop it and every later one, warn and stop (the reference's
        ``_consume_pending_stop``): those later iterations added exact zeros
        to the scores. Returns True on a stop. A first iteration in which no
        class splits keeps its trees (constant, each holding its class's init
        score when materialised) and re-adds the init scores
        (gbdt.cpp:375-395)."""
        T = len(self._train_classes)
        for i in range(0, len(trees), T):
            grown = dict(zip(self._train_classes, trees[i:i + T]))
            if not any(int(t.num_leaves) > 1 for t in grown.values()):
                log.warning("Stopped training because there are no more leaves that meet the split requirements")
                self._stopped = True
                if not self.models:
                    self._append_iteration(grown)
                    for k in self._train_classes:
                        if abs(self._init_fold[k]) > K_EPSILON:
                            self._add_constant(self._init_fold[k], k)
                    self._init_readded = True
                return True
            self._append_iteration(grown)
            self.iter_ += 1
        return False

    def train_one_iter(self, gradients: Optional[np.ndarray] = None,
                       hessians: Optional[np.ndarray] = None) -> bool:
        """One boosting iteration; returns True when training should stop
        because no class's tree could split (TrainOneIter, gbdt.cpp:332-413).
        On the device loop the first iteration runs eagerly (it builds and
        loads the kernels, and folds the boost-from-average scores); on CUDA
        every later one is one replay of the captured iteration, and one
        device-to-host copy reads its trees back.

        ``gradients`` and ``hessians`` (``[N]`` or class-major ``[K·N]``,
        a custom objective's) replace the objective's, as in the JAX
        package: no boost from average and no ``_before_train_iter`` then.
        The device loop reads them from one device buffer that a single
        copy from pinned memory fills before the iteration (or its replay)
        is queued (:meth:`_upload_gradients`)."""
        if self._stopped:
            return True
        K = self.num_tree_per_iteration
        first = not self.models
        custom = gradients is not None and hessians is not None
        if custom:
            init_scores = [0.0] * K
        else:
            init_scores = [self._boost_from_average(k) for k in range(K)]
            self._before_train_iter()
        if not self._train_classes or self.train_set.num_features == 0:
            # nothing to learn: one constant tree a class, then stop (gbdt.cpp:375-400)
            if first:
                for k in range(K):
                    need = self.objective is None or self.objective.class_need_train(k)
                    t = Tree(1)
                    t.leaf_value[0] = init_scores[k] if need else self.objective.boost_from_score(k)
                    self.models.append(t)
                    self._tree_arrays.append(None)
                    if t.leaf_value[0] != 0.0:
                        self._add_constant(t.leaf_value[0], k)
            log.warning("Stopped training because there are no more leaves that meet the split requirements")
            self._stopped = True
            return True
        if first:
            self._init_fold = init_scores
        if self.grow_loop == "device":
            if custom:
                self._upload_gradients(gradients, hessians)
            self._custom_grads = custom
            self.launch_iterations(1, eager=first)
            trees = self.collect_iterations(1)
        else:
            self._prepare_bag(self.iter_)
            masks = self._sample_feature_masks(1)
            grad, hess = self._bagging(*(self._host_gradients(gradients, hessians) if custom
                                         else self._compute_gradients()))
            trees = []
            for t, k in enumerate(self._train_classes):
                if masks is not None:
                    self.feature_mask.copy_(torch.from_numpy(masks[t]))
                tree, leaf_id = self._train_tree(grad[k], hess[k])
                if self._renew:  # RenewTreeOutput at the scores before the tree
                    tree = tree._replace(leaf_value=self.objective.renew_leaf_outputs(
                        self._renew_scores(k), leaf_id, self._bag, self.config.num_leaves,
                        tree.leaf_value.to(self.device)).cpu())
                tree = self._shrink(tree, k)
                # shrinkage + score update (gbdt.cpp:375-413): plain f32 adds of
                # the shrunk leaf values gathered by each row's leaf
                self.scores[k] += tree.leaf_value.to(self.device)[leaf_id]
                for bins, score in zip(self._valid_bins, self.valid_scores):
                    self._add_tree(tree, bins, score[k])
                trees.append(tree)
        if self._keep_trees(trees):
            return True  # a stop skips the hook, as the reference returns before it
        self._after_train_iter()
        return False

    def _host_gradients(self, gradients, hessians) -> Tuple[torch.Tensor, torch.Tensor]:
        """A custom objective's gradients and hessians as [K, N] f32 on the device."""
        shape = (self.num_tree_per_iteration, self.num_data)
        return tuple(torch.as_tensor(np.asarray(a, np.float32).reshape(shape), device=self.device)
                     for a in (gradients, hessians))

    def _upload_gradients(self, gradients, hessians) -> None:
        """Write a custom objective's gradients and hessians into the [2, K, N]
        f32 device buffer the device iteration reads: on CUDA one
        host-to-device copy out of a pinned staging buffer, queued on the
        current stream before the iteration (the replay follows it on the
        same stream); the staging buffer is written only after the last copy
        out of it is done (an event)."""
        K, N = self.num_tree_per_iteration, self.num_data
        if self._grad_buf is None:
            self._grad_buf = torch.empty((2, K, N), dtype=torch.float32, device=self.device)
            if self.device.type == "cuda":
                self._grad_host = torch.empty((2, K, N), dtype=torch.float32, pin_memory=True)
                self._grad_sent = torch.cuda.Event()
        if self.device.type != "cuda":
            self._grad_buf.copy_(torch.from_numpy(np.stack([
                np.asarray(gradients, np.float32).reshape(K, N),
                np.asarray(hessians, np.float32).reshape(K, N)])))
            return
        self._grad_sent.synchronize()
        host = self._grad_host.numpy()
        host[0] = np.asarray(gradients, np.float32).reshape(K, N)
        host[1] = np.asarray(hessians, np.float32).reshape(K, N)
        self._grad_buf.copy_(self._grad_host, non_blocking=True)
        self._grad_sent.record(torch.cuda.current_stream(self.device))

    # ------------------------------------------------------------------
    # device-resident chunked boosting (the reference's train_chunk)
    # ------------------------------------------------------------------
    def device_chunk_fallback_reason(self) -> Optional[str]:
        """Why :meth:`train_chunk` must run iterations one at a time (None:
        the chunked device loop can run). The reference's reasons that
        apply to the port, and its own: the host split loop."""
        if self.config.device_chunk_size <= 1:
            return "device_chunk_size <= 1"
        if type(self) is not GBDT:
            return "%s overrides per-iteration hooks" % type(self).__name__
        if self.objective is None:
            return "no objective (host-computed gradients)"
        if self.train_set is None or self.train_set.num_features == 0:
            return "no usable features (constant-tree path is host-side)"
        if len(self._train_classes) < self.num_tree_per_iteration:
            return "untrained constant class (class_need_train=False)"
        if self.grow_loop != "device":
            return ("the host split loop: the histogram route sends a row class to a kernel "
                    "the device loop does not launch")
        return None

    def device_chunk(self) -> int:
        """The chunk the engine steps by (1 when a fallback reason exists)."""
        if self.device_chunk_fallback_reason() is not None:
            return 1
        return self.config.device_chunk_size

    def train_chunk(self, n: int) -> Tuple[int, bool]:
        """Run up to ``n`` boosting iterations; returns (iterations run,
        stopped). With no fallback reason and ``n > 1``: the first iteration
        of a training runs alone (:meth:`train_one_iter`: boost from
        average, init-score folding); otherwise the ``n`` iterations are
        queued as ``n`` replays of the captured iteration (eager iterations
        on the CPU) with nothing read back in between, then one copy reads
        their trees back. The stop is resolved here: the trees from the first
        iteration in which no class split on are dropped (they added exact
        zeros to the scores), so trees and scores equal those of ``n`` calls
        of :meth:`train_one_iter` bit for bit."""
        if n <= 1 or self.device_chunk_fallback_reason() is not None:
            return 1, self.train_one_iter()
        if self._stopped:
            return 0, True
        if not self.models:
            return 1, self.train_one_iter()
        self._custom_grads = False
        self.launch_iterations(n)
        return n, self._keep_trees(self.collect_iterations(n))

    # ------------------------------------------------------------------
    # validation sets, rollback
    # ------------------------------------------------------------------
    def _add_tree(self, tree: TreeArrays, bins: torch.Tensor, score: torch.Tensor,
                  sign: float = 1.0) -> None:
        """``score[r] += sign * leaf_value[leaf(r)]`` for the host TreeArrays
        ``tree`` over the [N, F] ``bins`` (ops/predict_kernel.py: the kernel
        on the card, its plain version on the CPU)."""
        nl = int(tree.num_leaves)
        nodes = torch.stack([tree.split_feature, tree.threshold_bin, tree.left_child,
                             tree.right_child, tree.default_left.to(torch.int32)], 1)
        nodes = nodes[:max(nl - 1, 0)].to(device=self.device, dtype=torch.int32).contiguous()
        node_b = member_words(tree.cat_member[:max(nl - 1, 0)], self.num_words).to(self.device)
        value = (tree.leaf_value * sign).to(self.device)
        num_leaves = torch.tensor([nl], dtype=torch.int32, device=self.device)
        predict_kernel.add_tree_value(bins, nodes, num_leaves, self.feature_meta, value, score,
                                      node_b=node_b)

    def add_valid(self, valid_set: BinnedDataset, metrics: List[Metric], name: str,
                  raw_data=None) -> None:
        """Attach an eval set binned with the training set's mappers: its
        metrics initialised on its metadata, a [K, Nv] f32 score on the
        device (its init score, else zeros) into which the trees trained so
        far are added in order, each into its class's row, as the live score
        took them (the reference's ScoreUpdater on AddValidDataset), and an
        [Nv, F] copy of its bins ([Nv, G] in a bundled training set's
        layout: the set must carry the same groups and offsets). The next
        iteration captures its graph again with the set's buffers.

        A model that holds trees with no bin-space copy (loaded from text,
        or an ``init_model``'s, merged in front) replays every tree from
        the set's raw rows instead, as the JAX package does: ``raw_data``
        (the [Nv, F] f64 rows, or a callable giving them) through
        :meth:`warmstart_scores`, the parent's carry bit for bit, else
        (random forest, DART) the f64 :meth:`predict_raw` rounded once."""
        tr = self.train_set
        if tr is not None:
            same_layout = valid_set.is_bundled == tr.is_bundled and (not tr.is_bundled or (
                valid_set.num_groups == tr.num_groups
                and np.array_equal(valid_set.group_id, tr.group_id)
                and np.array_equal(valid_set.bin_offset, tr.bin_offset)))
            if valid_set.num_features != tr.num_features or not same_layout:
                raise ValueError("a validation set must be binned with the training set's mappers "
                                 "and bundles (Dataset(..., reference=train_set))")
        for m in metrics:
            m.init(valid_set.metadata, valid_set.num_data)
        K = self.num_tree_per_iteration
        bins = torch.from_numpy(np.ascontiguousarray(
            valid_set.bins.T, dtype=device_bin_dtype(valid_set))).to(self.device)
        score = self._initial_scores(valid_set.metadata.init_score, valid_set.num_data)
        if any(ta is None and t is not None and t.num_leaves > 1
               for ta, t in zip(self._tree_arrays, self.models)):
            raw = raw_data() if callable(raw_data) else raw_data
            if raw is None:
                log.fatal("add_valid on a model with trees loaded from text needs the "
                          "validation set's raw rows")
            raw = np.asarray(raw, np.float64)
            ws = self.warmstart_scores(raw)
            if ws is None:
                pred = self.predict_raw(raw)
                ws = torch.as_tensor(pred.T if pred.ndim == 2 else pred[None],
                                     dtype=torch.float32, device=self.device)
            else:
                ws = torch.as_tensor(ws, device=self.device)
            self._append_valid(metrics, name, score + ws, bins)
            return
        for k in range(K):
            if abs(self._init_fold[k]) > K_EPSILON:
                score[k] += np.float32(self._init_fold[k])
        for i, ta in enumerate(self._tree_arrays):
            if ta is not None:
                self._add_tree(ta, bins, score[i % K])
            elif self.models[i] is not None and self.models[i].num_leaves == 1:
                if self.models[i].leaf_value[0] != 0.0:
                    score[i % K] += np.float32(self.models[i].leaf_value[0])
        if self._init_readded:
            for k in range(K):
                score[k] += np.float32(self._init_fold[k])
        self._append_valid(metrics, name, score, bins)

    def _append_valid(self, metrics: List[Metric], name: str, score: torch.Tensor,
                      bins: torch.Tensor) -> None:
        self.valid_metrics.append(metrics)
        self.valid_names.append(name)
        self.valid_scores.append(score)
        self._valid_bins.append(bins)

    def _score_np(self, score: torch.Tensor) -> np.ndarray:
        """A [K, n] f32 score as f64 numpy (one copy down): [n] when K is 1."""
        s = score.cpu().numpy().astype(np.float64)
        return s[0] if self.num_tree_per_iteration == 1 else s

    def _valid_score_np(self, i: int) -> np.ndarray:
        return self._score_np(self.valid_scores[i])

    def eval_valid(self) -> List[Tuple[str, str, float, bool]]:
        """(set name, metric name, value, bigger is better) of every
        validation set's metrics, in the order they were attached."""
        out = []
        for i, name in enumerate(self.valid_names):
            score = self._valid_score_np(i)
            for m in self.valid_metrics[i]:
                out.extend((name, mname, val, bigger)
                           for mname, val, bigger in m.eval(score, self.objective))
        return out

    def rollback_one_iter(self) -> None:
        """RollbackOneIter (gbdt.cpp:415-431): the last iteration's K trees
        taken out of their classes' training and validation scores, through
        each row's leaf in bin space, and dropped; the first iteration takes
        the boost-from-average scores with it."""
        if self.iter_ <= 0:
            return
        K = self.num_tree_per_iteration
        for k in range(K):
            tree = self._tree_arrays[len(self._tree_arrays) - K + k]
            if tree is not None:
                self._add_tree(tree, self.bins_nf, self.scores[k], -1.0)
                for bins, score in zip(self._valid_bins, self.valid_scores):
                    self._add_tree(tree, bins, score[k], -1.0)
        if len(self.models) == K:
            for k in range(K):
                if abs(self._init_fold[k]) > K_EPSILON:
                    self._add_constant(-self._init_fold[k], k)
            self._init_fold = [0.0] * K
        del self.models[-K:], self._tree_arrays[-K:]
        self.iter_ -= 1

    def reset_parameter(self, params) -> None:
        """The reset_parameter callback's path (ResetConfig): the config
        updated; the learning rate takes effect at the next iteration through
        the device rate scalar, with no new capture. A change of the split
        parameters, or bagging or feature_fraction turned off, captures the
        iteration again."""
        self.config = self.config.update(params)
        check_supported(self.config)
        self.shrinkage_rate = self.config.learning_rate
        self.split_params = split_params(self.config)
        if not self._bagging_on():
            self._bag, self._bag_iter = None, -1
        if self.config.feature_fraction >= 1.0 and self._masked:
            self._feature_masks = self._feature_masks_host = None
            self.feature_mask.fill_(True)
            self._masked = False

    def _fold_init_into_trees(self) -> None:
        """Fold each class's boost-from-average score into its first tree's
        host arrays now (the JAX package stores it there), no longer at
        materialisation: DART before it rescales the first trees, and
        :meth:`shuffle_models` before the first trees move."""
        K = self.num_tree_per_iteration
        if not any(abs(v) > K_EPSILON for v in self._init_fold):
            return
        for k in range(K):
            ta = self._tree_arrays[k]
            if ta is not None and abs(self._init_fold[k]) > K_EPSILON:
                self._tree_arrays[k] = ta._replace(leaf_value=ta.leaf_value + np.float32(self._init_fold[k]))
        self._init_fold = [0.0] * K

    # ------------------------------------------------------------------
    # continued training and the model's tree order
    # ------------------------------------------------------------------
    def warmstart_scores(self, X: np.ndarray) -> Optional[np.ndarray]:
        """Raw scores of the rows ``X`` as ``[K, N]`` f32 numpy, added one
        tree at a time in f32 in boosting order on the model's device: the
        adds the training score carry made, so an ``init_model`` run seeded
        with them continues the parent's carry bit for bit (the JAX
        package's ``warmstart_scores``). None when the carry is not that
        sum (random forest's average, DART's rescaled trees): callers take
        the f64 :meth:`predict_raw` then."""
        if self.average_output or not self._carry_is_tree_sum:
            return None
        self._materialize()
        K = max(self.num_tree_per_iteration, 1)
        Xt = torch.as_tensor(np.asarray(X, np.float64), device=self.device)
        out = torch.zeros((K, Xt.shape[0]), dtype=torch.float32, device=self.device)
        for i, t in enumerate(self.models):
            values = torch.as_tensor(t.leaf_value, dtype=torch.float32, device=self.device)
            out[i % K] += values[raw_predict_leaf(Xt, t)] if t.num_leaves > 1 else values[0]
        return out.cpu().numpy()

    def _merge_from(self, other: "GBDT") -> None:
        """Continued training (``init_model``, lightgbm_tpu/models/gbdt.py
        ``_merge_from``): the predictor's trees go in front (with no
        bin-space copy; the init scores already carry them), and the run
        continues the parent's random streams: the bag's iteration index
        past the merged iterations, the feature_fraction generator past the
        draws the parent made (one a trained class an iteration)."""
        other._materialize()
        self.models = list(other.models) + self.models
        self._tree_arrays = [None] * len(other.models) + self._tree_arrays
        self.num_init_iteration = len(other.models) // max(other.num_tree_per_iteration, 1)
        self.iter_ = self.num_init_iteration
        if self.config.feature_fraction < 1.0 and self.train_set is not None \
                and self.train_set.num_features > 0:
            self._sample_feature_masks(self.num_init_iteration)
            self._masked = False

    def shuffle_models(self, start_iter: int = 0, end_iter: int = -1) -> None:
        """Shuffle the order of the iterations in [start, end) (GBDT::ShuffleModels):
        whole iterations move, by the JAX package's ``RandomState(seed)``
        permutation."""
        self._materialize()
        self._fold_init_into_trees()
        K = self.num_tree_per_iteration
        n_iter = len(self.models) // K
        if end_iter < 0 or end_iter > n_iter:
            end_iter = n_iter
        start_iter = max(0, start_iter)
        if end_iter - start_iter <= 1:
            return
        perm = np.arange(start_iter, end_iter)
        np.random.RandomState(self.config.seed & 0x7FFFFFFF).shuffle(perm)
        models, arrays = list(self.models), list(self._tree_arrays)
        for dst, src in enumerate(perm, start=start_iter):
            for k in range(K):
                models[dst * K + k] = self.models[src * K + k]
                arrays[dst * K + k] = self._tree_arrays[src * K + k]
        self.models, self._tree_arrays = models, arrays

    # ------------------------------------------------------------------
    def _materialize(self) -> None:
        K = self.num_tree_per_iteration
        for i, ta in enumerate(self._tree_arrays):
            if self.models[i] is None:
                if i < K and abs(self._init_fold[i]) > K_EPSILON:
                    ta = ta._replace(leaf_value=ta.leaf_value + np.float32(self._init_fold[i]))
                self.models[i] = Tree.from_device(ta, self.train_set)
                self.models[i].shrinkage = self.shrinkage_rate

    def num_trees(self) -> int:
        return len(self.models)

    @property
    def current_iteration(self) -> int:
        return len(self.models) // max(self.num_tree_per_iteration, 1)

    def trees(self) -> List[Tree]:
        self._materialize()
        return self.models

    def train_score(self) -> np.ndarray:
        return self._score_np(self.scores)

    def _used_trees(self, num_iteration: Optional[int]) -> int:
        """The trees of the first ``num_iteration`` iterations (all when it is
        None or <= 0)."""
        use = len(self.models)
        if num_iteration is not None and num_iteration > 0:
            use = min(use, num_iteration * self.num_tree_per_iteration)
        return use

    def predict_raw(self, X: np.ndarray, num_iteration: int = -1,
                    early_stop=None) -> np.ndarray:
        """Raw scores, [N] or [N, K] for K trees an iteration (PredictRaw,
        gbdt_prediction.cpp:13-51), each class's trees summed in f64 in
        boosting order on the model's device; an ``average_output`` model
        (random forest) divides the sums by the iterations used, as the JAX
        package does (lightgbm_tpu/models/gbdt.py ``predict_raw``).

        ``early_stop`` (prediction_early_stop.py): every ``round_period``
        iterations the rows whose margin passed the threshold stop taking
        trees; the others go on from their running sums, so a row never
        stopped gets the bits of the full sum."""
        self._materialize()
        use = self._used_trees(num_iteration)
        K = self.num_tree_per_iteration
        Xt = torch.as_tensor(np.asarray(X, np.float64), device=self.device)
        if early_stop is None or early_stop.round_period >= (use + K - 1) // K:
            out = torch.stack([ensemble_predict_raw(Xt, self.models[k:use:K]) for k in range(K)])
        else:
            out = torch.zeros((K, Xt.shape[0]), dtype=torch.float64, device=self.device)
            active = torch.arange(Xt.shape[0], device=self.device)
            Xa, outa, counter = Xt, out.clone(), 0
            for it in range(-(-use // K)):
                for k in range(min(K, use - it * K)):
                    ensemble_predict_raw(Xa, [self.models[it * K + k]], outa[k])
                counter += 1
                if counter == early_stop.round_period:
                    out[:, active] = outa
                    keep = ~early_stop.callback(outa.t())
                    active, Xa, outa, counter = active[keep], Xa[keep], outa[:, keep], 0
                    if active.numel() == 0:
                        break
            out[:, active] = outa
        out = out.cpu().numpy()
        if self.average_output and use > 0:
            out = out / max(use // K, 1)
        return out[0] if K == 1 else out.T

    def predict_leaf_index(self, X: np.ndarray, num_iteration: int = -1) -> np.ndarray:
        """[N, T] int32: each row's leaf in each of the first trees
        (``num_iteration`` as in ``predict_raw``), walked on the model's
        device (lightgbm_tpu/models/gbdt.py ``predict_leaf_index``)."""
        self._materialize()
        use = self._used_trees(num_iteration)
        Xt = torch.as_tensor(np.asarray(X, np.float64), device=self.device)
        out = np.zeros((Xt.shape[0], use), np.int32)
        for i in range(use):
            out[:, i] = raw_predict_leaf(Xt, self.models[i]).cpu().numpy()
        return out

    def predict(self, X: np.ndarray, num_iteration: int = -1, raw_score: bool = False,
                early_stop=None) -> np.ndarray:
        raw = self.predict_raw(X, num_iteration, early_stop=early_stop)
        if raw_score or self.objective is None:
            return raw
        return self.objective.convert_output(raw)

    def predict_contrib(self, X: np.ndarray, num_iteration: int = -1) -> np.ndarray:
        """SHAP feature contributions (GBDT::PredictContrib), computed on the
        model's device by the TreeSHAP kernel (ops/shap_kernel.py; its plain
        version on the CPU): [N, F + 1], or [N, K·(F + 1)] for K trees an
        iteration with each class's expected value last in its block; an
        ``average_output`` model divides by the iterations used. Each row
        sums to the raw score (lightgbm_tpu/models/gbdt.py ``predict_contrib``)."""
        self._materialize()
        use = self._used_trees(num_iteration)
        K = self.num_tree_per_iteration
        F = self.max_feature_idx + 1
        Xt = torch.as_tensor(np.ascontiguousarray(X, np.float64), device=self.device)
        ens = shap_kernel.shap_trees(self.models[:use], self.device)
        out = shap_kernel.tree_shap(Xt, ens, K, F).cpu().numpy()
        if self.average_output and use > 0:
            out /= max(use // K, 1)
        if K == 1:
            return out[0]
        return out.transpose(1, 0, 2).reshape(Xt.shape[0], K * (F + 1))

    # ------------------------------------------------------------------
    # refit (Booster.refit): the trees' structure kept, their leaves re-estimated
    # ------------------------------------------------------------------
    def merge_models_from(self, other: "GBDT") -> None:
        """Append copies of ``other``'s trees to this trainer's (GBDT::MergeFrom,
        lightgbm_tpu/models/gbdt.py ``merge_models_from``); a trainer with no
        trees yet takes ``other``'s learning rate and ``average_output`` too.
        The trees carry no bin-space copy: refit rebuilds the scores itself."""
        import copy

        other._materialize()
        if not self.models:
            self.shrinkage_rate = other.shrinkage_rate
            self.average_output = other.average_output
        self.models = self.models + [copy.deepcopy(t) for t in other.models]
        self._tree_arrays = self._tree_arrays + [None] * len(other.models)
        self.iter_ = len(self.models) // max(self.num_tree_per_iteration, 1)

    def refit(self, leaf_preds: np.ndarray, decay_rate: Optional[float] = None) -> None:
        """Re-estimate every leaf on this trainer's dataset, keeping each
        tree's structure (GBDT::RefitTree, gbdt.cpp:262-285; the JAX package's
        ``refit``). The scores start from zero; iteration by iteration the
        objective's gradients at the scores so far come from the card, each
        tree's per-leaf sums of gradients and hessians are taken in f64 on
        the card (hessians plus K_EPSILON) through ``leaf_preds`` ([N, T],
        each row's leaf in each tree), the leaf value becomes
        ``decay·old + (1 - decay)·shrinkage·output`` in f64, and the class's
        score takes the new values by one f32 add."""
        cfg = self.config
        if decay_rate is None:
            decay_rate = cfg.refit_decay_rate
        self._materialize()
        K = self.num_tree_per_iteration
        N = self.num_data
        leaf_preds = np.asarray(leaf_preds)
        if leaf_preds.ndim == 1:
            leaf_preds = leaf_preds.reshape(N, -1)
        if leaf_preds.shape[0] != N:
            raise ValueError("leaf_preds has %d rows, dataset has %d" % (leaf_preds.shape[0], N))
        if leaf_preds.shape[1] != len(self.models):
            raise ValueError("leaf_preds has %d trees, model has %d"
                             % (leaf_preds.shape[1], len(self.models)))
        dev = self.device
        lp_all = torch.as_tensor(leaf_preds.astype(np.int64), device=dev)
        self.scores = torch.zeros((K, N), dtype=torch.float32, device=dev)
        for it in range(len(self.models) // K):
            grad, hess = self._compute_gradients()
            for k in range(K):
                mi = it * K + k
                tree = self.models[mi]
                lp = lp_all[:, mi]
                sums = torch.zeros((2, tree.num_leaves), dtype=torch.float64, device=dev)
                sums[0].index_add_(0, lp, grad[k].double())
                sums[1].index_add_(0, lp, hess[k].double())
                out = calculate_leaf_output(sums[0], sums[1] + K_EPSILON, split_params(cfg))
                old = torch.as_tensor(np.asarray(tree.leaf_value, np.float64), device=dev)
                value = decay_rate * old + (1.0 - decay_rate) * (out * tree.shrinkage)
                tree.leaf_value = value.cpu().numpy()
                self._tree_arrays[mi] = None
                self.scores[k] += value.to(torch.float32)[lp]

    def feature_importance(self, importance_type: str = "split", num_iteration: int = -1) -> np.ndarray:
        self._materialize()
        n = self.max_feature_idx + 1
        out = np.zeros(n, np.float64)
        for t in self.models[:self._used_trees(num_iteration)]:
            if t is None or t.num_leaves <= 1:
                continue
            if importance_type == "gain":
                out += t.feature_importance_gains(n)
            else:
                out += t.feature_importance_counts(n)
        return out
