"""GBDT boosting loop (gbdt.cpp) for the PyTorch port.

Counterpart of lightgbm_tpu/models/gbdt.py for one slice of it: the serial
learner, binary objective, no bagging, all features, f32 or bf16 histogram
operands (``tpu_hist_dtype``), and measured histogram routing: the tune
table named by ``hist_tune`` or LIGHTGBM_TPU_HIST_TUNE is frozen once at
set-up into a ``HistRoute`` (``_resolve_hist_route``). The split loop is
chosen once at set-up too (``grow_loop``): the device-resident loop
(ops/grow.py ``launch_tree``) when that route sends every row class
to ``cuda``, which it always does on CUDA without a table
(``device_loop_routable``); else the host loop (``grow_tree``), which
routes each call. Per iteration: the
boost-from-average init score on the first one (gbdt.cpp:308-331),
objective gradients at the current scores, one grown tree
(ops/grow.py), shrinkage, and the score update through the per-row leaf
index (score_updater.hpp:80). Scores live on the training device as
``[1, N]`` f32; trees stay as host TreeArrays until they are materialised
into model Trees for text output or prediction.

On the device loop the whole iteration is queued with nothing read back
(``_device_iteration``: gradients, tree, shrinkage and score update on the
device, the packed tree copied into a ring row). On CUDA it is captured
once as a CUDA graph (ops/cuda_graph.py) and each later iteration is one
replay; ``train_chunk(n)`` (``device_chunk_size`` = n, the reference's
device-resident chunked boosting) queues n replays and reads the n trees
back with one copy, bit for bit the trees and scores of n single
iterations.

Every parameter this slice does not implement raises NotImplementedError
naming it, instead of training something else.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..dataset import BinnedDataset
from ..metric import Metric
from ..objective import ObjectiveFunction
from ..obs import tune as tune_mod
from ..ops import cuda_graph, grow_state, hist_kernel
from ..ops.grow import (
    TreeArrays, device_loop_routable, grow_tree, launch_tree, leaf_ids, tree_from_packed,
)
from ..ops.histogram import HIST_DTYPES
from ..ops.predict import ensemble_predict_raw
from ..ops.split import SplitParams
from ..utils import log
from .tree import Tree

K_EPSILON = 1e-15


def check_supported(config: Config) -> None:
    """Raise NotImplementedError for every parameter this slice does not run."""
    refused = []
    if config.boosting != "gbdt":
        refused.append("boosting=%s" % config.boosting)
    if config.objective != "binary":
        refused.append("objective=%s" % config.objective)
    if config.bagging_freq > 0 and config.bagging_fraction < 1.0:
        refused.append("bagging_fraction=%g with bagging_freq=%d"
                       % (config.bagging_fraction, config.bagging_freq))
    if config.feature_fraction < 1.0:
        refused.append("feature_fraction=%g" % config.feature_fraction)
    if config.categorical_feature:
        refused.append("categorical_feature")
    if config.forcedsplits_filename:
        refused.append("forcedsplits_filename")
    if (config.cegb_penalty_split != 0.0 or config.cegb_penalty_feature_lazy
            or config.cegb_penalty_feature_coupled):
        refused.append("cegb_penalty_*")
    if config.histogram_pool_size > 0:
        refused.append("histogram_pool_size (hist_pool_slots)")
    if config.tree_learner != "serial":
        refused.append("tree_learner=%s" % config.tree_learner)
    if config.tpu_hist_mode != "bucketed":
        refused.append("tpu_hist_mode=%s" % config.tpu_hist_mode)
    if config.tpu_hist_dtype not in HIST_DTYPES:
        refused.append("tpu_hist_dtype=%s" % config.tpu_hist_dtype)
    if refused:
        raise NotImplementedError(
            "not ported to lightgbm_tpu_torch yet: %s" % ", ".join(refused)
        )


def check_dataset_supported(train_set: BinnedDataset) -> None:
    if train_set.is_bundled:
        raise NotImplementedError("EFB-bundled datasets (group_id) are not ported yet")
    if any(m.bin_type != 0 for m in train_set.mappers):
        raise NotImplementedError("categorical features are not ported yet")
    if train_set.max_num_bin > 256:
        raise NotImplementedError("more than 256 bins per feature is not ported yet")


class GBDT:
    """Gradient Boosting Decision Tree trainer/model (gbdt.h:37-501)."""

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
        self.num_tree_per_iteration = 1
        self.shrinkage_rate = config.learning_rate
        self.max_feature_idx = 0
        self.label_idx = 0
        self.average_output = False
        self._stopped = False
        if train_set is not None:
            self._setup_train(train_set)

    # ------------------------------------------------------------------
    def _setup_train(self, train_set: BinnedDataset) -> None:
        cfg = self.config
        check_supported(cfg)
        check_dataset_supported(train_set)
        dev = self.device
        self.num_data = train_set.num_data
        self.max_feature_idx = train_set.num_total_features - 1
        bins = np.ascontiguousarray(train_set.bins, dtype=np.uint8)
        self.bins_dev = torch.from_numpy(bins).to(dev)
        # [N, F] copy: a row's bins are contiguous for the segment gathers
        self.bins_nf = self.bins_dev.t().contiguous()
        meta = train_set.feature_meta_arrays()
        self.feature_meta = {
            k: torch.as_tensor(meta[k].astype(np.int32), device=dev)
            for k in ("num_bin", "missing_type", "default_bin", "monotone")
        }
        # the dir=+1 scan exists only for missing-value handling
        self._two_way = bool(
            np.any((meta["missing_type"] != 0) & (meta["num_bin"] > 2))
        )
        self.num_bins = int(train_set.max_num_bin)
        # [ceil(N/2), F] nibble-packed copy that cuda_packed4 reads by row
        # (N * F / 2 bytes), made once here rather than on every call
        self.bins_p4 = hist_kernel.pack_bins(self.bins_nf) if self.num_bins <= 16 else None
        self.hist_route = self._resolve_hist_route()
        #: "device" (launch_tree) or "host" (grow_tree); a dispatch on
        #: the frozen route, fixed here. Tools that time both loops set it.
        self.grow_loop = "device" if device_loop_routable(
            self.num_data, self.num_bins, cfg.tpu_hist_dtype, self.hist_route, dev) else "host"
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
        self.feature_mask = torch.ones(train_set.num_features, dtype=torch.bool, device=dev)
        self.split_params = SplitParams(
            lambda_l1=cfg.lambda_l1,
            lambda_l2=cfg.lambda_l2,
            max_delta_step=cfg.max_delta_step,
            min_data_in_leaf=cfg.min_data_in_leaf,
            min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf,
            min_gain_to_split=cfg.min_gain_to_split,
        )
        init = train_set.metadata.init_score
        self._has_init_score = init is not None
        if init is not None:
            arr = np.asarray(init, np.float64).reshape(1, self.num_data)
            self.scores = torch.as_tensor(arr, dtype=torch.float32, device=dev)
        else:
            self.scores = torch.zeros((1, self.num_data), dtype=torch.float32, device=dev)
        if self.objective is not None:
            self.objective.init(train_set.metadata, self.num_data, dev)
        for m in self.training_metrics:
            m.init(train_set.metadata, self.num_data)

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
    def _boost_from_average(self) -> float:
        """gbdt.cpp:308-331."""
        if self.models or self._has_init_score or self.objective is None:
            return 0.0
        if self.config.boost_from_average or self.train_set.num_features == 0:
            init_score = self.objective.boost_from_score(0)
            if abs(init_score) > K_EPSILON:
                self.scores += np.float32(init_score)
                log.info("Start training from score %f" % init_score)
                return init_score
        return 0.0

    def _compute_gradients(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Boosting() (gbdt.cpp:148): objective gradients at the current scores."""
        return self.objective.get_gradients(self.scores[0])

    def _train_tree(self, grad: torch.Tensor, hess: torch.Tensor):
        """One tree of the host split loop and each row's leaf."""
        cfg = self.config
        return grow_tree(
            self.bins_dev, grad, hess, self.feature_mask, self.feature_meta,
            num_leaves=cfg.num_leaves, max_depth=cfg.max_depth,
            num_bins=self.num_bins, params=self.split_params,
            two_way=self._two_way, bins_nf=self.bins_nf,
            route=self.hist_route, hist_dtype=cfg.tpu_hist_dtype, bins_packed=self.bins_p4,
        )

    def _shrink(self, tree: TreeArrays) -> TreeArrays:
        """The tree's host arrays times the learning rate (``_finish_step``
        of the reference): leaf values where it split (else zeros) and
        internal values, the same f32 products the device finish takes."""
        rate = np.float32(self.shrinkage_rate)
        if int(tree.num_leaves) > 1:
            leaf_value = tree.leaf_value * rate
        else:
            leaf_value = torch.zeros_like(tree.leaf_value)
        return tree._replace(leaf_value=leaf_value, internal_value=tree.internal_value * rate)

    # ------------------------------------------------------------------
    # the device loop's iteration: queued whole, captured once on CUDA
    # ------------------------------------------------------------------
    def _device_buffers(self, rows: int) -> None:
        """The split loop's state and a ring of at least ``rows`` packed trees."""
        cfg = self.config
        F, N = self.bins_dev.shape
        s = self._grow_state
        if s is None or not s.fits(self.bins_dev.device, N, F, self.num_bins, cfg.num_leaves):
            s = self._grow_state = grow_state.GrowState(
                self.bins_dev.device, N, F, self.num_bins, cfg.num_leaves)
        if self._ring is None or self._ring.shape[0] < rows or self._ring.shape[1] != s.packed.numel():
            shape = (max(rows, cfg.device_chunk_size, 1), s.packed.numel())
            self._ring = torch.zeros(shape, dtype=torch.int32, device=self.device)
            if self.device.type == "cuda":
                self._ring_host = torch.empty(shape, dtype=torch.int32, pin_memory=True)

    def _device_iteration(self) -> None:
        """Queue one boosting iteration on the device loop, reading nothing
        back: the gradients at the current scores, the tree
        (ops/grow.py ``launch_tree``), each row's leaf, the shrinkage and
        score update on the device, the tree copied into the ring's next
        row. The reference's chunked scan body (``_chunk_fn``,
        ``_finish_step``): a tree that did not split, and every tree after
        one in the chunk (``_chunk_stopped``), adds exact zeros; the score
        update is a gather and a plain f32 add, never a multiply-add."""
        cfg = self.config
        s = self._grow_state
        grad, hess = self._compute_gradients()
        launch_tree(s, self.bins_dev, grad, hess, self.feature_mask, self.feature_meta,
                    cfg.max_depth, self.split_params, self._two_way, self.bins_nf,
                    cfg.tpu_hist_dtype)
        leaf_id = leaf_ids(s)
        grew = s.ctl[grow_state.NUM_LEAVES:grow_state.NUM_LEAVES + 1] > 1
        rate = float(np.float32(self.shrinkage_rate))
        value = torch.where(grew & ~self._chunk_stopped, s.leaf_f[:, 0] * rate, 0.0)
        self.scores[0].add_(value[leaf_id])
        self._chunk_stopped |= ~grew
        self._ring.index_copy_(0, self._ring_slot, s.packed[None])
        self._ring_slot += 1

    def _iteration_key(self) -> tuple:
        """What the captured iteration bakes in (the reference's ``_chunk_fn``
        cache key): a change of any of it captures again."""
        cfg = self.config
        return (self.num_data, self.bins_dev.shape[0], self.num_bins, cfg.num_leaves,
                cfg.max_depth, self.split_params, self._two_way, cfg.tpu_hist_dtype,
                float(np.float32(self.shrinkage_rate)), id(self._grow_state), id(self._ring),
                id(self.scores), self.device)

    def _captured_iteration(self) -> cuda_graph.Graph:
        key = self._iteration_key()
        if self._graph is None or self._graph[0] != key:
            self._graph = None  # the old graph's memory goes first
            graph = cuda_graph.Graph(self._device_iteration, self.device)
            # the buffers the key names by id stay alive as long as the graph
            self._graph = (key, graph, (self._grow_state, self._ring, self.scores))
        return self._graph[1]

    def launch_iterations(self, n: int, eager: bool = False) -> None:
        """Queue ``n`` iterations of the device loop, reading nothing back:
        the ring and the stop flag reset on the device, then ``n`` replays
        of the captured iteration (CUDA with ``iteration_graph``; captured
        at the first call) or ``n`` eager iterations (``eager``, the CPU,
        or ``iteration_graph`` False). :meth:`collect_iterations` reads the
        trees back."""
        self._device_buffers(n)
        self._ring_slot.zero_()
        self._chunk_stopped.zero_()
        if eager or not self.iteration_graph:
            for _ in range(n):
                self._device_iteration()
            return
        graph = self._captured_iteration()
        for _ in range(n):
            graph.replay()

    def collect_iterations(self, n: int) -> List[TreeArrays]:
        """The ``n`` trees of the last :meth:`launch_iterations`, shrunk,
        from one device-to-host copy of the ring (on CUDA into pinned
        memory, waited for on an event: no synchronizing call)."""
        if self.device.type == "cuda":
            host = self._ring_host[:n]
            host.copy_(self._ring[:n], non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            done.synchronize()
            host = host.clone()  # the pinned ring is refilled by the next chunk
        else:
            host = self._ring[:n].clone()
        M, B = self.config.num_leaves, self.num_bins
        return [self._shrink(tree_from_packed(host[i], M, B)) for i in range(n)]

    def _keep_trees(self, trees: List[TreeArrays], init_score: float = 0.0) -> bool:
        """Append the shrunk trees of iterations run in order; at the first
        that did not split, drop it and every later one, warn
        and stop (the reference's ``_consume_pending_stop``): those later
        iterations added exact zeros to the scores. Returns True on a stop.
        ``init_score`` (the first iteration's boost from average) folds into
        the leaf values, and a first iteration that does not split keeps its
        constant tree and re-adds the init score (gbdt.cpp:375-395)."""
        for tree in trees:
            if abs(init_score) > K_EPSILON:
                tree = tree._replace(leaf_value=tree.leaf_value + np.float32(init_score))
            if int(tree.num_leaves) <= 1:
                log.warning("Stopped training because there are no more leaves that meet the split requirements")
                self._stopped = True
                if not self.models:
                    self.models.append(None)
                    self._tree_arrays.append(tree)
                    if abs(init_score) > K_EPSILON:
                        self.scores += np.float32(init_score)
                return True
            self.models.append(None)
            self._tree_arrays.append(tree)
            self.iter_ += 1
        return False

    def train_one_iter(self) -> bool:
        """One boosting iteration; returns True when training should stop
        because the tree could not split (TrainOneIter, gbdt.cpp:332-413).
        On the device loop the first iteration runs eagerly (it builds and
        loads the kernels, and folds the boost-from-average score); on CUDA
        every later one is one replay of the captured iteration, and one
        device-to-host copy reads its tree back."""
        if self._stopped:
            return True
        init_score = self._boost_from_average()
        need_train = self.objective.class_need_train(0)
        if not need_train or self.train_set.num_features == 0:
            # nothing to learn: one constant tree, then stop (gbdt.cpp:375-400)
            output = init_score if need_train else self.objective.boost_from_score(0)
            if not self.models:
                t = Tree(1)
                t.leaf_value[0] = output
                self.models.append(t)
                self._tree_arrays.append(None)
                if output != 0.0:
                    self.scores += np.float32(output)
            log.warning("Stopped training because there are no more leaves that meet the split requirements")
            self._stopped = True
            return True
        if self.grow_loop == "device":
            self.launch_iterations(1, eager=not self.models)
            return self._keep_trees(self.collect_iterations(1), init_score)
        grad, hess = self._compute_gradients()
        tree, leaf_id = self._train_tree(grad, hess)
        tree = self._shrink(tree)
        # shrinkage + score update (gbdt.cpp:375-413): plain f32 adds of the
        # shrunk leaf values gathered by each row's leaf
        self.scores[0] += tree.leaf_value.to(self.device)[leaf_id]
        return self._keep_trees([tree], init_score)

    # ------------------------------------------------------------------
    # device-resident chunked boosting (the reference's train_chunk)
    # ------------------------------------------------------------------
    def device_chunk_fallback_reason(self) -> Optional[str]:
        """Why :meth:`train_chunk` must run iterations one at a time (None:
        the chunked device loop can run). The reference's reasons that
        apply to the port, and its own: the host split loop."""
        if self.config.device_chunk_size <= 1:
            return "device_chunk_size <= 1"
        if self.objective is None:
            return "no objective (host-computed gradients)"
        if self.train_set is None or self.train_set.num_features == 0:
            return "no usable features (constant-tree path is host-side)"
        if not self.objective.class_need_train(0):
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
        that did not split on are dropped (they added exact zeros to the
        scores), so trees and scores equal those of ``n`` calls of
        :meth:`train_one_iter` bit for bit."""
        if n <= 1 or self.device_chunk_fallback_reason() is not None:
            return 1, self.train_one_iter()
        if self._stopped:
            return 0, True
        if not self.models:
            return 1, self.train_one_iter()
        self.launch_iterations(n)
        return n, self._keep_trees(self.collect_iterations(n))

    # ------------------------------------------------------------------
    def _materialize(self) -> None:
        for i, ta in enumerate(self._tree_arrays):
            if self.models[i] is None:
                self.models[i] = Tree.from_device(ta, self.train_set)
                self.models[i].shrinkage = self.shrinkage_rate

    def num_trees(self) -> int:
        return len(self.models)

    @property
    def current_iteration(self) -> int:
        return len(self.models)

    def trees(self) -> List[Tree]:
        self._materialize()
        return self.models

    def train_score(self) -> np.ndarray:
        return self.scores[0].double().cpu().numpy()

    def predict_raw(self, X: np.ndarray, num_iteration: int = -1) -> np.ndarray:
        """Raw scores [N] (PredictRaw, gbdt_prediction.cpp:13-51), in f64 on
        the model's device."""
        self._materialize()
        use = len(self.models)
        if num_iteration is not None and num_iteration > 0:
            use = min(use, num_iteration)
        Xt = torch.as_tensor(np.asarray(X, np.float64), device=self.device)
        return ensemble_predict_raw(Xt, self.models[:use]).cpu().numpy()

    def predict(self, X: np.ndarray, num_iteration: int = -1, raw_score: bool = False) -> np.ndarray:
        raw = self.predict_raw(X, num_iteration)
        if raw_score or self.objective is None:
            return raw
        return self.objective.convert_output(raw)

    def feature_importance(self, importance_type: str = "split", num_iteration: int = -1) -> np.ndarray:
        self._materialize()
        n = self.max_feature_idx + 1
        out = np.zeros(n, np.float64)
        use = len(self.models)
        if num_iteration is not None and num_iteration > 0:
            use = min(use, num_iteration)
        for t in self.models[:use]:
            if t is None or t.num_leaves <= 1:
                continue
            if importance_type == "gain":
                out += t.feature_importance_gains(n)
            else:
                out += t.feature_importance_counts(n)
        return out
