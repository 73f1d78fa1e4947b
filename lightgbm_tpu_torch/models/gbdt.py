"""GBDT boosting loop (gbdt.cpp) for the PyTorch port.

Counterpart of lightgbm_tpu/models/gbdt.py for one slice of it: the serial
learner, binary objective, no bagging, all features. Per iteration: the
boost-from-average init score on the first one (gbdt.cpp:308-331),
objective gradients at the current scores, one grown tree
(ops/grow.py), shrinkage, and the score update through the per-row leaf
index (score_updater.hpp:80). Scores live on the training device as
``[1, N]`` f32; trees stay as host TreeArrays until they are materialised
into model Trees for text output or prediction.

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
from ..ops.grow import TreeArrays, grow_tree
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
    if config.tpu_hist_dtype != "float32":
        refused.append("tpu_hist_dtype=%s" % config.tpu_hist_dtype)
    if config.device_chunk_size > 1:
        refused.append("device_chunk_size=%d" % config.device_chunk_size)
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
        cfg = self.config
        return grow_tree(
            self.bins_dev, grad, hess, self.feature_mask, self.feature_meta,
            num_leaves=cfg.num_leaves, max_depth=cfg.max_depth,
            num_bins=self.num_bins, params=self.split_params,
            two_way=self._two_way, bins_nf=self.bins_nf,
        )

    def _finish_tree(self, tree: TreeArrays, leaf_id: torch.Tensor) -> TreeArrays:
        """Shrinkage + score update (gbdt.cpp:375-413): plain f32 adds of the
        shrunk leaf values gathered by each row's leaf."""
        rate = np.float32(self.shrinkage_rate)
        if int(tree.num_leaves) > 1:
            leaf_value = tree.leaf_value * rate
        else:
            leaf_value = torch.zeros_like(tree.leaf_value)
        self.scores[0] += leaf_value.to(self.device)[leaf_id]
        return tree._replace(
            leaf_value=leaf_value, internal_value=tree.internal_value * rate
        )

    def train_one_iter(self) -> bool:
        """One boosting iteration; returns True when training should stop
        because the tree could not split (TrainOneIter, gbdt.cpp:332-413)."""
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
        grad, hess = self._compute_gradients()
        tree, leaf_id = self._train_tree(grad, hess)
        tree = self._finish_tree(tree, leaf_id)
        if abs(init_score) > K_EPSILON:
            tree = tree._replace(leaf_value=tree.leaf_value + np.float32(init_score))
        if int(tree.num_leaves) <= 1:
            log.warning("Stopped training because there are no more leaves that meet the split requirements")
            self._stopped = True
            if not self.models:
                # first iteration: keep the constant tree and re-add its
                # output to the scores (gbdt.cpp:375-395)
                self.models.append(None)
                self._tree_arrays.append(tree)
                if abs(init_score) > K_EPSILON:
                    self.scores += np.float32(init_score)
            return True
        self.models.append(None)
        self._tree_arrays.append(tree)
        self.iter_ += 1
        return False

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
