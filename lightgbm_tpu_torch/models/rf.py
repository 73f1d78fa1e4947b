"""Random-forest mode for the PyTorch port.

Counterpart of lightgbm_tpu/models/rf.py (rf.hpp): bagged trees without
shrinkage. Every iteration's gradients are taken at the constant
boost-from-average score (rf.hpp:82-103), never at the accumulated scores;
each tree that split carries that constant in its leaves (rf.hpp:139-143)
and one that did not adds zeros; the scores hold the sum of the trees, and
the model's output and its metrics are that sum divided by the iterations
(``average_output``, rf.hpp:189). Both split loops run it through the
hooks of models/gbdt.py: the constant scores are a device tensor the
captured iteration reads.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.grow import TreeArrays
from ..utils import log
from .gbdt import GBDT


class RandomForest(GBDT):
    def _setup_train(self, train_set) -> None:
        super()._setup_train(train_set)
        cfg = self.config
        if not self._bagging_on():
            log.fatal("Random forest mode requires bagging (bagging_freq > 0 and bagging_fraction < 1.0)")
        self.average_output = True
        self.shrinkage_rate = 1.0
        K = self.num_tree_per_iteration
        #: each class's boost-from-average score: the gradients' constant
        #: scores and the bias of every tree's leaves, never in the scores
        self._rf_init = np.zeros(K)
        if self.objective is not None and (cfg.boost_from_average or train_set.num_features == 0):
            self._rf_init = np.array([self.objective.boost_from_score(k) for k in range(K)])
        init = torch.as_tensor(self._rf_init, dtype=torch.float32, device=self.device)
        self._rf_scores = init[:, None].expand(K, self.num_data).contiguous()
        log.info("Using RF (random forest) mode")

    def _boost_from_average(self, class_id: int) -> float:
        # the bias rides in every tree instead (BoostFromAverage(cur_tree_id,
        # false), rf.hpp:88), so the scores start at zero
        return 0.0

    def _compute_gradients(self):
        K = self.num_tree_per_iteration
        if K > 1:
            return self.objective.get_gradients(self._rf_scores)
        grad, hess = self.objective.get_gradients(self._rf_scores[0])
        return grad[None], hess[None]

    def _renew_scores(self, k: int) -> torch.Tensor:
        """The renewal's residuals are taken at the constant scores too
        (lightgbm_tpu/models/rf.py ``_finish_step``)."""
        return self._rf_scores[k]

    def _leaf_output(self, leaf: torch.Tensor, k: int, rate) -> torch.Tensor:
        """No shrinkage: the leaf values plus the class's constant (f32)."""
        return leaf + np.float32(self._rf_init[k])

    def _shrink(self, tree: TreeArrays, k: int) -> TreeArrays:
        return super()._shrink(tree, k)._replace(internal_value=tree.internal_value)

    def train_score(self) -> np.ndarray:
        """The scores hold the sum of the trees; the metrics see the average."""
        return self._score_np(self.scores) / max(self.current_iteration, 1)

    def _valid_score_np(self, i: int) -> np.ndarray:
        return self._score_np(self.valid_scores[i]) / max(self.current_iteration, 1)
