"""DART boosting (dropout trees) for the PyTorch port.

Counterpart of lightgbm_tpu/models/dart.py (dart.hpp): each iteration
draws the trees to drop on the host (uniform or weight-proportional,
dart.hpp:97-155, from its own ``RandomState(drop_seed)``), takes their
predictions out of the training scores, trains the new tree at
``learning_rate / (1 + k)`` (or the ``xgboost_dart_mode`` rate), then
rescales the dropped trees by ``k / (k + 1)`` and gives the scores back
what that leaves of them (Normalize, dart.hpp:158-200).

A tree's prediction over a set's rows is ops/predict_kernel.py's
``add_tree_value`` over the set's ``[N, F]`` bins (csrc/predict_bins.cu on
the card, its plain version on the CPU), queued between replays; the rate
is the device scalar the captured iteration reads (``_set_rate``), so every
iteration replays one graph; the rescaling is of the host TreeArrays. The
first iteration's trees hold their class's boost-from-average score from
the end of that iteration on, as the JAX package stores them, so a dropped
first tree is predicted and rescaled with it. A stop returns before
Normalize: the dropped trees stay out of the training scores, unscaled, as
in the JAX package.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..utils import log
from .gbdt import GBDT


class DART(GBDT):
    #: Normalize rescales past trees: the training scores are no plain sum
    #: of the stored trees, so an init_model of DART takes the f64 path
    _carry_is_tree_sum = False

    def _setup_train(self, train_set) -> None:
        super()._setup_train(train_set)
        self._drop_rng = np.random.RandomState(self.config.drop_seed & 0x7FFFFFFF)
        self.tree_weight: List[float] = []
        self.sum_weight = 0.0
        self.drop_index: List[int] = []
        log.info("Using DART")

    def _before_train_iter(self) -> None:
        """The drops of this iteration, their trees' predictions taken out of
        the training scores."""
        self._select_dropping_trees()
        K = self.num_tree_per_iteration
        for i in self.drop_index:
            for k in range(K):
                tree = self._tree_arrays[i * K + k]
                if tree is not None:
                    self._add_tree(tree, self.bins_nf, self.scores[k], -1.0)

    def _select_dropping_trees(self) -> None:
        """DroppingTrees (dart.hpp:97-155) and the iteration's rate."""
        cfg = self.config
        self.drop_index = []
        if self._drop_rng.rand() >= cfg.skip_drop:
            drop_rate = cfg.drop_rate
            if not cfg.uniform_drop:
                if self.sum_weight > 0:
                    inv_avg = len(self.tree_weight) / self.sum_weight
                    if cfg.max_drop > 0:
                        drop_rate = min(drop_rate, cfg.max_drop * inv_avg / self.sum_weight)
                    for i in range(self.iter_):
                        if self._drop_rng.rand() < drop_rate * self.tree_weight[i] * inv_avg:
                            self.drop_index.append(i)
                            if len(self.drop_index) >= cfg.max_drop > 0:
                                break
            else:
                if cfg.max_drop > 0 and self.iter_ > 0:
                    drop_rate = min(drop_rate, cfg.max_drop / float(self.iter_))
                for i in range(self.iter_):
                    if self._drop_rng.rand() < drop_rate:
                        self.drop_index.append(i)
                        if len(self.drop_index) >= cfg.max_drop > 0:
                            break
        k = float(len(self.drop_index))
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = cfg.learning_rate / (1.0 + k)
        elif not self.drop_index:
            self.shrinkage_rate = cfg.learning_rate
        else:
            self.shrinkage_rate = cfg.learning_rate / (cfg.learning_rate + k)

    def _after_train_iter(self) -> None:
        """Normalize (dart.hpp:158-200), both forms: each dropped tree leaves
        the validation scores ``pred * valid_factor``, gives the training
        scores back ``pred * tree_factor`` and is rescaled by ``tree_factor``
        (f32 products)."""
        cfg = self.config
        K = self.num_tree_per_iteration
        self._fold_init_into_trees()
        k = float(len(self.drop_index))
        lr = cfg.learning_rate
        if not cfg.xgboost_dart_mode:
            valid_factor, tree_factor, weight_denom = 1.0 / (k + 1.0), k / (k + 1.0), k + 1.0
        else:
            valid_factor, tree_factor, weight_denom = lr / (k + lr), k / (k + lr), k + lr
        factor = np.float32(tree_factor)
        for i in self.drop_index:
            for kk in range(K):
                idx = i * K + kk
                tree = self._tree_arrays[idx]
                if tree is None:
                    continue
                for bins, score in zip(self._valid_bins, self.valid_scores):
                    self._add_tree(tree, bins, score[kk], -np.float32(valid_factor))
                self._add_tree(tree, self.bins_nf, self.scores[kk], factor)
                self._tree_arrays[idx] = tree._replace(leaf_value=tree.leaf_value * factor,
                                                       internal_value=tree.internal_value * factor)
                self.models[idx] = None  # materialised again from the rescaled arrays
            if not cfg.uniform_drop and self.tree_weight:
                self.sum_weight -= self.tree_weight[i] * (1.0 / weight_denom)
                self.tree_weight[i] *= tree_factor
        self.tree_weight.append(self.shrinkage_rate)
        self.sum_weight += self.shrinkage_rate
