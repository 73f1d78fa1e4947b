"""Objective functions (gradient/hessian providers): binary log-loss.

Counterpart of lightgbm_tpu/objective.py's ``ObjectiveFunction`` base and
``BinaryLogloss`` (binary_objective.hpp). Gradients and hessians are f32
torch tensors on the scores' device; the formulas are the JAX package's,
op for op. Other objectives are not ported yet and raise.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .config import Config
from .dataset import Metadata
from .utils import log

K_EPSILON = 1e-15


class ObjectiveFunction:
    """Interface mirror of objective_function.h."""

    name = "none"

    def __init__(self, config: Config) -> None:
        self.config = config
        self.num_data = 0
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self._weight_dev: Optional[torch.Tensor] = None

    def init(self, metadata: Metadata, num_data: int, device: torch.device) -> None:
        self.num_data = num_data
        self.label = metadata.label if metadata.label is not None else np.zeros(num_data, np.float32)
        self.weight = metadata.weight
        if self.weight is not None:
            self._weight_dev = torch.as_tensor(self.weight, dtype=torch.float32, device=device)

    def get_gradients(self, score: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0

    def convert_output(self, scores: np.ndarray) -> np.ndarray:
        return scores

    @property
    def num_model_per_iteration(self) -> int:
        return 1

    def class_need_train(self, class_id: int) -> bool:
        return True

    def to_string(self) -> str:
        return self.name

    def _apply_weight(self, grad, hess):
        if self._weight_dev is None:
            return grad, hess
        return grad * self._weight_dev, hess * self._weight_dev


class BinaryLogloss(ObjectiveFunction):
    name = "binary"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0:
            log.fatal("Sigmoid parameter %g should be greater than zero" % self.sigmoid)
        self.is_unbalance = config.is_unbalance
        self.scale_pos_weight = float(config.scale_pos_weight)
        if self.is_unbalance and abs(self.scale_pos_weight - 1.0) > 1e-6:
            log.fatal("Cannot set is_unbalance and scale_pos_weight at the same time")
        self.need_train = True

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        pos = self.label > 0
        cnt_pos = int(pos.sum())
        cnt_neg = num_data - cnt_pos
        self.need_train = not (cnt_pos == 0 or cnt_neg == 0)
        if not self.need_train:
            log.warning("Contains only one class")
        else:
            log.info("Number of positive: %d, number of negative: %d" % (cnt_pos, cnt_neg))
        w_pos, w_neg = 1.0, 1.0
        if self.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                w_neg = cnt_pos / cnt_neg
            else:
                w_pos = cnt_neg / cnt_pos
        w_pos *= self.scale_pos_weight
        # y in {-1, +1}; per-row label weight
        self._y = torch.as_tensor(np.where(pos, 1.0, -1.0), dtype=torch.float32, device=device)
        self._lw = torch.as_tensor(np.where(pos, w_pos, w_neg), dtype=torch.float32, device=device)

    def get_gradients(self, score):
        if not self.need_train:
            return torch.zeros_like(score), torch.zeros_like(score)
        y = self._y
        response = -y * self.sigmoid / (1.0 + torch.exp(y * self.sigmoid * score))
        abs_resp = torch.abs(response)
        grad = response * self._lw
        hess = abs_resp * (self.sigmoid - abs_resp) * self._lw
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id=0):
        pos = (self.label > 0).astype(np.float64)
        if self.weight is not None:
            pavg = float(np.sum(pos * self.weight) / np.sum(self.weight))
        else:
            pavg = float(np.mean(pos))
        pavg = min(pavg, 1.0 - K_EPSILON)
        pavg = max(pavg, K_EPSILON)
        initscore = math.log(pavg / (1.0 - pavg)) / self.sigmoid
        log.info("[%s:BoostFromScore]: pavg=%f -> initscore=%f" % (self.name, pavg, initscore))
        return initscore

    def class_need_train(self, class_id):
        return self.need_train

    def convert_output(self, scores):
        with np.errstate(over="ignore"):
            return 1.0 / (1.0 + np.exp(-self.sigmoid * scores))

    def to_string(self):
        return "binary sigmoid:%g" % self.sigmoid


def create_objective(config: Config) -> ObjectiveFunction:
    if config.objective != "binary":
        raise NotImplementedError(
            "objective=%s is not ported yet; only objective=binary is" % config.objective
        )
    return BinaryLogloss(config)


def objective_from_model_string(s: Optional[str], config: Config) -> Optional[ObjectiveFunction]:
    """Recreate an objective from its model-file string ('binary sigmoid:1');
    None for objectives the port has not got (predictions stay raw)."""
    if not s:
        return None
    tokens = s.split()
    if tokens[0] != "binary":
        return None
    updates = {"objective": "binary"}
    for tok in tokens[1:]:
        if tok.startswith("sigmoid:"):
            updates["sigmoid"] = float(tok.split(":", 1)[1])
    return BinaryLogloss(config.update(updates))
