"""Objective functions (gradient/hessian providers).

Counterpart of lightgbm_tpu/objective.py: the ``ObjectiveFunction`` base
and the pointwise objectives that keep their tree's leaf outputs
(regression_objective.hpp, binary_objective.hpp, multiclass_objective.hpp,
xentropy_objective.hpp): ``regression`` (with ``reg_sqrt``), ``huber``,
``fair``, ``poisson``, ``gamma``, ``tweedie``, ``binary``, ``multiclass``,
``multiclassova``, ``xentropy`` and ``xentlambda``. Gradients and hessians
are f32 torch tensors on the scores' device, the JAX package's formulas op
for op (a scalar divided by a tensor is a tensor division, never torch's
reciprocal-and-multiply); ``boost_from_score`` is the JAX package's f64
host arithmetic on the f32 labels. Multiclass scores are class-major ``[K,
N]``. The objectives that renew leaf outputs (``regression_l1``,
``quantile``, ``mape``), ``lambdarank`` and a custom objective raise
NotImplementedError naming themselves.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .config import Config
from .dataset import Metadata
from .utils import log

K_EPSILON = 1e-15


def _stable_expish(fn):
    """An exp-based output conversion with numpy's overflow warning off
    (the values saturate as the reference's C++ converters do)."""
    with np.errstate(over="ignore"):
        return fn()


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
        #: the f32 labels the gradients read (the JAX package's ``_label_dev``)
        self._label_np = np.asarray(self.label, np.float32)
        self._label_dev = torch.as_tensor(self._label_np, device=device)
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


# ---------------------------------------------------------------------------
# regression family (regression_objective.hpp)
# ---------------------------------------------------------------------------

class RegressionL2Loss(ObjectiveFunction):
    name = "regression"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.sqrt = config.reg_sqrt

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if self.sqrt:
            lab = np.sign(self.label) * np.sqrt(np.abs(self.label))
            self._label_np = np.asarray(lab, np.float32)
            self._label_dev = torch.as_tensor(self._label_np, device=device)

    def get_gradients(self, score):
        grad = score - self._label_dev
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id=0):
        lab = self._label_np
        if self.weight is not None:
            return float(np.sum(lab * self.weight) / np.sum(self.weight))
        return float(np.mean(lab))

    def convert_output(self, scores):
        if self.sqrt:
            return np.sign(scores) * scores * scores
        return scores

    def to_string(self):
        return self.name + (" sqrt" if self.sqrt else "")


class RegressionHuberLoss(RegressionL2Loss):
    name = "huber"

    def __init__(self, config):
        super().__init__(config)
        self.alpha = float(config.alpha)
        self.sqrt = False

    def get_gradients(self, score):
        diff = score - self._label_dev
        grad = torch.where(torch.abs(diff) <= self.alpha, diff, torch.sign(diff) * self.alpha)
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)


class RegressionFairLoss(RegressionL2Loss):
    name = "fair"

    def __init__(self, config):
        super().__init__(config)
        self.c = float(config.fair_c)

    def get_gradients(self, score):
        x = score - self._label_dev
        ax = torch.abs(x)
        grad = self.c * x / (ax + self.c)
        d = ax + self.c
        hess = torch.full_like(d, self.c * self.c) / (d * d)
        return self._apply_weight(grad, hess)


class RegressionPoissonLoss(RegressionL2Loss):
    name = "poisson"

    def __init__(self, config):
        super().__init__(config)
        self.max_delta_step = float(config.poisson_max_delta_step)
        self.sqrt = False

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if np.min(self.label) < 0:
            log.fatal("[%s]: at least one target label is negative" % self.name)
        if np.sum(self.label) == 0:
            log.fatal("[%s]: sum of labels is zero" % self.name)

    def get_gradients(self, score):
        exp_s = torch.exp(score)
        grad = exp_s - self._label_dev
        hess = torch.exp(score + self.max_delta_step)
        return self._apply_weight(grad, hess)

    def convert_output(self, scores):
        return _stable_expish(lambda: np.exp(scores))

    def boost_from_score(self, class_id=0):
        mean = RegressionL2Loss.boost_from_score(self, class_id)
        return math.log(mean) if mean > 0 else -np.inf


class RegressionGammaLoss(RegressionPoissonLoss):
    name = "gamma"

    def get_gradients(self, score):
        exp_s = torch.exp(score)
        grad = 1.0 - self._label_dev / exp_s
        hess = self._label_dev / exp_s
        return self._apply_weight(grad, hess)


class RegressionTweedieLoss(RegressionPoissonLoss):
    name = "tweedie"

    def __init__(self, config):
        super().__init__(config)
        self.rho = float(config.tweedie_variance_power)

    def get_gradients(self, score):
        lab = self._label_dev
        e1 = torch.exp((1.0 - self.rho) * score)
        e2 = torch.exp((2.0 - self.rho) * score)
        grad = -lab * e1 + e2
        hess = -lab * (1.0 - self.rho) * e1 + (2.0 - self.rho) * e2
        return self._apply_weight(grad, hess)


# ---------------------------------------------------------------------------
# binary (binary_objective.hpp)
# ---------------------------------------------------------------------------

class BinaryLogloss(ObjectiveFunction):
    name = "binary"

    def __init__(self, config: Config, is_pos: Optional[Callable] = None) -> None:
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0:
            log.fatal("Sigmoid parameter %g should be greater than zero" % self.sigmoid)
        self.is_unbalance = config.is_unbalance
        self.scale_pos_weight = float(config.scale_pos_weight)
        if self.is_unbalance and abs(self.scale_pos_weight - 1.0) > 1e-6:
            log.fatal("Cannot set is_unbalance and scale_pos_weight at the same time")
        #: which labels are positive (multiclassova: those equal to its class)
        self._is_pos = is_pos or (lambda label: label > 0)
        self.need_train = True

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        pos = self._is_pos(self.label)
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
        pos = self._is_pos(self.label).astype(np.float64)
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
        return _stable_expish(lambda: 1.0 / (1.0 + np.exp(-self.sigmoid * scores)))

    def to_string(self):
        return "binary sigmoid:%g" % self.sigmoid


# ---------------------------------------------------------------------------
# multiclass (multiclass_objective.hpp)
# ---------------------------------------------------------------------------

class MulticlassSoftmax(ObjectiveFunction):
    name = "multiclass"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.num_class = config.num_class

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        li = self.label.astype(np.int32)
        if li.min() < 0 or li.max() >= self.num_class:
            log.fatal("Label must be in [0, %d), found invalid label" % self.num_class)
        onehot = np.zeros((self.num_class, num_data), np.float32)
        onehot[li, np.arange(num_data)] = 1.0
        self._onehot = torch.as_tensor(onehot, device=device)
        if self.weight is None:
            probs = np.bincount(li, minlength=self.num_class) / num_data
        else:
            probs = np.zeros(self.num_class)
            np.add.at(probs, li, self.weight)
            probs /= np.sum(self.weight)
        self.class_init_probs = probs

    def get_gradients(self, score):
        # score [K, N]; jax.nn.softmax over the classes, op for op
        e = torch.exp(score - score.amax(0, keepdim=True))
        p = e / e.sum(0, keepdim=True)
        grad = p - self._onehot
        hess = 2.0 * p * (1.0 - p)
        if self._weight_dev is not None:
            grad = grad * self._weight_dev[None, :]
            hess = hess * self._weight_dev[None, :]
        return grad, hess

    def convert_output(self, scores):
        # scores [..., K]
        e = np.exp(scores - np.max(scores, axis=-1, keepdims=True))
        return e / np.sum(e, axis=-1, keepdims=True)

    def boost_from_score(self, class_id=0):
        """multiclass_objective.hpp:142: log of the class prior."""
        return math.log(max(K_EPSILON, float(self.class_init_probs[class_id])))

    def class_need_train(self, class_id):
        p = float(self.class_init_probs[class_id])
        return not (abs(p) <= K_EPSILON or abs(p) >= 1.0 - K_EPSILON)

    @property
    def num_model_per_iteration(self):
        return self.num_class

    def to_string(self):
        return "multiclass num_class:%d" % self.num_class


def _make_is_pos(k: int):
    return lambda label: np.asarray(label).astype(np.int32) == k


class MulticlassOVA(ObjectiveFunction):
    name = "multiclassova"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.num_class = config.num_class
        self.sigmoid = float(config.sigmoid)
        self._binary: List[BinaryLogloss] = [
            BinaryLogloss(config, is_pos=_make_is_pos(k)) for k in range(self.num_class)]

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        for b in self._binary:
            b.init(metadata, num_data, device)

    def get_gradients(self, score):
        pairs = [self._binary[k].get_gradients(score[k]) for k in range(self.num_class)]
        return torch.stack([g for g, _ in pairs]), torch.stack([h for _, h in pairs])

    def boost_from_score(self, class_id=0):
        return self._binary[class_id].boost_from_score()

    def class_need_train(self, class_id):
        return self._binary[class_id].need_train

    def convert_output(self, scores):
        return _stable_expish(lambda: 1.0 / (1.0 + np.exp(-self.sigmoid * scores)))

    @property
    def num_model_per_iteration(self):
        return self.num_class

    def to_string(self):
        return "multiclassova num_class:%d sigmoid:%g" % (self.num_class, self.sigmoid)


# ---------------------------------------------------------------------------
# cross-entropy (xentropy_objective.hpp)
# ---------------------------------------------------------------------------

class CrossEntropy(ObjectiveFunction):
    name = "xentropy"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if self.label.min() < 0 or self.label.max() > 1:
            log.fatal("[%s]: label must be in [0, 1] interval" % self.name)
        if self.weight is not None and (self.weight.min() < 0 or self.weight.sum() == 0):
            log.fatal("[%s]: weights must be non-negative with positive sum" % self.name)

    def get_gradients(self, score):
        z = torch.sigmoid(score)
        grad = z - self._label_dev
        hess = z * (1.0 - z)
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id=0):
        lab = self._label_np.astype(np.float64)
        if self.weight is not None:
            pavg = float(np.sum(lab * self.weight) / np.sum(self.weight))
        else:
            pavg = float(np.mean(lab))
        pavg = min(max(pavg, K_EPSILON), 1.0 - K_EPSILON)
        return math.log(pavg / (1.0 - pavg))

    def convert_output(self, scores):
        return _stable_expish(lambda: 1.0 / (1.0 + np.exp(-scores)))


class CrossEntropyLambda(ObjectiveFunction):
    name = "xentlambda"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if self.label.min() < 0 or self.label.max() > 1:
            log.fatal("[%s]: label must be in [0, 1] interval" % self.name)
        if self.weight is not None and self.weight.min() <= 0:
            log.fatal("[%s]: at least one weight is non-positive" % self.name)

    def get_gradients(self, score):
        if self._weight_dev is None:
            z = torch.sigmoid(score)
            return z - self._label_dev, z * (1.0 - z)
        w = self._weight_dev
        y = self._label_dev
        epf = torch.exp(score)
        hhat = torch.log1p(epf)
        z = 1.0 - torch.exp(-w * hhat)
        enf = torch.reciprocal(epf)
        grad = (1.0 - y / z) * w / (1.0 + enf)
        c = torch.reciprocal(1.0 - z)
        d = 1.0 + epf
        a = w * epf / (d * d)
        d2 = c - 1.0
        b = (c / (d2 * d2)) * (1.0 + w * epf - c)
        hess = a * (1.0 + y * b)
        return grad, hess

    def boost_from_score(self, class_id=0):
        pavg = float(np.mean(self._label_np.astype(np.float64)))
        pavg = min(max(pavg, K_EPSILON), 1.0 - K_EPSILON)
        return math.log(pavg / (1.0 - pavg))

    def convert_output(self, scores):
        return _stable_expish(lambda: np.log1p(np.exp(scores)))


# ---------------------------------------------------------------------------
# factory (objective_function.cpp:15-52)
# ---------------------------------------------------------------------------

_OBJECTIVES = {
    "regression": RegressionL2Loss,
    "huber": RegressionHuberLoss,
    "fair": RegressionFairLoss,
    "poisson": RegressionPoissonLoss,
    "gamma": RegressionGammaLoss,
    "tweedie": RegressionTweedieLoss,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "xentropy": CrossEntropy,
    "xentlambda": CrossEntropyLambda,
}

#: the JAX package's objectives the port refuses, and why
_REFUSED = {
    "regression_l1": "it renews leaf outputs (is_renew_tree_output)",
    "quantile": "it renews leaf outputs (is_renew_tree_output)",
    "mape": "it renews leaf outputs (is_renew_tree_output)",
    "lambdarank": "ranking objectives are not ported",
    "none": "a custom objective (fobj) is not ported",
}


def create_objective(config: Config) -> ObjectiveFunction:
    name = config.objective
    if name in _REFUSED or name in ("", None):
        raise NotImplementedError("objective=%s is not ported to lightgbm_tpu_torch yet: %s"
                                  % (name, _REFUSED.get(name, _REFUSED["none"])))
    cls = _OBJECTIVES.get(name)
    if cls is None:
        log.fatal("Unknown objective type name: %s" % name)
    return cls(config)


def objective_from_model_string(s: Optional[str], config: Config) -> Optional[ObjectiveFunction]:
    """Recreate an objective from its model-file string ('binary sigmoid:1',
    'multiclass num_class:3', 'regression sqrt'; the reference's
    string-vector constructors); None for objectives the port has not got
    (predictions stay raw)."""
    if not s:
        return None
    tokens = s.split()
    cls = _OBJECTIVES.get(tokens[0])
    if cls is None:
        return None
    updates = {"objective": tokens[0]}
    for tok in tokens[1:]:
        if tok == "sqrt":
            updates["reg_sqrt"] = True
        elif tok.startswith("sigmoid:"):
            updates["sigmoid"] = float(tok.split(":", 1)[1])
        elif tok.startswith("num_class:"):
            updates["num_class"] = int(tok.split(":", 1)[1])
    return cls(config.update(updates))
