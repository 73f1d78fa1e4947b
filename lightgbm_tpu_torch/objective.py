"""Objective functions (gradient/hessian providers).

Counterpart of lightgbm_tpu/objective.py: the ``ObjectiveFunction`` base,
the pointwise objectives (regression_objective.hpp, binary_objective.hpp,
multiclass_objective.hpp, xentropy_objective.hpp): ``regression`` (with
``reg_sqrt``), ``regression_l1``, ``huber``, ``fair``, ``poisson``,
``quantile``, ``mape``, ``gamma``, ``tweedie``, ``binary``, ``multiclass``,
``multiclassova``, ``xentropy`` and ``xentlambda``, and ``lambdarank``
(rank_objective.hpp). Gradients and hessians are f32 torch tensors on the
scores' device, the JAX package's formulas op for op (a scalar divided by a
tensor is a tensor division, never torch's reciprocal-and-multiply);
``boost_from_score`` is the JAX package's f64 host arithmetic on the f32
labels. Multiclass scores are class-major ``[K, N]``.

``regression_l1``, ``quantile`` and ``mape`` renew each tree's leaf outputs
(``is_renew_tree_output``, RenewTreeOutput): a leaf's value becomes the
(weighted) alpha-percentile of its bagged rows' residuals ``label - score``
at the scores before the tree, :func:`segment_percentile` on the training
device inside the boosting iteration, from each row's leaf
(:meth:`RegressionL1Loss.renew_leaf_outputs`, in both split loops: the
device loop's leaves come from its ``leaf_ids`` kernel). ``lambdarank``
reads its queries' plan (ops/rank.py ``RankPlan``, built at set-up) and
takes its gradients from csrc/lambdarank.cu on the card (ops/rank_kernel.py;
the plain bucketed version on the CPU). ``objective="none"`` (a custom
objective, ``fobj``) has no ObjectiveFunction: :func:`create_objective`
gives None and the caller hands the gradients in.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .config import Config
from .dataset import Metadata
from .ops import rank as rank_plain
from .ops import rank_kernel
from .utils import log

K_EPSILON = 1e-15


def _stable_expish(fn):
    """An exp-based output conversion with numpy's overflow warning off
    (the values saturate as the reference's C++ converters do)."""
    with np.errstate(over="ignore"):
        return fn()


# ---------------------------------------------------------------------------
# percentile helpers (regression_objective.hpp:18-75; the JAX package's
# lightgbm_tpu/objective.py:44-165)
# ---------------------------------------------------------------------------

def percentile(data: np.ndarray, alpha: float) -> float:
    """PercentileFun: the alpha-quantile from the descending order statistics."""
    cnt = len(data)
    if cnt == 0:
        return 0.0
    if cnt <= 1:
        return float(data[0])
    desc = np.sort(data)[::-1]
    float_pos = (1.0 - alpha) * cnt
    pos = int(float_pos)
    if pos < 1:
        return float(desc[0])
    if pos >= cnt:
        return float(desc[-1])
    bias = float_pos - pos
    v1 = float(desc[pos - 1])
    v2 = float(desc[pos])
    return v1 - (v1 - v2) * bias


def weighted_percentile(data: np.ndarray, weights: np.ndarray, alpha: float) -> float:
    """WeightedPercentileFun (regression_objective.hpp:46-75)."""
    cnt = len(data)
    if cnt == 0:
        return 0.0
    if cnt <= 1:
        return float(data[0])
    order = np.argsort(data, kind="stable")
    cdf = np.cumsum(weights[order]).astype(np.float64)
    threshold = cdf[-1] * alpha
    pos = int(np.searchsorted(cdf, threshold, side="right"))
    pos = min(pos, cnt - 1)
    if pos == 0 or pos == cnt - 1:
        return float(data[order[pos]])
    v1 = float(data[order[pos - 1]])
    v2 = float(data[order[pos]])
    if cdf[pos + 1] - cdf[pos] >= 1.0:
        return float((threshold - cdf[pos]) / (cdf[pos + 1] - cdf[pos]) * (v2 - v1) + v1)
    return v2


def _percentile_maybe_weighted(data, weights, alpha):
    if weights is None:
        return percentile(data, alpha)
    return weighted_percentile(data, weights, alpha)


def _value_key(values: torch.Tensor) -> torch.Tensor:
    """int64 keys in [0, 2^32) that order as the f32 ``values`` do, with
    -0 equal to +0 and every NaN after +inf (the JAX sort's comparator)."""
    v = torch.where(values == 0, 0.0, values)
    v = torch.where(torch.isnan(v), float("nan"), v).contiguous()
    b = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(b >= 0x80000000, 0xFFFFFFFF - b, b + 0x80000000)


def segment_percentile(values: torch.Tensor, leaf: torch.Tensor, sel: Optional[torch.Tensor],
                       weights: Optional[torch.Tensor], old: torch.Tensor, num_leaves: int,
                       alpha: float) -> torch.Tensor:
    """Each leaf's alpha-percentile of ``values`` [P] f32 over its selected
    positions, PercentileFun's semantics (WeightedPercentileFun's with
    ``weights``), ``old`` [num_leaves] where a leaf has none: the JAX
    package's ``segment_percentile`` (lightgbm_tpu/objective.py:93-165) op
    for op. ``leaf`` [P] gives each position's leaf and ``sel`` [P] bool
    (None: all) whether it counts; the positions of one leaf must come in
    row order (rows, or a leaf's segment of the device loop's ``order``).
    One stable sort by the int64 key (leaf, value), the unselected positions
    after every leaf, orders each leaf's values with ties in row order, as
    the JAX package's two stable sorts do; the weighted branch's cumulative
    weights are one cumsum across the leaves, in that order, accumulated in
    f64 and rounded to f32 (the JAX package's is an f32 left fold)."""
    P, M, dev = values.shape[0], num_leaves, values.device
    lid = leaf.to(torch.int64)
    if sel is not None:
        lid = torch.where(sel, lid, M)
    order = torch.sort((lid << 32) | _value_key(values), stable=True).indices
    l_sorted = lid[order]
    v_sorted = values[order]
    leaves = torch.arange(M, dtype=torch.int64, device=dev)
    begin = torch.searchsorted(l_sorted, leaves)
    end = torch.searchsorted(l_sorted, leaves, right=True)
    cnt = end - begin

    def asc(pos):  # the pos-th ascending value of each leaf
        return v_sorted[torch.clamp(begin + pos, 0, P - 1)]

    if weights is None:
        # PercentileFun reads DESCENDING statistics: desc[i] = asc[cnt - 1 - i]
        float_pos = float(np.float32(1.0 - alpha)) * cnt.to(torch.float32)
        pos = float_pos.to(torch.int64)
        bias = float_pos - pos.to(torch.float32)
        v1 = asc(cnt - pos)
        v2 = asc(cnt - 1 - pos)
        out = v1 - (v1 - v2) * bias
        out = torch.where(pos < 1, asc(cnt - 1), out)
        out = torch.where(pos >= cnt, asc(torch.zeros_like(cnt)), out)
    else:
        w_sorted = weights[order] * (l_sorted < M)
        # accumulated in f64, each sum rounded to f32: the CPU's f32 cumsum
        # bit for bit; on the card the f64 sums of f32 weights are exact
        # whenever they span under 53 bits (label weights do), so any scan
        # order gives the same bits, and a replay the eager launch's
        cumw = torch.cumsum(w_sorted.double(), 0).float()
        base = torch.where(begin > 0, cumw[torch.clamp(begin - 1, min=0)], 0.0)
        total = torch.where(end > 0, cumw[torch.clamp(end - 1, min=0)], 0.0) - base
        threshold = total * float(np.float32(alpha))
        pos = torch.searchsorted(cumw, base + threshold, right=True) - begin
        pos = torch.minimum(pos, cnt - 1)

        def cdf(p):  # a leaf's cumulative weight at its local index p
            return cumw[torch.clamp(begin + p, 0, P - 1)] - base

        v1 = asc(pos - 1)
        v2 = asc(pos)
        c0, c1 = cdf(pos), cdf(pos + 1)
        interp = (threshold - c0) / (c1 - c0) * (v2 - v1) + v1
        out = torch.where(c1 - c0 >= 1.0, interp, v2)
        edge = (pos <= 0) | (pos >= cnt - 1)
        out = torch.where(edge, asc(torch.minimum(torch.clamp(pos, min=0), cnt - 1)), out)
    out = torch.where(cnt <= 1, asc(torch.zeros_like(cnt)), out)
    return torch.where(cnt == 0, old, out.to(old.dtype))


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

    @property
    def is_renew_tree_output(self) -> bool:
        """True when a tree's leaf outputs are renewed from the residuals
        (``regression_l1``, ``quantile``, ``mape``)."""
        return False

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


class RegressionL1Loss(RegressionL2Loss):
    name = "regression_l1"

    def get_gradients(self, score):
        grad = torch.sign(score - self._label_dev)
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id=0):
        return _percentile_maybe_weighted(self._label_np, self.weight, 0.5)

    @property
    def is_renew_tree_output(self):
        return True

    def _renew_alpha(self) -> float:
        return 0.5

    def _renew_weights(self) -> Optional[torch.Tensor]:
        """The renewal's f32 weights on the device (None: unweighted)."""
        return self._weight_dev

    def renew_leaf_outputs(self, score: torch.Tensor, leaf_id: torch.Tensor,
                           bag: Optional[torch.Tensor], num_leaves: int,
                           leaf_value: torch.Tensor) -> torch.Tensor:
        """RenewTreeOutput from each row's leaf ``leaf_id`` [N] (the host
        split loop): the renewed [num_leaves] f32 leaf values, the
        residuals taken at ``score`` [N], the scores before the tree, over
        the rows of ``bag`` ([N] f32 mask, None: all); a leaf without a
        bagged row keeps its ``leaf_value``."""
        return segment_percentile(self._label_dev - score, leaf_id, None if bag is None else bag > 0,
                                  self._renew_weights(), leaf_value, num_leaves, self._renew_alpha())


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


class RegressionQuantileLoss(RegressionL1Loss):
    name = "quantile"

    def __init__(self, config):
        super().__init__(config)
        self.alpha = float(config.alpha)
        if not 0.0 < self.alpha < 1.0:
            log.fatal("quantile: alpha must be in (0, 1), got %g" % self.alpha)

    def get_gradients(self, score):
        # where(delta >= 0, 1 - alpha, -alpha), each side rounded to f32
        grad = torch.full_like(score, -self.alpha).masked_fill_(score - self._label_dev >= 0,
                                                                1.0 - self.alpha)
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id=0):
        return _percentile_maybe_weighted(self._label_np, self.weight, self.alpha)

    def _renew_alpha(self):
        return self.alpha


class RegressionMAPELoss(RegressionL1Loss):
    name = "mape"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if np.any(np.abs(self.label) < 1):
            log.warning("Met 'abs(label) < 1', will convert them to '1' in MAPE objective and metric")
        lw = 1.0 / np.maximum(1.0, np.abs(self.label))
        if self.weight is not None:
            lw = lw * self.weight
        #: f32 1 / max(1, |label|), times the weight
        self.label_weight = lw.astype(np.float32)
        self._label_weight_dev = torch.as_tensor(self.label_weight, device=device)

    def get_gradients(self, score):
        grad = torch.sign(score - self._label_dev) * self._label_weight_dev
        hess = torch.ones_like(score)
        if self._weight_dev is not None:
            hess = self._weight_dev * hess
        return grad, hess

    def boost_from_score(self, class_id=0):
        return weighted_percentile(self._label_np, self.label_weight, 0.5)

    def _renew_weights(self):
        return self._label_weight_dev


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
# LambdaRank (rank_objective.hpp)
# ---------------------------------------------------------------------------

def default_label_gain(size: int = 31) -> np.ndarray:
    """DCGCalculator::DefaultLabelGain: 2^i - 1."""
    return (np.power(2.0, np.arange(size)) - 1.0).astype(np.float64)


def dcg_discount(positions: np.ndarray) -> np.ndarray:
    """DCGCalculator::GetDiscount: 1 / log2(2 + i)."""
    return 1.0 / np.log2(2.0 + positions)


class LambdarankNDCG(ObjectiveFunction):
    """LambdaRank's NDCG-weighted pairwise lambdas over query groups. The
    query plan (ops/rank.py ``RankPlan``: boundaries, labels, f32 label
    gains, f32 inverse max DCGs at ``max_position``, weights) is built at
    set-up on the training device; the gradients come from
    csrc/lambdarank.cu on the card and from its plain version on the CPU
    (ops/rank_kernel.py)."""

    name = "lambdarank"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0:
            log.fatal("Sigmoid param %g should be greater than zero" % self.sigmoid)
        lg = list(config.label_gain) if config.label_gain else list(default_label_gain())
        self.label_gain = np.asarray(lg, np.float64)
        self.optimize_pos_at = config.max_position

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            log.fatal("Lambdarank tasks require query information")
        self.query_boundaries = metadata.query_boundaries
        self.num_queries = metadata.num_queries
        li = self.label.astype(np.int64)
        if li.min() < 0 or li.max() >= len(self.label_gain):
            log.fatal("Label exceeds label_gain size in lambdarank")
        # inverse max DCG of each query at k = optimize_pos_at, in f64
        inv = np.zeros(self.num_queries, np.float64)
        for q in range(self.num_queries):
            lo, hi = self.query_boundaries[q], self.query_boundaries[q + 1]
            k = min(self.optimize_pos_at, hi - lo)
            top = np.sort(li[lo:hi])[::-1][:k]
            maxdcg = float(np.sum(self.label_gain[top] * dcg_discount(np.arange(k))))
            inv[q] = 1.0 / maxdcg if maxdcg > 0 else 0.0
        self.inverse_max_dcgs = inv
        self.plan = rank_plain.RankPlan(self.query_boundaries, li, self.label_gain, inv, self.weight,
                                        device)
        # the long queries' discounts on the card, allocated once for the captured iteration
        self._scratch = None
        if device.type == "cuda" and self.plan.max_size > rank_kernel.SMEM_ROWS:
            self._scratch = torch.empty(num_data, dtype=torch.float32, device=device)

    def get_gradients(self, score):
        return rank_kernel.lambdarank(score.contiguous(), self.plan, self.sigmoid, self._scratch)


# ---------------------------------------------------------------------------
# factory (objective_function.cpp:15-52)
# ---------------------------------------------------------------------------

_OBJECTIVES = {
    "regression": RegressionL2Loss,
    "regression_l1": RegressionL1Loss,
    "huber": RegressionHuberLoss,
    "fair": RegressionFairLoss,
    "poisson": RegressionPoissonLoss,
    "quantile": RegressionQuantileLoss,
    "mape": RegressionMAPELoss,
    "gamma": RegressionGammaLoss,
    "tweedie": RegressionTweedieLoss,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "xentropy": CrossEntropy,
    "xentlambda": CrossEntropyLambda,
    "lambdarank": LambdarankNDCG,
}

def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """The objective of ``config``; None for ``none`` (a custom objective:
    the caller hands the gradients in), as in the JAX package."""
    name = config.objective
    if name in ("none", "", None):
        return None
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
