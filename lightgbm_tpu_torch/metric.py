"""Evaluation metrics.

Copies of lightgbm_tpu/metric.py's pointwise and classification metrics:
the ``_AverageLossMetric`` family (l2, rmse, l1, quantile, huber, fair,
poisson, gamma, gamma-deviance, tweedie, mape, binary log-loss and error),
AUC, ``multi_logloss``, ``multi_error``, ``xentropy``, ``xentlambda``,
``kldiv``, and the ranking metrics ``ndcg@k`` and ``map@k`` over
``eval_at`` (with query weights), under the JAX package's names and
aliases. Host-side numpy in
double precision over the raw scores (``[N]``, or ``[K, N]`` for the multi
metrics), with the objective's link applied inside the metric, so values,
and the early-stopping decisions made on them, agree with the JAX
package's. Each instance is initialised on the metadata of the set it
evaluates (the training set or one validation set).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .config import Config
from .dataset import Metadata
from .objective import ObjectiveFunction, dcg_discount, default_label_gain
from .utils import log


class Metric:
    """One metric; ``eval`` returns a list of (name, value, bigger_is_better)."""

    names: List[str] = []
    bigger_is_better = False

    def __init__(self, config: Config) -> None:
        self.config = config

    def init(self, metadata: Metadata, num_data: int) -> None:
        self.num_data = num_data
        self.label = (
            metadata.label if metadata.label is not None else np.zeros(num_data, np.float32)
        ).astype(np.float64)
        self.weight = None if metadata.weight is None else metadata.weight.astype(np.float64)
        self.sum_weights = float(num_data) if self.weight is None else float(np.sum(self.weight))

    def eval(self, score: np.ndarray, objective: Optional[ObjectiveFunction]):
        raise NotImplementedError

    def _mean(self, losses: np.ndarray) -> float:
        if self.weight is not None:
            return float(np.sum(losses * self.weight) / self.sum_weights)
        return float(np.mean(losses))


class _AverageLossMetric(Metric):
    """Shared shape of regression_metric.hpp: weighted mean of a pointwise loss."""

    def point_loss(self, score: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def eval(self, score, objective):
        s = np.asarray(score, np.float64)
        if objective is not None:
            s = objective.convert_output(s)
        return [(self.names[0], self.finalize(self._mean(self.point_loss(s))), self.bigger_is_better)]

    def finalize(self, v: float) -> float:
        return v


class L2Metric(_AverageLossMetric):
    names = ["l2"]

    def point_loss(self, s):
        return (s - self.label) ** 2


class RMSEMetric(L2Metric):
    names = ["rmse"]

    def finalize(self, v):
        return float(np.sqrt(v))


class L1Metric(_AverageLossMetric):
    names = ["l1"]

    def point_loss(self, s):
        return np.abs(s - self.label)


class QuantileMetric(_AverageLossMetric):
    names = ["quantile"]

    def point_loss(self, s):
        alpha = self.config.alpha
        d = self.label - s
        return np.where(d >= 0, alpha * d, (alpha - 1.0) * d)


class HuberLossMetric(_AverageLossMetric):
    names = ["huber"]

    def point_loss(self, s):
        alpha = self.config.alpha
        d = np.abs(s - self.label)
        return np.where(d <= alpha, 0.5 * d * d, alpha * (d - 0.5 * alpha))


class FairLossMetric(_AverageLossMetric):
    names = ["fair"]

    def point_loss(self, s):
        c = self.config.fair_c
        x = np.abs(s - self.label)
        return c * x - c * c * np.log1p(x / c)


class PoissonMetric(_AverageLossMetric):
    names = ["poisson"]

    def point_loss(self, s):
        s = np.maximum(s, 1e-10)
        return s - self.label * np.log(s)


class GammaMetric(_AverageLossMetric):
    names = ["gamma"]

    def point_loss(self, s):
        s = np.maximum(s, 1e-10)
        # -log(likelihood) with shape k=1: x/theta + log(theta), theta=s, x=label
        return self.label / s + np.log(s)


class GammaDevianceMetric(_AverageLossMetric):
    names = ["gamma-deviance"]

    def point_loss(self, s):
        s = np.maximum(s, 1e-10)
        r = self.label / s
        return 2.0 * (np.log(np.maximum(1e-300, 1.0 / np.maximum(r, 1e-300))) + r - 1.0)


class TweedieMetric(_AverageLossMetric):
    names = ["tweedie"]

    def point_loss(self, s):
        rho = self.config.tweedie_variance_power
        s = np.maximum(s, 1e-10)
        a = self.label * np.power(s, 1.0 - rho) / (1.0 - rho)
        b = np.power(s, 2.0 - rho) / (2.0 - rho)
        return -a + b


class MAPEMetric(_AverageLossMetric):
    names = ["mape"]

    def point_loss(self, s):
        return np.abs((self.label - s)) / np.maximum(1.0, np.abs(self.label))


class BinaryLoglossMetric(_AverageLossMetric):
    names = ["binary_logloss"]

    def point_loss(self, prob):
        p = np.clip(prob, 1e-15, 1.0 - 1e-15)
        is_pos = (self.label > 0).astype(np.float64)
        return -is_pos * np.log(p) - (1.0 - is_pos) * np.log(1.0 - p)


class BinaryErrorMetric(_AverageLossMetric):
    names = ["binary_error"]

    def point_loss(self, prob):
        return ((prob > 0.5) != (self.label > 0)).astype(np.float64)


class AUCMetric(Metric):
    names = ["auc"]
    bigger_is_better = True

    def eval(self, score, objective):
        s = np.asarray(score, np.float64)
        order = np.argsort(-s, kind="stable")
        lab = self.label[order]
        w = np.ones(self.num_data) if self.weight is None else self.weight[order]
        pos_w = np.where(lab > 0, w, 0.0)
        neg_w = np.where(lab <= 0, w, 0.0)
        # group ties on score: per unique threshold, accum += neg*(pos/2 + sum_pos_before)
        ss = s[order]
        new_grp = np.empty(self.num_data, bool)
        new_grp[0] = True
        new_grp[1:] = ss[1:] != ss[:-1]
        gid = np.cumsum(new_grp) - 1
        ngroups = gid[-1] + 1
        gpos = np.zeros(ngroups)
        gneg = np.zeros(ngroups)
        np.add.at(gpos, gid, pos_w)
        np.add.at(gneg, gid, neg_w)
        sum_pos_before = np.concatenate([[0.0], np.cumsum(gpos)[:-1]])
        accum = float(np.sum(gneg * (gpos * 0.5 + sum_pos_before)))
        sum_pos = float(np.sum(gpos))
        if sum_pos > 0 and sum_pos != self.sum_weights:
            return [("auc", accum / (sum_pos * (self.sum_weights - sum_pos)), True)]
        return [("auc", 1.0, True)]


class MultiLoglossMetric(Metric):
    names = ["multi_logloss"]

    def eval(self, score, objective):
        # score [K, N] raw -> converted per row
        K, N = score.shape
        probs = objective.convert_output(np.asarray(score, np.float64).T) if objective else score.T
        p = np.clip(probs[np.arange(N), self.label.astype(np.int64)], 1e-15, None)
        return [("multi_logloss", self._mean(-np.log(p)), False)]


class MultiErrorMetric(Metric):
    names = ["multi_error"]

    def eval(self, score, objective):
        pred = np.argmax(np.asarray(score), axis=0)
        err = (pred != self.label.astype(np.int64)).astype(np.float64)
        return [("multi_error", self._mean(err), False)]


class CrossEntropyMetric(_AverageLossMetric):
    names = ["xentropy"]

    def point_loss(self, p):
        p = np.clip(p, 1e-15, 1 - 1e-15)
        y = self.label
        return -y * np.log(p) - (1 - y) * np.log(1 - p)


class CrossEntropyLambdaMetric(Metric):
    names = ["xentlambda"]

    def eval(self, score, objective):
        s = np.asarray(score, np.float64)
        # hhat = log1p(exp(score)); loss per xentropy_metric.hpp (lambda parameterization)
        hhat = np.log1p(np.exp(s))
        w = np.ones(self.num_data) if self.weight is None else self.weight
        z = np.clip(1.0 - np.exp(-w * hhat), 1e-15, 1 - 1e-15)
        y = self.label
        losses = -y * np.log(z) - (1 - y) * np.log(1 - z)
        return [("xentlambda", float(np.mean(losses)), False)]


class KLDivMetric(Metric):
    names = ["kldiv"]

    def eval(self, score, objective):
        s = np.asarray(score, np.float64)
        p = np.clip(1.0 / (1.0 + np.exp(-s)), 1e-15, 1 - 1e-15)
        y = np.clip(self.label, 1e-15, 1 - 1e-15)
        losses = y * np.log(y / p) + (1 - y) * np.log((1 - y) / (1 - p))
        w = np.ones(self.num_data) if self.weight is None else self.weight
        return [("kldiv", float(np.sum(losses * w) / self.sum_weights), False)]


class _QueryMetric(Metric):
    """The ranking metrics' shared set-up: query boundaries and weights."""

    def __init__(self, config):
        super().__init__(config)
        self.eval_at = list(config.eval_at) or [1, 2, 3, 4, 5]

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            log.fatal("The %s metric requires query information" % self.names[0].upper())
        self.qb = metadata.query_boundaries
        self.num_queries = metadata.num_queries
        self.query_weights = metadata.query_weights()
        self.sum_query_weights = (
            float(self.num_queries) if self.query_weights is None
            else float(np.sum(self.query_weights)))


class NDCGMetric(_QueryMetric):
    """NDCG@k of each query (a stable descending sort of its scores), a
    query whose labels are all 0 counting as 1, averaged with the query
    weights."""

    names = ["ndcg"]
    bigger_is_better = True

    def __init__(self, config):
        super().__init__(config)
        lg = list(config.label_gain) if config.label_gain else list(default_label_gain())
        self.label_gain = np.asarray(lg, np.float64)

    def eval(self, score, objective):
        s = np.asarray(score, np.float64)
        li = self.label.astype(np.int64)
        ks = self.eval_at
        totals = np.zeros(len(ks))
        for q in range(self.num_queries):
            lo, hi = int(self.qb[q]), int(self.qb[q + 1])
            lab = li[lo:hi]
            qw = 1.0 if self.query_weights is None else float(self.query_weights[q])
            ideal = np.sort(lab)[::-1]
            ranked = lab[np.argsort(-s[lo:hi], kind="stable")]
            for j, k in enumerate(ks):
                kk = min(k, hi - lo)
                disc = dcg_discount(np.arange(kk))
                maxdcg = float(np.sum(self.label_gain[ideal[:kk]] * disc))
                if maxdcg <= 0:
                    totals[j] += qw
                else:
                    totals[j] += qw * float(np.sum(self.label_gain[ranked[:kk]] * disc)) / maxdcg
        return [("ndcg@%d" % k, float(totals[j] / self.sum_query_weights), True)
                for j, k in enumerate(ks)]


class MapMetric(_QueryMetric):
    """Mean average precision @k (a label above 0 is relevant), averaged
    with the query weights."""

    names = ["map"]
    bigger_is_better = True

    def eval(self, score, objective):
        s = np.asarray(score, np.float64)
        li = (self.label > 0).astype(np.int64)
        ks = self.eval_at
        totals = np.zeros(len(ks))
        for q in range(self.num_queries):
            lo, hi = int(self.qb[q]), int(self.qb[q + 1])
            qw = 1.0 if self.query_weights is None else float(self.query_weights[q])
            rel = li[lo:hi][np.argsort(-s[lo:hi], kind="stable")]
            hits = np.cumsum(rel)
            prec_at = hits / (np.arange(len(rel)) + 1.0)
            for j, k in enumerate(ks):
                kk = min(k, hi - lo)
                nrel = int(hits[kk - 1]) if kk > 0 else 0
                ap = 0.0
                if nrel > 0:
                    ap = float(np.sum(prec_at[:kk] * rel[:kk]) / np.minimum(kk, max(int(hits[-1]), 1)))
                totals[j] += qw * ap
        return [("map@%d" % k, float(totals[j] / self.sum_query_weights), True)
                for j, k in enumerate(ks)]


_METRICS = {
    "l2": L2Metric,
    "mean_squared_error": L2Metric,
    "mse": L2Metric,
    "regression": L2Metric,
    "rmse": RMSEMetric,
    "root_mean_squared_error": RMSEMetric,
    "l2_root": RMSEMetric,
    "l1": L1Metric,
    "mean_absolute_error": L1Metric,
    "mae": L1Metric,
    "regression_l1": L1Metric,
    "quantile": QuantileMetric,
    "huber": HuberLossMetric,
    "fair": FairLossMetric,
    "poisson": PoissonMetric,
    "gamma": GammaMetric,
    "gamma_deviance": GammaDevianceMetric,
    "gamma-deviance": GammaDevianceMetric,
    "tweedie": TweedieMetric,
    "mape": MAPEMetric,
    "mean_absolute_percentage_error": MAPEMetric,
    "binary_logloss": BinaryLoglossMetric,
    "binary": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
    "multi_logloss": MultiLoglossMetric,
    "multiclass": MultiLoglossMetric,
    "softmax": MultiLoglossMetric,
    "multiclassova": MultiLoglossMetric,
    "multi_error": MultiErrorMetric,
    "xentropy": CrossEntropyMetric,
    "cross_entropy": CrossEntropyMetric,
    "xentlambda": CrossEntropyLambdaMetric,
    "cross_entropy_lambda": CrossEntropyLambdaMetric,
    "kldiv": KLDivMetric,
    "kullback_leibler": KLDivMetric,
    "ndcg": NDCGMetric,
    "lambdarank": NDCGMetric,
    "map": MapMetric,
    "mean_average_precision": MapMetric,
}


def create_metric(name: str, config: Config) -> Optional[Metric]:
    """The metric named ``name``; an unknown name warns and gives None, which
    the Booster drops (lightgbm_tpu/metric.py ``create_metric``)."""
    cls = _METRICS.get(name)
    if cls is None:
        log.warning("Unknown metric type name: %s" % name)
        return None
    return cls(config)


def default_metric_for_objective(objective: str) -> str:
    """Config::GetMetricType's default: the metric named as the objective."""
    return objective
