"""Evaluation metrics: AUC, binary log-loss and binary error.

Copies of lightgbm_tpu/metric.py's ``AUCMetric``, ``BinaryLoglossMetric``
and ``BinaryErrorMetric``: host-side numpy in double precision over the raw
scores, with the objective's link applied inside the metric, so values, and
the early-stopping decisions made on them, agree with the JAX package's.
Each instance is initialised on the metadata of the set it evaluates (the
training set or one validation set). Other metrics are not ported yet and
raise.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .config import Config
from .dataset import Metadata
from .objective import ObjectiveFunction


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


class BinaryLoglossMetric(Metric):
    names = ["binary_logloss"]

    def eval(self, score, objective):
        s = np.asarray(score, np.float64)
        prob = objective.convert_output(s) if objective is not None else s
        p = np.clip(prob, 1e-15, 1.0 - 1e-15)
        is_pos = (self.label > 0).astype(np.float64)
        losses = -is_pos * np.log(p) - (1.0 - is_pos) * np.log(1.0 - p)
        if self.weight is not None:
            val = float(np.sum(losses * self.weight) / self.sum_weights)
        else:
            val = float(np.mean(losses))
        return [(self.names[0], val, self.bigger_is_better)]


class BinaryErrorMetric(Metric):
    names = ["binary_error"]

    def eval(self, score, objective):
        s = np.asarray(score, np.float64)
        prob = objective.convert_output(s) if objective is not None else s
        losses = ((prob > 0.5) != (self.label > 0)).astype(np.float64)
        if self.weight is not None:
            val = float(np.sum(losses * self.weight) / self.sum_weights)
        else:
            val = float(np.mean(losses))
        return [(self.names[0], val, self.bigger_is_better)]


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


_METRICS = {
    "binary_logloss": BinaryLoglossMetric,
    "binary": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
}


def create_metric(name: str, config: Config) -> Metric:
    cls = _METRICS.get(name)
    if cls is None:
        raise NotImplementedError(
            "metric=%s is not ported yet; only auc, binary_logloss and binary_error are" % name
        )
    return cls(config)
