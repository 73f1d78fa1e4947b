"""Margin-based prediction early stopping; the PyTorch port's copy of
lightgbm_tpu/prediction_early_stop.py.

Counterpart of the reference's per-row early exit (prediction_early_stop.cpp,
include/LightGBM/prediction_early_stop.h): every ``round_period``
iterations the rows whose margin passed the threshold stop taking trees
(``GBDT.predict_raw(early_stop=)`` keeps the active rows). The callbacks
take the active rows' raw scores as an ``[N, K]`` f64 tensor and give an
``[N]`` bool tensor, True where the row stops: binary on 2·|score|,
multiclass on the difference of the two largest scores.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class PredictionEarlyStopInstance(NamedTuple):
    """(callback, round_period): callback maps [N, K] raw scores to an [N]
    bool "stop" mask."""

    callback: Callable[[torch.Tensor], torch.Tensor]
    round_period: int


def _none_instance() -> PredictionEarlyStopInstance:
    return PredictionEarlyStopInstance(
        lambda pred: torch.zeros(pred.shape[0], dtype=torch.bool, device=pred.device),
        2 ** 31 - 1,
    )


def _binary_instance(margin_threshold: float, round_period: int) -> PredictionEarlyStopInstance:
    def cb(pred: torch.Tensor) -> torch.Tensor:
        if pred.shape[1] != 1:
            raise ValueError("Binary early stopping needs predictions to be of length one")
        return 2.0 * pred[:, 0].abs() > margin_threshold

    return PredictionEarlyStopInstance(cb, round_period)


def _multiclass_instance(margin_threshold: float, round_period: int) -> PredictionEarlyStopInstance:
    def cb(pred: torch.Tensor) -> torch.Tensor:
        if pred.shape[1] < 2:
            raise ValueError(
                "Multiclass early stopping needs predictions to be of length two or larger"
            )
        top = torch.topk(pred, 2, dim=1).values
        return top[:, 0] - top[:, 1] > margin_threshold

    return PredictionEarlyStopInstance(cb, round_period)


def create_prediction_early_stop_instance(
    type_: str, round_period: int, margin_threshold: float
) -> PredictionEarlyStopInstance:
    """CreatePredictionEarlyStopInstance (prediction_early_stop.cpp:78-92)."""
    if type_ == "none":
        return _none_instance()
    if type_ == "binary":
        return _binary_instance(margin_threshold, round_period)
    if type_ == "multiclass":
        return _multiclass_instance(margin_threshold, round_period)
    raise ValueError("Unknown early stopping type: %s" % type_)
