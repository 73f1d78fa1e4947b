"""Public Dataset / Booster handles of the PyTorch port.

The surface of lightgbm_tpu/basic.py that this slice uses: a lazily binned
``Dataset`` and a ``Booster`` that trains (``update``), predicts, evaluates
its training metrics and writes or loads LightGBM model text. A Booster
runs on ``device`` ("cuda" unless the caller asks for "cpu"; the
``device``/``device_type`` param key sets it too) and raises when CUDA is
asked for and absent.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .config import Config
from .dataset import BinnedDataset, construct_dataset
from .metric import Metric, create_metric
from .models.gbdt import GBDT
from .models.model_text import load_model_from_string, save_model_to_string
from .objective import create_objective, objective_from_model_string
from .utils.log import LightGBMError


def resolve_device(device=None) -> torch.device:
    """``device`` ("cuda", "gpu", "cpu" or a torch.device; None = "cuda")."""
    if device is None:
        device = "cuda"
    if isinstance(device, str) and device.lower() == "gpu":
        device = "cuda"
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("device must be cuda or cpu, got %s" % device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device=cuda was asked for but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return dev


class Dataset:
    """Lazy binned dataset: bins on first use with the booster's config."""

    def __init__(
        self,
        data,
        label=None,
        weight=None,
        init_score=None,
        feature_name="auto",
        categorical_feature="auto",
        params: Optional[Dict] = None,
    ) -> None:
        self.data = data
        self.label = label
        self.weight = weight
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params) if params else {}
        self._binned: Optional[BinnedDataset] = None

    def construct(self, config: Optional[Config] = None) -> "Dataset":
        if self._binned is not None:
            return self
        if config is None:
            config = Config.from_params(self.params)
        if self.categorical_feature not in (None, "auto", "", []):
            raise NotImplementedError("categorical_feature is not ported yet")
        self._binned = construct_dataset(
            self.data,
            config,
            label=None if self.label is None else np.asarray(self.label, np.float64),
            weight=None if self.weight is None else np.asarray(self.weight, np.float64),
            init_score=self.init_score,
            feature_names=list(self.feature_name)
            if isinstance(self.feature_name, (list, tuple)) else None,
        )
        return self

    def get_binned(self, config: Config) -> BinnedDataset:
        return self.construct(config)._binned

    def num_data(self) -> int:
        return self._binned.num_data if self._binned is not None else len(self.data)


class Booster:
    """Training/prediction handle."""

    def __init__(
        self,
        params: Optional[Dict] = None,
        train_set: Optional[Dataset] = None,
        model_file: Optional[str] = None,
        model_str: Optional[str] = None,
        device=None,
    ) -> None:
        params = dict(params) if params else {}
        if device is not None:
            params["device_type"] = str(device)
            params.pop("device", None)
        self.params = params
        self.config = Config.from_params(params)
        self.device = resolve_device(self.config.device_type)
        self.train_set = train_set
        if train_set is not None:
            binned = train_set.get_binned(self.config)
            objective = create_objective(self.config)
            names = self.config.metric or [self.config.objective]
            metrics = [create_metric(n, self.config) for n in names if n not in ("", "None", "na", "null")]
            self._gbdt = GBDT(self.config, binned, objective, metrics, device=self.device)
        elif model_file is not None or model_str is not None:
            if model_file is not None:
                with open(model_file) as fh:
                    model_str = fh.read()
            self._gbdt = load_model_from_string(_strip_pandas_tail(model_str), GBDT, self.config)
            self._gbdt.device = self.device
            self._gbdt.objective = objective_from_model_string(
                getattr(self._gbdt, "loaded_objective", None), self.config
            )
        else:
            raise LightGBMError("Booster needs train_set, model_file or model_str")

    def update(self) -> bool:
        """One boosting iteration; True when training stopped (no split)."""
        return self._gbdt.train_one_iter()

    @property
    def current_iteration(self) -> int:
        return self._gbdt.current_iteration

    def num_trees(self) -> int:
        return self._gbdt.num_trees()

    def num_feature(self) -> int:
        return self._gbdt.max_feature_idx + 1

    def eval_train(self) -> List:
        score = self._gbdt.train_score()
        return [
            ("training", name, val, bigger)
            for m in self._gbdt.training_metrics
            for name, val, bigger in m.eval(score, self._gbdt.objective)
        ]

    def predict(self, data, num_iteration: int = -1, raw_score: bool = False) -> np.ndarray:
        X = np.asarray(data, dtype=np.float64)
        if X.ndim != 2:
            raise LightGBMError("Input numpy.ndarray must be 2 dimensional")
        if X.shape[1] != self.num_feature():
            raise LightGBMError(
                "The number of features in data (%d) is not the same as it "
                "was in training data (%d)" % (X.shape[1], self.num_feature())
            )
        return self._gbdt.predict(X, num_iteration, raw_score=raw_score)

    def model_to_string(self, num_iteration: int = -1, start_iteration: int = 0) -> str:
        return save_model_to_string(self._gbdt, start_iteration, num_iteration) + "\npandas_categorical:null\n"

    def save_model(self, filename: str, num_iteration: int = -1) -> "Booster":
        with open(filename, "w") as fh:
            fh.write(self.model_to_string(num_iteration))
        return self

    def feature_importance(self, importance_type: str = "split", iteration: int = -1) -> np.ndarray:
        return self._gbdt.feature_importance(importance_type, iteration)


def _strip_pandas_tail(text: str) -> str:
    """Drop the trailing ``pandas_categorical:`` line the python package appends."""
    pos = text.rfind("\npandas_categorical:")
    if pos < 0:
        return text
    end = text.find("\n", pos + 1)
    return text[:pos] + (text[end:] if end > 0 else "")
