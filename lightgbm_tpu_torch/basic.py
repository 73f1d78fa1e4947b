"""Public Dataset / Booster handles of the PyTorch port.

The surface of lightgbm_tpu/basic.py that this slice uses: a lazily binned
``Dataset`` (a validation set bins with its ``reference``'s mappers; query
groups for ranking through ``group=``, ``set_group`` or ``set_field``) and a
``Booster`` that trains (``update``, ``update_chunk``), rolls back, predicts,
evaluates its training and validation metrics and writes or loads LightGBM
model text. A Booster
runs on ``device`` ("cuda" unless the caller asks for "cpu"; the
``device``/``device_type`` param key sets it too) and raises when CUDA is
asked for and absent.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .config import Config
from .dataset import BinnedDataset, Metadata, construct_dataset
from .metric import Metric, create_metric
from .models.gbdt import GBDT
from .models.model_text import load_model_from_string, save_model_to_string
from .objective import create_objective, objective_from_model_string
from .utils import log
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
    """Lazy binned dataset: bins on first use with the booster's config.
    With ``reference`` (the training Dataset) it bins with the reference's
    BinMappers, as a validation set must. ``group``: the query sizes in row
    order (they sum to the rows), or one query id a row."""

    def __init__(
        self,
        data,
        label=None,
        reference: Optional["Dataset"] = None,
        weight=None,
        group=None,
        init_score=None,
        feature_name="auto",
        categorical_feature="auto",
        params: Optional[Dict] = None,
    ) -> None:
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params) if params else {}
        self._binned: Optional[BinnedDataset] = None

    def create_valid(self, data, label=None, weight=None, group=None, init_score=None,
                     params: Optional[Dict] = None) -> "Dataset":
        """A validation Dataset binned with this one's mappers."""
        return Dataset(data, label=label, reference=self, weight=weight, group=group,
                       init_score=init_score, params=params or self.params)

    def set_reference(self, reference: "Dataset") -> "Dataset":
        if reference is not self.reference:
            if self._binned is not None:
                raise LightGBMError("Cannot set reference after the Dataset was constructed")
            self.reference = reference
        return self

    def construct(self, config: Optional[Config] = None) -> "Dataset":
        if self._binned is not None:
            return self
        if config is None:
            config = Config.from_params(self.params)
        cats = None  # indices, names or a comma-joined string, read as lightgbm_tpu/basic.py reads them
        if isinstance(self.categorical_feature, (list, tuple)):
            cats = list(self.categorical_feature)
        elif self.categorical_feature not in (None, "auto"):
            cats = self.categorical_feature
        ref = None if self.reference is None else self.reference.get_binned(config)
        self._binned = construct_dataset(
            self.data,
            config,
            label=None if self.label is None else np.asarray(self.label, np.float64),
            weight=None if self.weight is None else np.asarray(self.weight, np.float64),
            group=None if self.group is None else np.asarray(self.group),
            init_score=self.init_score,
            feature_names=list(self.feature_name)
            if isinstance(self.feature_name, (list, tuple)) else None,
            categorical_feature=cats,
            reference=ref,
        )
        return self

    def get_binned(self, config: Config) -> BinnedDataset:
        return self.construct(config)._binned

    def num_data(self) -> int:
        return self._binned.num_data if self._binned is not None else len(self.data)

    # -- query groups (lightgbm_tpu/basic.py:339-387) ----------------------
    def set_group(self, group) -> "Dataset":
        """The query sizes (or one query id a row); on a constructed Dataset
        its query boundaries are replaced too."""
        self.group = group
        if self._binned is not None and group is not None:
            md = self._binned.metadata
            md.query_boundaries = Metadata(md.num_data, group=np.asarray(group)).query_boundaries
        return self

    def get_group(self):
        return self.group

    def set_field(self, field_name: str, data) -> "Dataset":
        """Set the field ``group`` (alias ``query``) by name."""
        _check_group_field(field_name)
        return self.set_group(data)

    def get_field(self, field_name: str):
        """The field ``group`` (alias ``query``)."""
        _check_group_field(field_name)
        return self.get_group()


def _check_group_field(field_name: str) -> None:
    """Pass ``group`` and ``query``; raise for the JAX package's other
    fields (not ported) and for unknown names."""
    if field_name in ("group", "query"):
        return
    if field_name in ("label", "weight", "init_score"):
        raise NotImplementedError("Dataset.set_field/get_field(%r) is not ported to "
                                  "lightgbm_tpu_torch yet" % field_name)
    raise LightGBMError("Unknown field name: %s" % field_name)


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
        self.best_iteration = -1
        self.best_score: Dict = {}
        self._valid_datasets: List[Dataset] = []
        self._train_data_name = "training"
        if train_set is not None:
            binned = train_set.get_binned(self.config)
            objective = create_objective(self.config)
            cls = _boosting_class(self.config.boosting)
            self._gbdt = cls(self.config, binned, objective, self._make_metrics(), device=self.device)
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

    def _make_metrics(self) -> List[Metric]:
        names = self.config.metric or [self.config.objective]
        return [create_metric(n, self.config) for n in names
                if n not in ("", "None", "na", "null")]

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Attach ``data`` as a validation set named ``name``; a Dataset
        without a reference takes the training set as its reference."""
        if data.reference is None and data is not self.train_set:
            data.set_reference(self.train_set)
        self._gbdt.add_valid(data.get_binned(self.config), self._make_metrics(), name)
        self._valid_datasets.append(data)
        return self

    def update(self) -> bool:
        """One boosting iteration; True when training stopped (no split)."""
        return self._gbdt.train_one_iter()

    def update_chunk(self, n: int):
        """Up to ``n`` boosting iterations with nothing read back between
        them (GBDT.train_chunk); returns (iterations run, stopped). A single
        ``update()`` when ``n <= 1`` or chunking cannot run
        (``GBDT.device_chunk_fallback_reason``), so callers may loop on it."""
        if n <= 1 or self._gbdt.device_chunk_fallback_reason() is not None:
            return 1, self.update()
        return self._gbdt.train_chunk(n)

    def rollback_one_iter(self) -> "Booster":
        """Take the last iteration out of the model and every score."""
        self._gbdt.rollback_one_iter()
        return self

    def reset_parameter(self, params: Dict) -> "Booster":
        self.params.update(params)
        self._gbdt.reset_parameter(params)
        return self

    @property
    def current_iteration(self) -> int:
        return self._gbdt.current_iteration

    def num_trees(self) -> int:
        return self._gbdt.num_trees()

    def num_feature(self) -> int:
        return self._gbdt.max_feature_idx + 1

    def eval_train(self, feval=None) -> List:
        return self._eval_set(self._gbdt.train_score(), self._train_data_name,
                              self._gbdt.training_metrics, feval, self.train_set)

    def eval_valid(self, feval=None) -> List:
        return [entry for i, name in enumerate(self._gbdt.valid_names)
                for entry in self._eval_set(self._gbdt._valid_score_np(i), name,
                                            self._gbdt.valid_metrics[i], feval,
                                            self._valid_datasets[i])]

    def eval(self, data: Dataset, name: str, feval=None) -> List:
        """Evaluate on ``data``: the training set, an attached validation
        set, or a new one (attached first, as the reference does)."""
        if data is self.train_set:
            return self.eval_train(feval)
        if not any(ds is data for ds in self._valid_datasets):
            self.add_valid(data, name)
        i = next(i for i, ds in enumerate(self._valid_datasets) if ds is data)
        return self._eval_set(self._gbdt._valid_score_np(i), name, self._gbdt.valid_metrics[i],
                              feval, data)

    def _eval_set(self, score, name, metrics, feval, dataset) -> List:
        objective = self._gbdt.objective
        results = [(name, mname, val, bigger) for m in metrics
                   for mname, val, bigger in m.eval(score, objective)]
        if feval is not None:
            preds = score if objective is None else objective.convert_output(score)
            ret = feval(preds, dataset)
            if ret is not None:
                for mname, val, bigger in (ret if isinstance(ret, list) else [ret]):
                    results.append((name, mname, val, bigger))
        return results

    def predict(self, data, num_iteration: int = -1, raw_score: bool = False) -> np.ndarray:
        """Scores of ``data``: ``[N]``, or ``[N, K]`` for a model of K trees
        an iteration (multiclass), through the objective's output
        conversion unless ``raw_score``. ``num_iteration`` <= 0 (the
        default) takes every tree, as the JAX package does; a positive value
        takes the first ``num_iteration`` iterations, None the first
        ``best_iteration`` (``train`` sets it: the early-stopping best, else
        every iteration it trained). A scipy sparse matrix is densified,
        as the JAX package's ``_to_2d_float`` does."""
        if hasattr(data, "toarray"):
            data = data.toarray()
        X = np.asarray(data, dtype=np.float64)
        if X.ndim != 2:
            raise LightGBMError("Input numpy.ndarray must be 2 dimensional")
        if X.shape[1] != self.num_feature():
            raise LightGBMError(
                "The number of features in data (%d) is not the same as it "
                "was in training data (%d)" % (X.shape[1], self.num_feature())
            )
        if num_iteration is None:
            num_iteration = self.best_iteration
        return self._gbdt.predict(X, num_iteration, raw_score=raw_score)

    def model_to_string(self, num_iteration: int = -1, start_iteration: int = 0) -> str:
        return save_model_to_string(self._gbdt, start_iteration, num_iteration) + "\npandas_categorical:null\n"

    def save_model(self, filename: str, num_iteration: int = -1) -> "Booster":
        with open(filename, "w") as fh:
            fh.write(self.model_to_string(num_iteration))
        return self

    def feature_importance(self, importance_type: str = "split", iteration: int = -1) -> np.ndarray:
        return self._gbdt.feature_importance(importance_type, iteration)


def _boosting_class(name: str):
    """The trainer of ``boosting`` (its aliases canonicalised by Config), as
    lightgbm_tpu/basic.py ``_boosting_class`` picks it."""
    if name == "gbdt":
        return GBDT
    if name == "dart":
        from .models.dart import DART

        return DART
    if name == "goss":
        from .models.goss import GOSS

        return GOSS
    if name == "rf":
        from .models.rf import RandomForest

        return RandomForest
    log.fatal("Unknown boosting type %s" % name)


def _strip_pandas_tail(text: str) -> str:
    """Drop the trailing ``pandas_categorical:`` line the python package appends."""
    pos = text.rfind("\npandas_categorical:")
    if pos < 0:
        return text
    end = text.find("\n", pos + 1)
    return text[:pos] + (text[end:] if end > 0 else "")
