"""Public Dataset / Booster handles of the PyTorch port.

The surface of lightgbm_tpu/basic.py: a lazily binned ``Dataset`` (a
validation set bins with its ``reference``'s mappers; a ``subset`` gathers
its rows out of the reference's bins; query groups through ``group=``,
``set_group`` or ``set_field``; label, weight and init score by field; an
init-score predictor for continued training, ``set_predictor``) and a
``Booster`` that trains (``update``, with a custom objective's gradients
through ``fobj``; ``update_chunk``), rolls back, predicts, evaluates its
training and validation metrics, and writes, dumps or loads LightGBM
model text. A Dataset also takes a pandas DataFrame (``category`` columns
as their codes, the category lists kept with the model as
``pandas_categorical``) or a path: a CSV, TSV or LibSVM file with its
``.weight``, ``.query`` and ``.init`` sidecars (io.py), or a binary file of
``save_binary``. A Booster predicts raw scores, leaves, SHAP
contributions (the TreeSHAP kernel) and with prediction early stopping,
refits its leaves on new data (``refit``), and runs on ``device`` ("cuda"
unless the caller asks for "cpu"; the ``device``/``device_type`` param key
sets it too), raising when CUDA is asked for and absent.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch

from .config import Config
from .dataset import (
    BinnedDataset, Metadata, construct_dataset, is_binary_dataset_file, load_binary_dataset,
    save_binary_dataset,
)
from .metric import Metric, create_metric, default_metric_for_objective
from .models.gbdt import GBDT
from .models.model_text import dump_model_to_json, load_model_from_string, save_model_to_string
from .objective import create_objective, objective_from_model_string
from .utils import log
from .utils.log import LightGBMError
from .utils.vfile import vopen


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


def _data_from_pandas(data, feature_name="auto", categorical_feature="auto",
                      pandas_categorical=None):
    """A DataFrame as (f64 matrix, names, categorical columns, category lists),
    as lightgbm_tpu/basic.py ``_data_from_pandas`` gives it; None when
    ``data`` is no DataFrame. ``category`` columns become their codes (NaN
    for missing and unseen values); the category lists are taken from the
    frame when ``pandas_categorical`` is None (training) and applied again
    otherwise (prediction, validation), so codes stay aligned."""
    if not (hasattr(data, "dtypes") and hasattr(data, "columns")):
        return None
    df = data
    names = [str(c) for c in df.columns] if feature_name == "auto" else list(feature_name)
    cat_cols = [c for c in df.columns if str(df[c].dtype) == "category"]
    if categorical_feature == "auto":
        categorical = [str(c) for c in cat_cols]
    else:
        categorical = list(categorical_feature)
    if pandas_categorical is None:  # training
        pandas_categorical = [list(df[c].cat.categories) for c in cat_cols]
    elif len(cat_cols) != len(pandas_categorical):  # prediction
        raise LightGBMError(
            "train and predict data have a different number of categorical columns"
        )
    out = np.empty(df.shape, np.float64)
    for j, c in enumerate(df.columns):
        col = df[c]
        if str(col.dtype) == "category":
            cats = pandas_categorical[cat_cols.index(c)]
            codes = col.cat.set_categories(cats).cat.codes.to_numpy().astype(np.float64)
            codes[codes < 0] = np.nan  # unseen category / NaN -> missing
            out[:, j] = codes
        else:
            try:
                out[:, j] = col.to_numpy(dtype=np.float64, na_value=np.nan)
            except (TypeError, ValueError):
                log.fatal(
                    "DataFrame.dtypes must be int, float, bool or category; "
                    "column %r is %s" % (str(c), col.dtype)
                )
    return out, names, categorical, pandas_categorical


def _dense(data, pandas_categorical=None) -> np.ndarray:
    """Raw rows as a 2-D f64 matrix: a scipy matrix densified, a DataFrame
    coded with the category lists ``pandas_categorical``."""
    from_pandas = _data_from_pandas(data, pandas_categorical=pandas_categorical or [])
    if from_pandas is not None:
        return from_pandas[0]
    if hasattr(data, "toarray"):
        data = data.toarray()
    arr = np.asarray(data)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    return arr.astype(np.float64, copy=False)


def _mappers_json(mappers) -> str:
    """The BinMappers as one JSON text, NaN bounds written as NaN: two lists
    of them compare equal where their values do (a list compare with ``!=``
    finds two NaN floats unequal)."""
    return json.dumps([m.to_dict() for m in mappers], sort_keys=True,
                      default=lambda o: o.item())


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
        #: the reference's rows this Dataset holds (:meth:`subset`), else None
        self.used_indices: Optional[np.ndarray] = None
        self._predictor: Optional[GBDT] = None  # continued training's init scores
        self.pandas_categorical = None  # a DataFrame's category lists, column by column

    def create_valid(self, data, label=None, weight=None, group=None, init_score=None,
                     params: Optional[Dict] = None) -> "Dataset":
        """A validation Dataset binned with this one's mappers."""
        return Dataset(data, label=label, reference=self, weight=weight, group=group,
                       init_score=init_score, params=params or self.params)

    def subset(self, used_indices, params: Optional[Dict] = None) -> "Dataset":
        """The rows ``used_indices`` of this Dataset, binned with its mappers
        and bundles (:meth:`construct_subset` on first use), as ``cv``'s
        folds take them."""
        sub = Dataset(None, reference=self, params=params or self.params)
        sub.used_indices = np.asarray(used_indices)
        return sub

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
        if self.used_indices is not None:
            self._binned = self.construct_subset(config)
            if self._predictor is not None:
                self._binned.metadata.init_score = self._predictor_raw_scores(self.get_data())
            return self
        if isinstance(self.data, str) and self._load_file(config):
            return self
        if self.reference is not None and self.pandas_categorical is None:
            # a validation set codes its frame with the training set's categories
            self.pandas_categorical = self.reference.construct(config).pandas_categorical
        from_pandas = _data_from_pandas(self.data, self.feature_name, self.categorical_feature,
                                        self.pandas_categorical)
        if from_pandas is not None:
            data, names, cats, self.pandas_categorical = from_pandas
        else:
            data = self.data
            names = list(self.feature_name) if isinstance(self.feature_name, (list, tuple)) else None
            cats = None  # indices, names or a comma-joined string, read as lightgbm_tpu/basic.py reads them
            if isinstance(self.categorical_feature, (list, tuple)):
                cats = list(self.categorical_feature)
            elif self.categorical_feature not in (None, "auto"):
                cats = self.categorical_feature
        ref = None if self.reference is None else self.reference.get_binned(config)
        init_score = self.init_score
        if self._predictor is not None:
            init_score = self._predictor_raw_scores(data)
        self._binned = construct_dataset(
            data,
            config,
            label=None if self.label is None else np.asarray(self.label, np.float64),
            weight=None if self.weight is None else np.asarray(self.weight, np.float64),
            group=None if self.group is None else np.asarray(self.group),
            init_score=init_score,
            feature_names=names,
            categorical_feature=cats,
            reference=ref,
        )
        return self

    def _load_file(self, config: Config) -> bool:
        """Construct from the path ``self.data`` (lightgbm_tpu/basic.py:142-216):
        a binary file of ``save_binary`` directly (True: nothing is left to
        do; fatal when its BinMappers differ from its reference's), else the
        text file through io.py, its label and its ``.weight``, ``.query`` and
        ``.init`` sidecars taking the place of fields not given (False: the
        rows go on to binning)."""
        path = self.data
        if is_binary_dataset_file(path):
            self._binned = load_binary_dataset(path)
            self._apply_metadata_overrides(self._binned.metadata)
            if self.reference is not None:
                ours = _mappers_json(self._binned.mappers)
                if ours != _mappers_json(self.reference.get_binned(config).mappers):
                    log.fatal(
                        "Binary dataset file %r was binned with different "
                        "BinMappers than its reference dataset; re-save it "
                        "with reference= set, or pass the raw data instead" % (path,)
                    )
            return True
        if config.two_round and self.reference is None:
            raise NotImplementedError(
                "Dataset(<file>, two_round=True): the streaming two-round loader "
                "(lightgbm_tpu/dist_loader.py) is not ported to lightgbm_tpu_torch yet"
            )
        from .io import load_sidecar, load_text_file

        X, y, names = load_text_file(path, has_header=config.header,
                                     label_column=config.label_column)
        if self.label is None and y is not None:
            self.label = y
        if self.weight is None:
            self.weight = load_sidecar(path, "weight")
        if self.group is None:
            g = load_sidecar(path, "query")
            self.group = None if g is None else g.astype(np.int64)
        if self.init_score is None:
            self.init_score = load_sidecar(path, "init")
        if names and self.feature_name == "auto":
            self.feature_name = names
        self.data = X
        return False

    def _apply_metadata_overrides(self, md: Metadata) -> None:
        """The label, weight, init score and group given to this Dataset over
        those its binary file carries (Metadata::Init)."""
        if self.label is not None:
            md.label = np.asarray(self.label, np.float32).reshape(-1)
        if self.weight is not None:
            md.weight = np.asarray(self.weight, np.float32).reshape(-1)
        if self.init_score is not None:
            md.init_score = np.asarray(self.init_score, np.float64)
        if self.group is not None:
            md.query_boundaries = Metadata(md.num_data, group=np.asarray(self.group)).query_boundaries
        md._validate()

    def construct_subset(self, config: Config) -> BinnedDataset:
        """The subset's BinnedDataset (Dataset::CopySubset): the reference's
        bins gathered at ``used_indices`` on its mappers, groups and offsets;
        label, weight and init score (``[N]`` or class-major ``[K·N]``)
        taken at the same rows; query boundaries rebuilt from the rows' runs
        of query ids (the rows of a query must be contiguous)."""
        parent = self.reference.get_binned(config)
        pm, idx = parent.metadata, self.used_indices
        init_sub = None
        if pm.init_score is not None:
            isc = np.asarray(pm.init_score).reshape(-1)
            if len(isc) == parent.num_data:
                init_sub = isc[idx]
            else:
                init_sub = isc.reshape(-1, parent.num_data)[:, idx].reshape(-1)
        md = Metadata(len(idx),
                      label=None if pm.label is None else pm.label[idx],
                      weight=None if pm.weight is None else pm.weight[idx],
                      init_score=init_sub)
        if pm.query_boundaries is not None:
            qid = np.searchsorted(pm.query_boundaries, idx, side="right") - 1
            sizes = np.diff(np.concatenate([[0], np.nonzero(np.diff(qid))[0] + 1, [len(qid)]]))
            md.query_boundaries = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        return BinnedDataset(
            parent.bins[:, idx], parent.mappers, parent.used_feature_idx,
            parent.num_total_features, md, feature_names=parent.feature_names,
            monotone_constraints=parent.monotone_constraints, group_id=parent.group_id,
            bin_offset=parent.bin_offset, max_group_bins=parent._max_group_bins,
        )

    def get_binned(self, config: Config) -> BinnedDataset:
        return self.construct(config)._binned

    def num_data(self) -> int:
        if self._binned is not None:
            return self._binned.num_data
        if self.used_indices is not None:
            return len(self.used_indices)
        if isinstance(self.data, str):
            return self.construct()._binned.num_data
        return self.data.shape[0] if hasattr(self.data, "shape") else len(self.data)

    def num_feature(self) -> int:
        if self._binned is not None:
            return self._binned.num_total_features
        if self.used_indices is not None:
            return self.reference.num_feature()
        if isinstance(self.data, str):
            return self.construct()._binned.num_total_features
        shape = getattr(self.data, "shape", None)
        if shape is not None:
            return shape[1] if len(shape) == 2 else 1
        return _dense(self.data[:1]).shape[1]

    def get_data(self):
        """The raw rows as passed in; a subset's are its reference's rows at
        ``used_indices`` (None when the reference has none)."""
        if self.reference is not None and self.used_indices is not None:
            ref_data = self.reference.get_data()
            if ref_data is None or isinstance(ref_data, str):
                return None  # a path: the reference keeps no rows until constructed
            if hasattr(ref_data, "iloc"):  # a DataFrame: rows by position
                return ref_data.iloc[self.used_indices]
            return ref_data[self.used_indices]
        return self.data

    def get_ref_chain(self, ref_limit: int = 100) -> set:
        """The Datasets reachable through ``reference`` links, this one included."""
        head, chain = self, set()
        while isinstance(head, Dataset) and len(chain) < ref_limit:
            chain.add(head)
            head = head.reference
        return chain

    # -- continued training (lightgbm_tpu/basic.py set_predictor) ----------
    def _predictor_raw_scores(self, data) -> np.ndarray:
        """The predictor's raw scores of ``data`` as init scores (``[N]`` or
        class-major ``[K·N]`` f64): its per-tree f32 replay
        (``GBDT.warmstart_scores``, the parent run's score carry bit for
        bit), else (random forest, DART) its f64 ``predict_raw``."""
        X = _dense(data, self.pandas_categorical)
        ws = self._predictor.warmstart_scores(X)
        if ws is not None:
            return (ws.reshape(-1) if ws.shape[0] > 1 else ws[0]).astype(np.float64)
        raw = self._predictor.predict_raw(X)
        return raw.T.reshape(-1) if raw.ndim == 2 else raw

    def set_predictor(self, booster: Optional["Booster"]) -> "Dataset":
        """Take the init scores from ``booster``'s predictions of these rows
        (at construction, or now when the Dataset is constructed)."""
        self._predictor = booster._gbdt if booster is not None else None
        if self._predictor is not None and self._binned is not None:
            data = self.get_data()
            if data is None:
                log.fatal("Cannot set an init-score predictor on a Dataset without raw data")
            self._binned.metadata.init_score = self._predictor_raw_scores(data)
        return self

    # -- fields (lightgbm_tpu/basic.py:327-390) -----------------------------
    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._binned is not None:
            self._binned.metadata.label = np.asarray(label, np.float32).reshape(-1)
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._binned is not None and weight is not None:
            self._binned.metadata.weight = np.asarray(weight, np.float32).reshape(-1)
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self._binned is not None and init_score is not None:
            md = self._binned.metadata
            md.init_score = np.asarray(init_score, np.float64)
            md._validate()
        return self

    def set_group(self, group) -> "Dataset":
        """The query sizes (or one query id a row); on a constructed Dataset
        its query boundaries are replaced too."""
        self.group = group
        if self._binned is not None and group is not None:
            md = self._binned.metadata
            md.query_boundaries = Metadata(md.num_data, group=np.asarray(group)).query_boundaries
        return self

    def get_label(self):
        """The binned f32 labels once constructed, else the labels given."""
        if self._binned is not None:
            return self._binned.metadata.label
        return self.label

    def get_weight(self):
        return self.weight

    def get_init_score(self):
        return self.init_score

    def get_group(self):
        return self.group

    def set_field(self, field_name: str, data) -> "Dataset":
        """Set ``label``, ``weight``, ``init_score`` or ``group`` (alias
        ``query``) by name."""
        setter = {"label": self.set_label, "weight": self.set_weight,
                  "init_score": self.set_init_score, "group": self.set_group,
                  "query": self.set_group}.get(field_name)
        if setter is None:
            raise LightGBMError("Unknown field name: %s" % field_name)
        return setter(data)

    def get_field(self, field_name: str):
        """``label``, ``weight``, ``init_score`` or ``group`` (alias ``query``)."""
        getter = {"label": self.get_label, "weight": self.get_weight,
                  "init_score": self.get_init_score, "group": self.get_group,
                  "query": self.get_group}.get(field_name)
        if getter is None:
            raise LightGBMError("Unknown field name: %s" % field_name)
        return getter()

    def set_feature_name(self, feature_name) -> "Dataset":
        """Name the columns; a constructed Dataset checks the count first."""
        if self._binned is not None and isinstance(feature_name, (list, tuple)):
            if len(feature_name) != self._binned.num_total_features:
                raise LightGBMError("Length of feature_name(%d) and num_feature(%d) don't match"
                                    % (len(feature_name), self._binned.num_total_features))
            self._binned.feature_names = list(feature_name)
        self.feature_name = feature_name
        return self

    # -- files and columns (lightgbm_tpu/basic.py:488-575) ---------------------
    def save_binary(self, filename: str) -> "Dataset":
        """Write the binned Dataset as a binary file (``save_binary_dataset``)
        that either package loads back with its bins and mappers."""
        self.construct()
        save_binary_dataset(self._binned, filename)
        return self

    def dump_text(self, filename: str) -> "Dataset":
        """Write the raw rows as text, ``%.17g`` comma-separated."""
        if self.used_indices is None:
            self.construct()
        data = self.get_data()
        if data is None or isinstance(data, str):
            raise LightGBMError(
                "Cannot dump_text: the Dataset keeps no raw rows "
                "(freed, or loaded from a binary dataset file)"
            )
        arr = _dense(data, self.pandas_categorical)
        with vopen(filename, "w") as fh:
            for row in arr:
                fh.write(",".join("%.17g" % v for v in row) + "\n")
        return self

    def add_features_from(self, other: "Dataset") -> "Dataset":
        """Append the columns of ``other`` (constructed, unbundled, with as
        many rows) to this constructed Dataset: its bins, mappers and names
        (a name already taken gets ``_1`` appended) and monotone constraints
        (Dataset::AddFeaturesFrom)."""
        if self._binned is None or other._binned is None:
            raise LightGBMError("Both source and target Datasets must be constructed before "
                                "adding features")
        a, b = self._binned, other._binned
        if a.num_data != b.num_data:
            raise LightGBMError(
                "Cannot add features from other Dataset with a different number of rows (%d vs %d)"
                % (b.num_data, a.num_data))
        if a.is_bundled or b.is_bundled:
            raise LightGBMError(
                "Cannot add features to/from an EFB-bundled Dataset (disable "
                "enable_bundle to use add_features_from)")
        wide = np.promote_types(a.bins.dtype, b.bins.dtype)
        off = a.num_total_features
        a.bins = np.concatenate([a.bins.astype(wide, copy=False), b.bins.astype(wide, copy=False)])
        a.mappers = list(a.mappers) + list(b.mappers)
        a.used_feature_idx = list(a.used_feature_idx) + [off + j for j in b.used_feature_idx]
        a.num_total_features += b.num_total_features
        seen, merged = set(a.feature_names), []
        for name in b.feature_names:
            while name in seen:
                name = name + "_1"
            seen.add(name)
            merged.append(name)
        a.feature_names = list(a.feature_names) + merged
        if a.monotone_constraints or b.monotone_constraints:
            a.monotone_constraints = (list(a.monotone_constraints or [0] * off)
                                      + list(b.monotone_constraints or [0] * b.num_total_features))
        return self

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        """Declare the categorical columns; a constructed Dataset bins again
        from its raw rows on next use."""
        if self.categorical_feature == categorical_feature:
            return self
        if self._binned is not None:
            if self.data is None:
                raise LightGBMError("Cannot set categorical feature after freed raw data")
            self._binned = None
        self.categorical_feature = categorical_feature
        return self


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
        self._valid_slots: List[int] = []  # each tracked Dataset's index in the GBDT's valid lists
        self._attrs: Dict[str, str] = {}
        self._train_data_name = "training"
        self.pandas_categorical = None  # the training frame's category lists
        if train_set is not None:
            binned = train_set.get_binned(self.config)
            self.pandas_categorical = train_set.pandas_categorical
            objective = create_objective(self.config)
            cls = _boosting_class(self.config.boosting)
            self._gbdt = cls(self.config, binned, objective, self._make_metrics(), device=self.device)
        elif model_file is not None or model_str is not None:
            if model_file is not None:
                with open(model_file) as fh:
                    model_str = fh.read()
            self._load(model_str)
        else:
            raise LightGBMError("Booster needs train_set, model_file or model_str")

    def _load(self, text: str) -> None:
        text, self.pandas_categorical = _strip_pandas_tail(text)
        self._gbdt = load_model_from_string(text, GBDT, self.config)
        self._gbdt.device = self.device
        self._gbdt.objective = objective_from_model_string(
            getattr(self._gbdt, "loaded_objective", None), self.config
        )

    def _make_metrics(self) -> List[Metric]:
        """The metrics of ``metric`` (default: the objective's), without
        ``custom`` (``feval`` only) and without names no metric has (they
        warn), as lightgbm_tpu/basic.py ``_make_metrics``."""
        names = self.config.metric or [default_metric_for_objective(self.config.objective)]
        metrics = [create_metric(n, self.config) for n in names
                   if n not in ("", "None", "na", "null", "custom")]
        return [m for m in metrics if m is not None]

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Attach ``data`` as a validation set named ``name``; a Dataset
        without a reference takes the training set as its reference. Its raw
        rows are read only when the model holds trees with no bin-space copy
        (loaded from text, or an ``init_model``'s)."""
        if data.reference is None and data is not self.train_set:
            data.set_reference(self.train_set)

        def raw_rows():
            raw = data.get_data()
            return None if raw is None or isinstance(raw, str) else _dense(
                raw, self.pandas_categorical)

        self._gbdt.add_valid(data.get_binned(self.config), self._make_metrics(), name,
                             raw_data=raw_rows)
        self._valid_datasets.append(data)
        self._valid_slots.append(len(self._gbdt.valid_names) - 1)
        return self

    def update(self, train_set: Optional[Dataset] = None, fobj=None) -> bool:
        """One boosting iteration; True when training stopped (no split).
        With ``fobj``, the custom objective ``fobj(scores, train_set) ->
        (grad, hess)`` gives the gradients: it is handed the training scores
        (``[N]``, or class-major ``[K·N]`` for K trees an iteration, f64
        values of the f32 scores, read back after the last iteration) and
        the training Dataset, as lightgbm_tpu/basic.py ``update`` does."""
        if train_set is not None and train_set is not self.train_set:
            raise NotImplementedError("Booster.update(train_set=) with another training set is "
                                      "not ported to lightgbm_tpu_torch yet")
        if fobj is None:
            return self._gbdt.train_one_iter()
        score = self._gbdt.train_score()
        grad, hess = fobj(score.reshape(-1), self.train_set)
        return self._gbdt.train_one_iter(np.asarray(grad), np.asarray(hess))

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

    def num_model_per_iteration(self) -> int:
        return self._gbdt.num_tree_per_iteration

    def num_feature(self) -> int:
        return self._gbdt.max_feature_idx + 1

    def feature_name(self) -> List[str]:
        if self._gbdt.train_set is not None:
            return self._gbdt.train_set.feature_names
        return getattr(self._gbdt, "feature_names", [])

    def eval_train(self, feval=None) -> List:
        return self._eval_set(self._gbdt.train_score(), self._train_data_name,
                              self._gbdt.training_metrics, feval, self.train_set)

    def eval_valid(self, feval=None) -> List:
        slot_ds = dict(zip(self._valid_slots, self._valid_datasets))
        return [entry for i, name in enumerate(self._gbdt.valid_names)
                for entry in self._eval_set(self._gbdt._valid_score_np(i), name,
                                            self._gbdt.valid_metrics[i], feval, slot_ds.get(i))]

    def eval(self, data: Dataset, name: str, feval=None) -> List:
        """Evaluate on ``data``: the training set, an attached validation
        set, or a new one (attached first, as the reference does)."""
        if data is self.train_set:
            return self.eval_train(feval)
        if not any(ds is data for ds in self._valid_datasets):
            self.add_valid(data, name)
        i = next(self._valid_slots[p] for p, ds in enumerate(self._valid_datasets) if ds is data)
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

    # -- attributes and bookkeeping (lightgbm_tpu/basic.py:450-519) ----------
    def attr(self, key: str):
        """A string attribute, or None when unset."""
        return self._attrs.get(key)

    def set_attr(self, **kwargs) -> "Booster":
        """Set (a string) or delete (None) attributes."""
        for key, value in kwargs.items():
            if value is None:
                self._attrs.pop(key, None)
            elif isinstance(value, str):
                self._attrs[key] = value
            else:
                raise LightGBMError("Only string values are accepted")
        return self

    def set_train_data_name(self, name: str) -> "Booster":
        self._train_data_name = name
        return self

    def free_dataset(self) -> "Booster":
        """Drop the Booster's references to its Datasets; the model still
        predicts, saves and trains from the binned copies it holds."""
        self.train_set = None
        self._valid_datasets, self._valid_slots = [], []
        return self

    def model_from_string(self, model_str: str, verbose: bool = True) -> "Booster":
        """Replace the model by one parsed from ``model_str``."""
        self._load(model_str)
        self.free_dataset()
        if verbose:
            log.info("Finished loading model, total used %d iterations" % self._gbdt.current_iteration)
        return self

    def shuffle_models(self, start_iteration: int = 0, end_iteration: int = -1) -> "Booster":
        """Shuffle the order of the iterations in [start, end) (GBDT::ShuffleModels)."""
        self._gbdt.shuffle_models(start_iteration, end_iteration)
        return self

    def get_split_value_histogram(self, feature, bins=None):
        """numpy.histogram of the thresholds of ``feature`` (index or name)
        over the model's numerical splits: (counts, bin_edges)."""
        if isinstance(feature, str):
            names = self.feature_name()
            if feature not in names:
                raise LightGBMError("Unknown feature name: %s" % feature)
            feature = names.index(feature)
        values = [float(t.threshold[node]) for t in self._gbdt.trees()
                  for node in range(max(t.num_leaves - 1, 0))
                  if int(t.split_feature[node]) == feature and not t._is_categorical(node)]
        return np.histogram(np.asarray(values, np.float64), bins="auto" if bins is None else bins)

    def get_leaf_output(self, tree_id: int, leaf_id: int) -> float:
        """The value of leaf ``leaf_id`` of tree ``tree_id``."""
        return float(self._gbdt.trees()[tree_id].leaf_value[leaf_id])

    def predict(self, data, num_iteration: int = -1, raw_score: bool = False,
                pred_leaf: bool = False, pred_contrib: bool = False, **kwargs) -> np.ndarray:
        """Scores of ``data``: ``[N]``, or ``[N, K]`` for a model of K trees
        an iteration (multiclass), through the objective's output
        conversion unless ``raw_score``; with ``pred_leaf`` each row's leaf
        in each tree, ``[N, T]`` int32 (GBDT.predict_leaf_index); with
        ``pred_contrib`` the SHAP contributions, ``[N, F + 1]`` or ``[N,
        K·(F + 1)]`` (GBDT.predict_contrib). ``num_iteration`` <= 0 (the
        default) takes every tree, as the JAX package does; a positive value
        takes the first ``num_iteration`` iterations, None the first
        ``best_iteration`` (``train`` sets it: the early-stopping best, else
        every iteration it trained). ``pred_early_stop`` (with
        ``pred_early_stop_freq`` and ``pred_early_stop_margin``, or the
        params of the same names) stops the rows whose margin passed the
        threshold, for binary, multiclass, multiclassova and cross_entropy
        models, as lightgbm_tpu/basic.py ``predict`` dispatches it. A
        DataFrame is coded with the model's category lists; a scipy sparse
        matrix is densified, as the JAX package's ``_to_2d_float`` does."""
        if isinstance(data, np.ndarray) and data.ndim == 1:
            raise LightGBMError("Input numpy.ndarray must be 2 dimensional")
        X = _dense(data, self.pandas_categorical)
        if X.shape[1] != self.num_feature():
            raise LightGBMError(
                "The number of features in data (%d) is not the same as it "
                "was in training data (%d)" % (X.shape[1], self.num_feature())
            )
        if num_iteration is None:
            num_iteration = self.best_iteration
        if pred_leaf:
            return self._gbdt.predict_leaf_index(X, num_iteration)
        if pred_contrib:
            return self._gbdt.predict_contrib(X, num_iteration)
        early_stop = None
        obj_name = self._gbdt.objective.name if self._gbdt.objective is not None else ""
        if kwargs.get("pred_early_stop", self.config.pred_early_stop) and obj_name in (
                "binary", "multiclass", "multiclassova", "cross_entropy"):
            from .prediction_early_stop import create_prediction_early_stop_instance

            early_stop = create_prediction_early_stop_instance(
                "multiclass" if self._gbdt.num_tree_per_iteration > 1 else "binary",
                int(kwargs.get("pred_early_stop_freq", self.config.pred_early_stop_freq)),
                float(kwargs.get("pred_early_stop_margin", self.config.pred_early_stop_margin)),
            )
        return self._gbdt.predict(X, num_iteration, raw_score=raw_score, early_stop=early_stop)

    def refit(self, data, label, decay_rate: float = 0.9, **kwargs) -> "Booster":
        """A new Booster with this model's trees refit on ``data`` and
        ``label`` (lightgbm_tpu/basic.py ``refit``): each tree keeps its
        structure and its leaves become ``decay_rate·old + (1 -
        decay_rate)·new``, the new values from the gradients of this model's
        objective, whose name and parameters are parsed from its
        ``to_string()``, with its class count; on this Booster's device."""
        if self._gbdt.objective is None:
            raise LightGBMError("Cannot refit due to null objective function.")
        leaf_preds = self.predict(data, num_iteration=-1, pred_leaf=True, **kwargs)
        params = dict(self.params)
        tokens = self._gbdt.objective.to_string().split()
        params.setdefault("objective", tokens[0])
        for tok in tokens[1:]:
            if ":" in tok:
                k, v = tok.split(":", 1)
                params.setdefault(k, v)
            elif tok == "sqrt":
                params.setdefault("reg_sqrt", True)
        params.setdefault("num_class", self._gbdt.num_class)
        new_booster = Booster(params, Dataset(data, label=label, params=params), device=self.device)
        if new_booster._gbdt.num_tree_per_iteration != self._gbdt.num_tree_per_iteration:
            raise LightGBMError(
                "Cannot refit: the new objective trains %d models per iteration "
                "but the loaded model has %d"
                % (new_booster._gbdt.num_tree_per_iteration, self._gbdt.num_tree_per_iteration))
        new_booster._gbdt.merge_models_from(self._gbdt)
        new_booster._gbdt.refit(np.asarray(leaf_preds), decay_rate)
        return new_booster

    def save_drift_reference(self, model_filename: str):
        """The JAX package's drift sidecar (``<model>.drift.json``): the drift
        monitor is not ported."""
        raise NotImplementedError("Booster.save_drift_reference: the feature-drift monitor "
                                  "(lightgbm_tpu/serve/drift.py) is not ported to "
                                  "lightgbm_tpu_torch yet")

    def to_packed(self, num_iteration: int = -1, device=None):
        """Compile this model into a :class:`~lightgbm_tpu_torch.serve.PackedEnsemble`
        on ``device`` (default: the Booster's) for batch inference: one
        traversal launch a request batch instead of a host walk a tree. The
        exact path of the returned object reproduces ``predict`` bit for bit."""
        from .serve.packed import pack_booster

        return pack_booster(self, num_iteration=num_iteration, device=device)

    def model_to_string(self, num_iteration: int = -1, start_iteration: int = 0) -> str:
        """The model text with the ``pandas_categorical:`` JSON line the
        python package appends (``null`` without a DataFrame)."""
        try:
            tail = json.dumps(self.pandas_categorical)
        except TypeError:
            raise LightGBMError(
                "pandas categorical columns must hold JSON-serializable "
                "categories (str/int/float/bool) to save the model"
            )
        return save_model_to_string(self._gbdt, start_iteration, num_iteration) + \
            "\npandas_categorical:%s\n" % tail

    def save_model(self, filename: str, num_iteration: int = -1) -> "Booster":
        with open(filename, "w") as fh:
            fh.write(self.model_to_string(num_iteration))
        return self

    def dump_model(self, num_iteration: int = -1) -> dict:
        """The model as the JSON dict of GBDT::DumpModel."""
        return dump_model_to_json(self._gbdt, num_iteration)

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


def _strip_pandas_tail(text: str):
    """(the model text without its trailing ``pandas_categorical:`` line,
    the category lists that line holds as JSON, or None)."""
    marker = "\npandas_categorical:"
    pos = text.rfind(marker)
    if pos < 0:
        return text, None
    end = text.find("\n", pos + 1)
    payload = text[pos + len(marker):end if end > 0 else None]
    try:
        categorical = json.loads(payload)
    except ValueError:
        raise LightGBMError("Model file has a corrupt pandas_categorical record: %r" % payload[:80])
    return text[:pos] + (text[end:] if end > 0 else ""), categorical
