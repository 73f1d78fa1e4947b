"""Configuration / flag system (the PyTorch port's copy of lightgbm_tpu/config.py).

Counterpart of the reference's single ``Config`` struct + alias table
(LightGBM include/LightGBM/config.h:31-910, src/io/config_auto.cpp:10). All
parameters keep their LightGBM names and defaults; ``param_aliases`` mirrors the
generated alias table so user params written for LightGBM work unchanged.

Parsing precedence matches the reference (src/io/config.cpp:153): explicit key=value
pairs are alias-canonicalized first, conflicting duplicates keep the first occurrence
with a warning, then typed fields are set.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .utils import log

# Alias -> canonical name. Mirrors config_auto.cpp's alias_table.
PARAM_ALIASES: Dict[str, str] = {
    "config_file": "config",
    "task_type": "task",
    "objective_type": "objective",
    "app": "objective",
    "application": "objective",
    "boosting_type": "boosting",
    "boost": "boosting",
    "train": "data",
    "train_data": "data",
    "data_filename": "data",
    "test": "valid",
    "valid_data": "valid",
    "valid_filenames": "valid",
    "test_data": "valid",
    "num_iteration": "num_iterations",
    "num_tree": "num_iterations",
    "num_trees": "num_iterations",
    "num_round": "num_iterations",
    "num_rounds": "num_iterations",
    "num_boost_round": "num_iterations",
    "n_iter": "num_iterations",
    "n_estimators": "num_iterations",
    "shrinkage_rate": "learning_rate",
    "eta": "learning_rate",
    "num_leaf": "num_leaves",
    "max_leaves": "num_leaves",
    "max_leaf": "num_leaves",
    "tree": "tree_learner",
    "tree_type": "tree_learner",
    "tree_learner_type": "tree_learner",
    "num_thread": "num_threads",
    "nthread": "num_threads",
    "nthreads": "num_threads",
    "n_jobs": "num_threads",
    "device": "device_type",
    "random_seed": "seed",
    "random_state": "seed",
    "min_data_per_leaf": "min_data_in_leaf",
    "min_data": "min_data_in_leaf",
    "min_child_samples": "min_data_in_leaf",
    "min_sum_hessian_per_leaf": "min_sum_hessian_in_leaf",
    "min_sum_hessian": "min_sum_hessian_in_leaf",
    "min_hessian": "min_sum_hessian_in_leaf",
    "min_child_weight": "min_sum_hessian_in_leaf",
    "sub_row": "bagging_fraction",
    "subsample": "bagging_fraction",
    "bagging": "bagging_fraction",
    "subsample_freq": "bagging_freq",
    "bagging_fraction_seed": "bagging_seed",
    "sub_feature": "feature_fraction",
    "colsample_bytree": "feature_fraction",
    "early_stopping_rounds": "early_stopping_round",
    "early_stopping": "early_stopping_round",
    "max_tree_output": "max_delta_step",
    "max_leaf_output": "max_delta_step",
    "reg_alpha": "lambda_l1",
    "reg_lambda": "lambda_l2",
    "lambda": "lambda_l2",
    "min_split_gain": "min_gain_to_split",
    "rate_drop": "drop_rate",
    "topk": "top_k",
    "mc": "monotone_constraints",
    "monotone_constraint": "monotone_constraints",
    "feature_contrib": "feature_contri",
    "fc": "feature_contri",
    "fp": "feature_contri",
    "fs": "forcedsplits_filename",
    "forced_splits_filename": "forcedsplits_filename",
    "forced_splits_file": "forcedsplits_filename",
    "forced_splits": "forcedsplits_filename",
    "verbose": "verbosity",
    "subsample_for_bin": "bin_construct_sample_cnt",
    "hist_pool_size": "histogram_pool_size",
    "data_seed": "data_random_seed",
    "is_sparse": "is_enable_sparse",
    "enable_sparse": "is_enable_sparse",
    "sparse": "is_enable_sparse",
    "is_enable_bundle": "enable_bundle",
    "bundle": "enable_bundle",
    "is_pre_partition": "pre_partition",
    "two_round_loading": "two_round",
    "use_two_round_loading": "two_round",
    "is_save_binary": "save_binary",
    "is_save_binary_file": "save_binary",
    "has_header": "header",
    "label": "label_column",
    "weight": "weight_column",
    "group": "group_column",
    "group_id": "group_column",
    "query_column": "group_column",
    "query": "group_column",
    "query_id": "group_column",
    "ignore_feature": "ignore_column",
    "blacklist": "ignore_column",
    "cat_feature": "categorical_feature",
    "categorical_column": "categorical_feature",
    "cat_column": "categorical_feature",
    "predict_result": "output_result",
    "prediction_result": "output_result",
    "predict_name": "output_result",
    "prediction_name": "output_result",
    "pred_name": "output_result",
    "name_pred": "output_result",
    "is_predict_raw_score": "predict_raw_score",
    "predict_rawscore": "predict_raw_score",
    "raw_score": "predict_raw_score",
    "is_predict_leaf_index": "predict_leaf_index",
    "leaf_index": "predict_leaf_index",
    "is_predict_contrib": "predict_contrib",
    "contrib": "predict_contrib",
    "convert_model_file": "convert_model",
    "num_classes": "num_class",
    "unbalance": "is_unbalance",
    "unbalanced_sets": "is_unbalance",
    "metrics": "metric",
    "metric_types": "metric",
    "output_freq": "metric_freq",
    "is_metric_freq": "metric_freq",
    "is_training_metric": "is_provide_training_metric",
    "train_metric": "is_provide_training_metric",
    "ndcg_eval_at": "eval_at",
    "ndcg_at": "eval_at",
    "map_eval_at": "eval_at",
    "map_at": "eval_at",
    "num_machine": "num_machines",
    "local_port": "local_listen_port",
    "port": "local_listen_port",
    "machine_list_file": "machine_list_filename",
    "machine_list": "machine_list_filename",
    "mlist": "machine_list_filename",
    "workers": "machines",
    "nodes": "machines",
    "model_output": "output_model",
    "model_out": "output_model",
    "model_input": "input_model",
    "model_in": "input_model",
    "init_score_filename": "initscore_filename",
    "init_score_file": "initscore_filename",
    "init_score": "initscore_filename",
    "input_init_score": "initscore_filename",
    "valid_data_initscores": "valid_initscore_filename",
    "valid_init_score_file": "valid_initscore_filename",
    "valid_init_score": "valid_initscore_filename",
    "max_bins": "max_bin",
    "sigmoid_param": "sigmoid",
    "device_chunk": "device_chunk_size",
}

_OBJECTIVE_ALIASES = {
    "regression": "regression",
    "regression_l2": "regression",
    "l2": "regression",
    "mean_squared_error": "regression",
    "mse": "regression",
    "l2_root": "regression",
    "root_mean_squared_error": "regression",
    "rmse": "regression",
    "regression_l1": "regression_l1",
    "l1": "regression_l1",
    "mean_absolute_error": "regression_l1",
    "mae": "regression_l1",
    "huber": "huber",
    "fair": "fair",
    "poisson": "poisson",
    "quantile": "quantile",
    "mape": "mape",
    "mean_absolute_percentage_error": "mape",
    "gamma": "gamma",
    "tweedie": "tweedie",
    "binary": "binary",
    "multiclass": "multiclass",
    "softmax": "multiclass",
    "multiclassova": "multiclassova",
    "multiclass_ova": "multiclassova",
    "ova": "multiclassova",
    "ovr": "multiclassova",
    "xentropy": "xentropy",
    "cross_entropy": "xentropy",
    "xentlambda": "xentlambda",
    "cross_entropy_lambda": "xentlambda",
    "lambdarank": "lambdarank",
    "rank_xendcg": "lambdarank",
    "none": "none",
    "null": "none",
    "custom": "none",
    "na": "none",
}

_BOOSTING_ALIASES = {
    "gbdt": "gbdt",
    "gbrt": "gbdt",
    "dart": "dart",
    "goss": "goss",
    "rf": "rf",
    "random_forest": "rf",
}


@dataclass
class Config:
    """All training/prediction parameters, LightGBM-named (config.h:31-910)."""

    # --- core ---
    task: str = "train"
    objective: str = "regression"
    boosting: str = "gbdt"
    data: str = ""
    valid: List[str] = field(default_factory=list)
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    tree_learner: str = "serial"
    num_threads: int = 0
    device_type: str = "cuda"
    seed: int = 0

    # --- learning control ---
    max_depth: int = -1
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    bagging_fraction: float = 1.0
    bagging_freq: int = 0
    bagging_seed: int = 3
    feature_fraction: float = 1.0
    feature_fraction_seed: int = 2
    early_stopping_round: int = 0
    first_metric_only: bool = False
    max_delta_step: float = 0.0
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    xgboost_dart_mode: bool = False
    uniform_drop: bool = False
    drop_seed: int = 4
    top_rate: float = 0.2
    other_rate: float = 0.1
    min_data_per_group: int = 100
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4
    top_k: int = 20
    monotone_constraints: List[int] = field(default_factory=list)
    feature_contri: List[float] = field(default_factory=list)
    forcedsplits_filename: str = ""
    refit_decay_rate: float = 0.9
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    cegb_penalty_feature_lazy: List[float] = field(default_factory=list)
    cegb_penalty_feature_coupled: List[float] = field(default_factory=list)

    # --- IO ---
    verbosity: int = 1
    max_bin: int = 255
    min_data_in_bin: int = 3
    bin_construct_sample_cnt: int = 200000
    histogram_pool_size: float = -1.0
    data_random_seed: int = 1
    output_model: str = "LightGBM_model.txt"
    snapshot_freq: int = -1
    # Crash-safe training checkpoints (resil/checkpoint.py,
    # docs/FaultTolerance.md): full state (model text + score carries + RNG
    # position + early-stopping bests) saved atomically every
    # checkpoint_rounds iterations; resume_from restarts BIT-identically.
    # checkpoint_rounds <= 0 falls back to snapshot_freq (reference parity),
    # then to ~10 checkpoints per run (num_iterations // 10, min 1).
    checkpoint_path: str = ""
    checkpoint_rounds: int = -1
    resume_from: str = ""
    # Elastic training (docs/FaultTolerance.md §Elastic training):
    # checkpoint_keep=N retains the N newest archives (<path>, <path>.1 ...;
    # resume falls back loudly past a torn newest); preempt_exit=true makes
    # SIGTERM write an emergency boundary checkpoint and exit with the
    # documented preemption code 75 (EX_TEMPFAIL) that loop/bringup
    # auto-resume from (also armable via LIGHTGBM_TPU_PREEMPT=1).
    checkpoint_keep: int = 1
    preempt_exit: bool = False
    # Model/data observability (obs/flight.py, obs/modelstats.py,
    # docs/Observability.md): flight_record=<path> writes a JSONL run-event
    # log (manifest + per-iteration evals + per-tree gain/shape records);
    # model_stats=true publishes importance-evolution / bin-occupancy /
    # leaf-shape gauges and the model_stats run-report section. Both are
    # POPPED by engine.train so the model's parameters footer is identical
    # with observability on or off; LIGHTGBM_TPU_FLIGHT /
    # LIGHTGBM_TPU_MODELSTATS are the env spellings.
    flight_record: str = ""
    model_stats: bool = False
    input_model: str = ""
    output_result: str = "LightGBM_predict_result.txt"
    initscore_filename: str = ""
    valid_initscore_filename: List[str] = field(default_factory=list)
    pre_partition: bool = False
    enable_bundle: bool = True
    max_conflict_rate: float = 0.0
    is_enable_sparse: bool = True
    sparse_threshold: float = 0.8
    use_missing: bool = True
    zero_as_missing: bool = False
    two_round: bool = False
    save_binary: bool = False
    header: bool = False
    label_column: str = ""
    weight_column: str = ""
    group_column: str = ""
    ignore_column: str = ""
    categorical_feature: str = ""
    predict_raw_score: bool = False
    predict_leaf_index: bool = False
    predict_contrib: bool = False
    num_iteration_predict: int = -1
    pred_early_stop: bool = False
    pred_early_stop_freq: int = 10
    pred_early_stop_margin: float = 10.0
    convert_model_language: str = ""
    convert_model: str = "gbdt_prediction.cpp"

    # --- flex ---
    # Elastic fleet orchestration (lightgbm_tpu/flex/,
    # docs/FaultTolerance.md §Fleet orchestrator). flex_plan=<plan.json>
    # arms the in-train capacity watcher: a plan change drains at a chunk
    # boundary (checkpoint + exit 76) so `python -m lightgbm_tpu.flex` can
    # relaunch at the new world. Unset is provably inert (one env read;
    # LIGHTGBM_TPU_FLEX_PLAN is the env spelling). All flex_* params are
    # POPPED by engine.train so the model footer never depends on how a
    # run was orchestrated.
    flex_plan: str = ""
    # Heartbeat age (seconds) past which a silent rank counts as dead and
    # the survivors drain to reshard without it.
    flex_dead_after_s: float = 60.0
    # Controller knobs (consumed by `python -m lightgbm_tpu.flex`, ignored
    # by a plain train): initial world, the floor a reshard may shrink to,
    # the consecutive-rapid-restart cap, and the decorrelated-jitter
    # backoff window (resil/backoff.decorrelated) pacing relaunches.
    flex_world: int = 0
    flex_min_world: int = 1
    flex_max_restarts: int = 5
    flex_backoff_base_s: float = 0.5
    flex_backoff_max_s: float = 30.0
    # Forced-CPU worlds for the chaos smoke: each relaunch gets
    # XLA_FLAGS=--xla_force_host_platform_device_count=<world>.
    flex_force_cpu: bool = False

    # --- objective ---
    num_class: int = 1
    is_unbalance: bool = False
    scale_pos_weight: float = 1.0
    sigmoid: float = 1.0
    boost_from_average: bool = True
    reg_sqrt: bool = False
    alpha: float = 0.9
    fair_c: float = 1.0
    poisson_max_delta_step: float = 0.7
    tweedie_variance_power: float = 1.5
    max_position: int = 20
    label_gain: List[float] = field(default_factory=list)

    # --- metric ---
    metric: List[str] = field(default_factory=list)
    metric_freq: int = 1
    is_provide_training_metric: bool = False
    eval_at: List[int] = field(default_factory=lambda: [1, 2, 3, 4, 5])

    # --- network ---
    num_machines: int = 1
    local_listen_port: int = 12400
    time_out: int = 120
    machine_list_filename: str = ""
    machines: str = ""

    # --- GPU/TPU device knobs ---
    gpu_platform_id: int = -1
    gpu_device_id: int = -1
    gpu_use_dp: bool = False
    # TPU-only: rows per histogram chunk fed to the MXU one-hot pass.
    tpu_hist_chunk: int = 16384
    # TPU-only: use float64 histogram accumulation on host-check paths.
    tpu_use_dp: bool = False
    # TPU-only: per-leaf histogram mode — "bucketed" (default: segment-
    # permutation histograms whose cost tracks leaf size) or "masked"
    # (full-N masked passes; the differential oracle, ops/grow.py).
    tpu_hist_mode: str = "bucketed"
    # Operand type of the histogram kernels — "float32" (exact f32 products;
    # the tensor-core kernels split each value into three bf16 terms, never
    # TF32) or "bfloat16" (grad/hess/count round to bf16 before the f32
    # accumulation — the reference GPU path's single-precision trade,
    # GPU-Performance.rst:131). The plain ``scatter`` route ignores it.
    tpu_hist_dtype: str = "float32"
    # Device-resident boosting: fuse this many boosting iterations into ONE
    # jitted lax.scan dispatch (models/gbdt.py train_chunk). 1 = the
    # per-iteration host loop. >1 trades per-iteration callback/eval
    # granularity (they run at chunk boundaries) for the removal of the
    # host dispatch gap between iterations; tree sequences are bit-exact
    # either way. DART/GOSS/RF, custom objectives, CEGB, parallel learners
    # and the native CPU learner fall back to 1 automatically
    # (docs/DeviceResidentBoosting.md).
    device_chunk_size: int = 1
    # Histogram routing table: path to a measured shape -> kernel table
    # (written on the card by `python -m lightgbm_tpu_torch.obs.tune`),
    # which routes each histogram call of the run to the CUDA kernel that
    # won its (B, K, hist_dtype, row class) — cuda, cuda_onehot,
    # cuda_bitplane or cuda_packed4 (ops/hist_kernel.py). "" consults the
    # LIGHTGBM_TPU_HIST_TUNE env var; "off" disables both. A table of
    # another backend or device family is ignored with a warning. The table
    # is FROZEN per training run at setup; run provenance (not model
    # semantics), so it is excluded from the model's parameters footer
    # (NON_MODEL_PARAMS).
    hist_tune: str = ""

    # resolved, not user-set
    is_parallel: bool = False

    def __post_init__(self):
        self._check()

    def _check(self) -> None:
        if self.num_leaves < 2:
            log.fatal("num_leaves must be >= 2, got %d" % self.num_leaves)
        if self.max_bin < 2:
            log.fatal("max_bin must be >= 2, got %d" % self.max_bin)
        if not (0.0 < self.bagging_fraction <= 1.0):
            log.fatal("bagging_fraction must be in (0, 1], got %g" % self.bagging_fraction)
        if not (0.0 < self.feature_fraction <= 1.0):
            log.fatal("feature_fraction must be in (0, 1], got %g" % self.feature_fraction)
        if not (0.0 < self.alpha):
            log.fatal("alpha must be > 0, got %g" % self.alpha)
        if self.num_class < 1:
            log.fatal("num_class must be >= 1, got %d" % self.num_class)
        if self.device_chunk_size < 1:
            log.fatal(
                "device_chunk_size must be >= 1, got %d" % self.device_chunk_size
            )

    # -- parsing ---------------------------------------------------------

    @staticmethod
    def kv2map(args: List[str]) -> Dict[str, str]:
        """Parse CLI-style ``key=value`` tokens (config.h:78 KV2Map)."""
        out: Dict[str, str] = {}
        for arg in args:
            arg = arg.split("#", 1)[0].strip()
            if not arg:
                continue
            if "=" not in arg:
                log.warning("Unknown parameter format '%s', ignored" % arg)
                continue
            k, v = arg.split("=", 1)
            k, v = k.strip(), v.strip()
            if k in out:
                log.warning("Duplicate parameter '%s', keeping first value" % k)
                continue
            out[k] = v
        return out

    @staticmethod
    def canonicalize(params: Dict[str, Any]) -> Dict[str, Any]:
        """Alias-transform keys (ParameterAlias::KeyAliasTransform, config.h:868)."""
        out: Dict[str, Any] = {}
        for k, v in params.items():
            canonical = PARAM_ALIASES.get(k, k)
            if canonical in out and out[canonical] != v:
                log.warning(
                    "Parameter '%s' (alias of '%s') set multiple times, keeping first"
                    % (k, canonical)
                )
                continue
            out[canonical] = v
        return out

    @classmethod
    def from_params(cls, params: Dict[str, Any]) -> "Config":
        params = cls.canonicalize(dict(params))
        cfg = cls.__new__(cls)
        # defaults first
        for f in dataclasses.fields(cls):
            setattr(
                cfg,
                f.name,
                f.default_factory() if f.default is dataclasses.MISSING else f.default,  # type: ignore[misc]
            )
        known = {f.name: f for f in dataclasses.fields(cls)}
        for k, v in params.items():
            if k == "config":
                continue
            if k not in known:
                log.warning("Unknown parameter: %s" % k)
                continue
            setattr(cfg, k, _coerce(known[k], v))
        cfg.objective = _OBJECTIVE_ALIASES.get(cfg.objective, cfg.objective)
        cfg.boosting = _BOOSTING_ALIASES.get(cfg.boosting, cfg.boosting)
        cfg._check_conflicts()
        cfg._check()
        log.set_verbosity(cfg.verbosity)
        return cfg

    def _check_conflicts(self) -> None:
        """Mirror Config::CheckParamConflict (src/io/config.cpp:201)."""
        # tree_learner value aliases (GetTreeLearnerType, config.cpp:110):
        # "data_parallel" == "data" etc.; normalize once here so every
        # downstream dispatch matches the canonical short names
        _learner_alias = {
            "serial_tree_learner": "serial",
            "data_parallel": "data", "data_parallel_tree_learner": "data",
            "feature_parallel": "feature",
            "feature_parallel_tree_learner": "feature",
            "voting_parallel": "voting",
            "voting_parallel_tree_learner": "voting",
        }
        self.tree_learner = _learner_alias.get(self.tree_learner, self.tree_learner)
        if self.tree_learner not in ("serial", "data", "feature", "voting"):
            log.fatal("Unknown tree learner type %s" % self.tree_learner)
        if self.num_machines > 1:
            self.is_parallel = True
        if self.tree_learner in ("data", "feature", "voting"):
            self.is_parallel = True
        if self.is_parallel and self.num_machines == 1 and self.tree_learner != "serial":
            # single machine -> serial unless a mesh provides devices; the TPU
            # build resolves this at train time against the actual jax mesh.
            pass
        if self.objective in ("multiclass", "multiclassova") and self.num_class <= 1:
            log.fatal("Number of classes should be specified and greater than 1 for multiclass training")
        if self.objective not in ("multiclass", "multiclassova", "none") and self.num_class != 1:
            log.fatal("Number of classes must be 1 for non-multiclass training")

    def update(self, params: Dict[str, Any]) -> "Config":
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        d.pop("is_parallel", None)
        d.update(params)
        return Config.from_params(d)

    def to_dict(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


#: Config fields that are run provenance, not model semantics: the model
#: text's parameters footer skips them (models/model_text.py) so artifact
#: bytes cannot depend on where a tune cache happened to live — the tuned
#: run's identity is the flight manifest's hist_route_digest instead
#: (docs/HistogramRouting.md).
NON_MODEL_PARAMS = frozenset({"hist_tune"})


def coerce_bool(v: Any) -> bool:
    """The ONE truthy-string vocabulary for bool parameters (shared by the
    dataclass coercion below and engine.train's popped params, so a
    spelling Config accepts can never be rejected by the pop path)."""
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("true", "1", "yes", "+", "t", "y")


def _coerce(f: dataclasses.Field, v: Any):
    """Coerce a raw (possibly string) parameter value to the field's type."""
    ty = f.type
    if isinstance(v, str):
        sv = v.strip()
        if ty in ("int", int):
            return int(float(sv))
        if ty in ("float", float):
            return float(sv)
        if ty in ("bool", bool):
            return coerce_bool(sv)
        if str(ty).startswith("List[int]") or "List[int]" in str(ty):
            return [int(float(x)) for x in sv.replace(" ", ",").split(",") if x != ""]
        if "List[float]" in str(ty):
            return [float(x) for x in sv.replace(" ", ",").split(",") if x != ""]
        if "List[str]" in str(ty):
            return [x for x in sv.split(",") if x != ""]
        return sv
    if isinstance(v, bool):
        return v if ty in ("bool", bool) else v
    if ty in ("int", int) and not isinstance(v, int):
        return int(v)
    if ty in ("float", float):
        return float(v)
    if "List" in str(ty) and not isinstance(v, (list, tuple)):
        return [v]
    if isinstance(v, tuple):
        return list(v)
    return v


def load_config_file(path: str) -> Dict[str, str]:
    """Parse a LightGBM .conf file (``key = value`` lines, # comments)."""
    out: Dict[str, str] = {}
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out
