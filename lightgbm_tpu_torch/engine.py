"""``train`` and ``cv``: the boosting loop entry points (lightgbm_tpu/engine.py's
``train``, ``_boost_loop``, ``cv`` and ``_make_n_folds``).

Validation sets, ``feval``, early stopping (``early_stopping_rounds`` or
the ``early_stopping_round`` param), ``evals_result``, ``verbose_eval``,
``learning_rates`` and ``callbacks`` run as in the JAX package: after every
boundary the training metrics (when a validation set is the training set,
or ``is_provide_training_metric``) and each validation set's metrics are
evaluated on the host, then the callbacks run in their ``order``. A custom
objective (``fobj``) sets ``objective="none"`` and steps one iteration at a
time; ``init_model`` (a model file or a Booster) continues its training:
its predictions seed the init scores (``Dataset.set_predictor``) and its
trees go in front (``GBDT._merge_from``). ``keep_training_booster`` is
accepted: the returned Booster always trains on. ``cv`` trains one Booster
a fold over ``Dataset.subset``. What is not ported raises
NotImplementedError naming the argument: the checkpoint, preempt and flex
arguments (and their params).
"""
from __future__ import annotations

import collections
import os
from typing import Callable, Dict, List, Optional, Union

import numpy as np

from . import callback as callback_mod
from .basic import Booster, Dataset
from .config import Config, coerce_bool

#: the JAX package's resilience arguments, refused here as arguments and as params
_UNPORTED = ("checkpoint_path", "checkpoint_rounds", "resume_from", "checkpoint_keep",
             "preempt_exit", "flex_plan")


def _refuse(name: str) -> None:
    raise NotImplementedError("train(%s=...) is not ported to lightgbm_tpu_torch yet" % name)


#: the flex controller's knobs, which carry no behaviour without ``flex_plan``
_FLEX_KNOBS = ("flex_dead_after_s", "flex_world", "flex_min_world", "flex_max_restarts",
               "flex_backoff_base_s", "flex_backoff_max_s", "flex_force_cpu", "flex_seed",
               "flex_max_launches", "flex_journal")
#: the JAX package's flight recorder and model stats switches (lightgbm_tpu/obs/flight.py,
#: lightgbm_tpu/obs/modelstats.py)
ENV_FLIGHT = "LIGHTGBM_TPU_FLIGHT"
ENV_MODELSTATS = "LIGHTGBM_TPU_MODELSTATS"


def _pop_observability(params: Dict) -> None:
    """Pop the flex knobs, ``flight_record`` and ``model_stats`` out of
    ``params`` as lightgbm_tpu/engine.py:88-113 does, so that the model's
    parameters footer stays the JAX package's; refuse by name what would
    record or publish anything (the flight recorder and the model stats are
    not ported yet)."""
    for name in _FLEX_KNOBS:
        params.pop(name, None)
    flight = str(params.pop("flight_record", "") or "") or os.environ.get(ENV_FLIGHT, "")
    if flight:
        raise NotImplementedError("flight_record (or %s) is not ported to lightgbm_tpu_torch yet"
                                  % ENV_FLIGHT)
    stats = coerce_bool(params.pop("model_stats", False))
    if stats or os.environ.get(ENV_MODELSTATS, "") not in ("", "0"):
        raise NotImplementedError("model_stats (or %s) is not ported to lightgbm_tpu_torch yet"
                                  % ENV_MODELSTATS)


def train(
    params: Dict,
    train_set: Dataset,
    num_boost_round: int = 100,
    valid_sets: Optional[List[Dataset]] = None,
    valid_names: Optional[List[str]] = None,
    fobj: Optional[Callable] = None,
    feval: Optional[Callable] = None,
    init_model=None,
    feature_name="auto",
    categorical_feature="auto",
    early_stopping_rounds: Optional[int] = None,
    evals_result: Optional[Dict] = None,
    verbose_eval: Union[bool, int] = True,
    learning_rates=None,
    keep_training_booster: bool = False,
    callbacks: Optional[List[Callable]] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_rounds: int = 0,
    resume_from: Optional[str] = None,
    checkpoint_keep: int = 0,
    preempt_exit: Optional[bool] = None,
    flex_plan: Optional[str] = None,
    device: Optional[str] = None,
) -> Booster:
    """Train ``num_boost_round`` iterations (or ``num_iterations`` in
    ``params``), stopping when a tree cannot split or early stopping fires
    (then ``best_iteration`` is the best one, 1-based). Runs on CUDA unless
    ``device="cpu"`` (or the ``device`` param) says otherwise.

    With ``device_chunk_size`` n > 1 and no fallback reason
    (``GBDT.device_chunk_fallback_reason``) the loop steps by chunks, as the
    reference's ``_boost_loop`` does: the first iteration alone, then whole
    chunks of n (``Booster.update_chunk``), then a tail shorter than a chunk
    one iteration at a time; evaluation and callbacks run at each
    boundary. Early stopping clamps the chunk to its window (also an
    ``early_stopping()`` handed in through ``callbacks``), and a
    before-iteration callback (``reset_parameter``, ``learning_rates``)
    makes every iteration a boundary."""
    params = Config.canonicalize(dict(params) if params else {})
    if "num_iterations" in params:
        num_boost_round = int(params.pop("num_iterations"))
    if "early_stopping_round" in params and early_stopping_rounds is None:
        early_stopping_rounds = int(params.pop("early_stopping_round"))
    given = dict(checkpoint_path=checkpoint_path, checkpoint_rounds=checkpoint_rounds,
                 resume_from=resume_from, checkpoint_keep=checkpoint_keep,
                 preempt_exit=preempt_exit, flex_plan=flex_plan)
    for name in _UNPORTED:
        if given[name] or params.pop(name, None):
            _refuse(name)
    _pop_observability(params)
    if fobj is not None:
        params["objective"] = "none"
    predictor = None
    if isinstance(init_model, str):
        predictor = Booster(model_file=init_model, device=device)
    elif isinstance(init_model, Booster):
        predictor = init_model
    init_iteration = predictor.current_iteration if predictor is not None else 0
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature
    if predictor is not None:
        train_set.set_predictor(predictor)

    booster = Booster(params, train_set, device=device)
    if predictor is not None:
        booster._gbdt._merge_from(predictor._gbdt)
    is_valid_contain_train = False
    if valid_sets is not None:
        if valid_names is None:
            valid_names = ["valid_%d" % i for i in range(len(valid_sets))]
        for vset, name in zip(valid_sets, valid_names):
            if vset is train_set:
                is_valid_contain_train = True
                booster._train_data_name = name
                continue
            booster.add_valid(vset, name)

    cbs = set(callbacks or [])
    if verbose_eval is True:
        cbs.add(callback_mod.print_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval > 0:
        cbs.add(callback_mod.print_evaluation(verbose_eval))
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.add(callback_mod.early_stopping(
            early_stopping_rounds, bool(params.get("first_metric_only", False)),
            verbose=bool(verbose_eval)))
    if learning_rates is not None:
        cbs.add(callback_mod.reset_parameter(learning_rate=learning_rates))
    if evals_result is not None:
        cbs.add(callback_mod.record_evaluation(evals_result))
    cbs_before = sorted((c for c in cbs if getattr(c, "before_iteration", False)),
                        key=lambda c: getattr(c, "order", 0))
    cbs_after = sorted((c for c in cbs if not getattr(c, "before_iteration", False)),
                       key=lambda c: getattr(c, "order", 0))

    chunk = 1
    if fobj is None and not cbs_before:
        chunk = booster._gbdt.device_chunk()
        for cb in cbs_after:
            window = getattr(cb, "stopping_rounds", 0)
            if chunk > 1 and isinstance(window, int) and window > 0:
                chunk = min(chunk, window)
    needs_eval = valid_sets is not None or booster.config.is_provide_training_metric
    results = _boost_loop(booster, params, fobj, feval, needs_eval, is_valid_contain_train,
                          init_iteration, num_boost_round, cbs_before, cbs_after, chunk)
    booster.best_score = collections.defaultdict(collections.OrderedDict)
    for dname, ename, value, _ in results:
        booster.best_score[dname][ename] = value
    if booster.best_iteration <= 0:
        booster.best_iteration = booster.current_iteration
    return booster


def _boost_loop(booster: Booster, params: Dict, fobj, feval, needs_eval: bool,
                is_valid_contain_train: bool, init_iteration: int, num_boost_round: int,
                cbs_before, cbs_after, chunk: int) -> List:
    """The boosting loop over iterations ``init_iteration`` (an init_model's
    iterations) to ``init_iteration + num_boost_round``; returns the last
    boundary's evaluation results (the best ones after an early stop)."""
    results: List = []
    i, end = init_iteration, init_iteration + num_boost_round
    while i < end:
        for cb in cbs_before:
            cb(callback_mod.CallbackEnv(booster, params, i, init_iteration, end, None))
        if chunk > 1 and end - i >= chunk:
            done, finished = booster.update_chunk(chunk)
            if done == 0:
                break
        else:
            done, finished = 1, booster.update(fobj=fobj)
        i += done
        results = []
        if needs_eval:
            if is_valid_contain_train:
                results.extend(booster.eval_train(feval))
            results.extend(booster.eval_valid(feval))
        try:
            for cb in cbs_after:
                cb(callback_mod.CallbackEnv(booster, params, i - 1, init_iteration, end, results,
                                            chunk=done))
        except callback_mod.EarlyStopException as stop:
            booster.best_iteration = stop.best_iteration + 1
            return stop.best_score
        if finished:
            break
    return results


class CVBooster:
    """The folds' Boosters of a ``cv`` run; a method called on it is called
    on each of them and gives the list of their results."""

    def __init__(self) -> None:
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def _append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler_function(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]

        return handler_function


def _make_n_folds(full_data: Dataset, folds, nfold: int, params: Dict, seed: int,
                  stratified: bool, shuffle: bool, config: Config):
    """The (train rows, test rows) of each fold, as the JAX package draws
    them from ``RandomState(seed)``: an sklearn-style ``folds`` object split
    on the labels (and the rows' query ids), else whole queries for query
    data, else folds stratified by label, else contiguous chunks of one
    permutation (or of the rows in order without ``shuffle``)."""
    full_data.construct(config)
    num_data = full_data.num_data()
    md = full_data._binned.metadata
    if folds is not None:
        if not hasattr(folds, "__iter__") and hasattr(folds, "split"):
            group_info = None
            if md.query_boundaries is not None:
                group_info = np.repeat(np.arange(md.num_queries), np.diff(md.query_boundaries))
            folds = folds.split(X=np.zeros(num_data), y=md.label, groups=group_info)
        return folds
    rng = np.random.RandomState(seed)
    if md.query_boundaries is not None:
        qb = md.query_boundaries
        qperm = rng.permutation(md.num_queries) if shuffle else np.arange(md.num_queries)
        out = []
        for fq in np.array_split(qperm, nfold):
            test_idx = np.concatenate([np.arange(qb[q], qb[q + 1]) for q in sorted(fq)]) \
                if len(fq) else np.array([], np.int64)
            out.append((np.setdiff1d(np.arange(num_data), test_idx), test_idx))
        return out
    if stratified:
        label = md.label.astype(np.int64)
        fold_of = np.zeros(num_data, np.int64)
        for cls in np.unique(label):
            idx = np.nonzero(label == cls)[0]
            if shuffle:
                idx = idx[rng.permutation(len(idx))]
            fold_of[idx] = np.arange(len(idx)) % nfold
        return [(np.nonzero(fold_of != k)[0], np.nonzero(fold_of == k)[0]) for k in range(nfold)]
    perm = rng.permutation(num_data) if shuffle else np.arange(num_data)
    return [(np.setdiff1d(np.arange(num_data), c), np.sort(c)) for c in np.array_split(perm, nfold)]


def cv(
    params: Dict,
    train_set: Dataset,
    num_boost_round: int = 100,
    folds=None,
    nfold: int = 5,
    stratified: bool = True,
    shuffle: bool = True,
    metrics=None,
    fobj=None,
    feval=None,
    init_model=None,
    feature_name="auto",
    categorical_feature="auto",
    early_stopping_rounds: Optional[int] = None,
    fpreproc=None,
    verbose_eval=None,
    show_stdv: bool = True,
    seed: int = 0,
    callbacks=None,
    eval_train_metric: bool = False,
    return_cvbooster: bool = False,
    device: Optional[str] = None,
) -> Dict:
    """Cross-validation, as lightgbm_tpu/engine.py ``cv``: one Booster a
    fold, trained on ``train_set.subset`` of the fold's training rows with
    its test rows as the validation set ``valid``, one iteration of every
    fold at a time (``fobj`` handed to each ``update``); each metric's mean
    and standard deviation over the folds (``"<metric>-mean"``,
    ``"<metric>-stdv"``) feed the callbacks (early stopping and
    ``print_evaluation(show_stdv=)`` on the means) and the returned lists,
    cut at the best iteration after an early stop. ``stratified`` holds
    only for the binary and multiclass objectives; ``metrics`` replaces the
    ``metric`` param. ``init_model``, ``feature_name``,
    ``categorical_feature``, ``fpreproc`` and ``eval_train_metric`` are
    taken and not used, as in the JAX package. Each fold runs on
    ``device`` (CUDA unless "cpu"), with a captured iteration of its own;
    ``return_cvbooster`` adds the folds' Boosters as ``"cvbooster"`` (a
    :class:`CVBooster`), as the reference python package does."""
    params = Config.canonicalize(dict(params) if params else {})
    if "num_iterations" in params:
        num_boost_round = int(params.pop("num_iterations"))
    if "early_stopping_round" in params and early_stopping_rounds is None:
        early_stopping_rounds = int(params.pop("early_stopping_round"))
    if metrics is not None:
        params["metric"] = metrics
    objective = str(params.get("objective", ""))
    if objective != "binary" and not objective.startswith("multiclass"):
        stratified = False
    config = Config.from_params(params)

    folds = _make_n_folds(train_set, folds, nfold, params, seed, stratified, shuffle, config)
    results = collections.defaultdict(list)
    cvbooster = CVBooster()
    for train_idx, test_idx in folds:
        booster = Booster(params, train_set.subset(np.sort(train_idx)), device=device)
        booster.add_valid(train_set.subset(np.sort(test_idx)), "valid")
        cvbooster._append(booster)

    cbs = set(callbacks or [])
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.add(callback_mod.early_stopping(early_stopping_rounds, verbose=False))
    if verbose_eval is True:
        cbs.add(callback_mod.print_evaluation(show_stdv=show_stdv))
    elif isinstance(verbose_eval, int) and verbose_eval:
        cbs.add(callback_mod.print_evaluation(verbose_eval, show_stdv))
    cbs = sorted(cbs, key=lambda c: getattr(c, "order", 0))

    for i in range(num_boost_round):
        agg: Dict = collections.defaultdict(list)
        for booster in cvbooster.boosters:
            booster.update(fobj=fobj)
            for dname, ename, v, bigger in booster.eval_valid(feval):
                agg[("%s %s" % (dname, ename), bigger)].append(v)
        res_list = []
        for (key, bigger), vals in agg.items():
            name = key.split(" ", 1)[1]
            mean, std = float(np.mean(vals)), float(np.std(vals))
            results[name + "-mean"].append(mean)
            results[name + "-stdv"].append(std)
            res_list.append(("cv_agg", name, mean, bigger, std))
        try:
            for cb in cbs:
                cb(callback_mod.CallbackEnv(None, params, i, 0, num_boost_round, res_list))
        except callback_mod.EarlyStopException as stop:
            cvbooster.best_iteration = stop.best_iteration + 1
            for key in list(results):
                results[key] = results[key][:cvbooster.best_iteration]
            break
    results = dict(results)
    if return_cvbooster:
        results["cvbooster"] = cvbooster
    return results
