"""``train``: the boosting loop entry point (lightgbm_tpu/engine.py's
``train`` and ``_boost_loop`` for the arguments this slice runs).

Validation sets, ``feval``, early stopping (``early_stopping_rounds`` or
the ``early_stopping_round`` param), ``evals_result``, ``verbose_eval``,
``learning_rates`` and ``callbacks`` run as in the JAX package: after every
boundary the training metrics (when a validation set is the training set,
or ``is_provide_training_metric``) and each validation set's metrics are
evaluated on the host, then the callbacks run in their ``order``. What is
not ported raises NotImplementedError naming the argument: ``fobj``,
``init_model``, ``keep_training_booster=True``, the checkpoint, preempt and
flex arguments (and their params), and ``cv``.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Union

from . import callback as callback_mod
from .basic import Booster, Dataset
from .config import Config

#: the JAX package's resilience arguments, refused here as arguments and as params
_UNPORTED = ("checkpoint_path", "checkpoint_rounds", "resume_from", "checkpoint_keep",
             "preempt_exit", "flex_plan")


def _refuse(name: str) -> None:
    raise NotImplementedError("train(%s=...) is not ported to lightgbm_tpu_torch yet" % name)


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
        if given[name] or params.get(name):
            _refuse(name)
    if fobj is not None:
        _refuse("fobj")
    if init_model is not None:
        _refuse("init_model")
    if keep_training_booster:
        _refuse("keep_training_booster")
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature

    booster = Booster(params, train_set, device=device)
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
    if not cbs_before:
        chunk = booster._gbdt.device_chunk()
        for cb in cbs_after:
            window = getattr(cb, "stopping_rounds", 0)
            if chunk > 1 and isinstance(window, int) and window > 0:
                chunk = min(chunk, window)
    needs_eval = valid_sets is not None or booster.config.is_provide_training_metric
    results = _boost_loop(booster, params, feval, needs_eval, is_valid_contain_train,
                          num_boost_round, cbs_before, cbs_after, chunk)
    booster.best_score = collections.defaultdict(collections.OrderedDict)
    for dname, ename, value, _ in results:
        booster.best_score[dname][ename] = value
    if booster.best_iteration <= 0:
        booster.best_iteration = booster.current_iteration
    return booster


def _boost_loop(booster: Booster, params: Dict, feval, needs_eval: bool,
                is_valid_contain_train: bool, num_boost_round: int, cbs_before, cbs_after,
                chunk: int) -> List:
    """The boosting loop; returns the last boundary's evaluation results
    (the best ones after an early stop)."""
    results: List = []
    i, end = 0, num_boost_round
    while i < end:
        for cb in cbs_before:
            cb(callback_mod.CallbackEnv(booster, params, i, 0, end, None))
        if chunk > 1 and end - i >= chunk:
            done, finished = booster.update_chunk(chunk)
            if done == 0:
                break
        else:
            done, finished = 1, booster.update()
        i += done
        results = []
        if needs_eval:
            if is_valid_contain_train:
                results.extend(booster.eval_train(feval))
            results.extend(booster.eval_valid(feval))
        try:
            for cb in cbs_after:
                cb(callback_mod.CallbackEnv(booster, params, i - 1, 0, end, results, chunk=done))
        except callback_mod.EarlyStopException as stop:
            booster.best_iteration = stop.best_iteration + 1
            return stop.best_score
        if finished:
            break
    return results


def cv(*args, **kwargs):
    """Cross-validation is not ported yet."""
    raise NotImplementedError("cv is not ported to lightgbm_tpu_torch yet")
