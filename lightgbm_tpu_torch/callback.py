"""Training callbacks of the PyTorch port.

The callback contract of lightgbm_tpu/callback.py (itself the reference
python package's): ``print_evaluation``, ``record_evaluation``,
``reset_parameter`` and ``early_stopping`` factories, a ``CallbackEnv``
namedtuple handed to each callback, the ``order`` / ``before_iteration``
attributes ``engine.train`` schedules by, and ``EarlyStopException``. The
lines ``print_evaluation`` and the stopper print are the JAX package's,
character for character. Under chunked boosting (``device_chunk_size`` > 1)
callbacks run at chunk boundaries, ``iteration`` being the last iteration
of the chunk and ``env.chunk`` its length.
"""
from __future__ import annotations

import collections
import warnings
from typing import Callable, Dict, List

_CallbackEnvBase = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration", "evaluation_result_list"],
)


class CallbackEnv(_CallbackEnvBase):
    """The reference's 6-tuple; ``chunk`` (the iterations this boundary
    covers) rides as an attribute."""

    def __new__(cls, model, params, iteration, begin_iteration, end_iteration,
                evaluation_result_list, chunk: int = 1):
        self = super().__new__(cls, model, params, iteration, begin_iteration, end_iteration,
                               evaluation_result_list)
        self.chunk = chunk
        return self


class EarlyStopException(Exception):
    """Raised by a callback to stop boosting at ``best_iteration``."""

    def __init__(self, best_iteration: int, best_score) -> None:
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


def _fmt_entry(entry, show_stdv: bool = True) -> str:
    if len(entry) not in (4, 5):
        raise ValueError("Wrong metric value")
    text = "%s's %s: %g" % (entry[0], entry[1], entry[2])
    if len(entry) == 5 and show_stdv:
        text += " + %g" % entry[4]
    return text


def _fmt_line(entries, show_stdv: bool = True) -> str:
    return "\t".join(_fmt_entry(e, show_stdv) for e in entries)


def print_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    """Print the evaluation results every ``period`` iterations (at a chunk
    boundary whose window crossed a multiple of ``period``)."""

    def _callback(env: CallbackEnv) -> None:
        if period <= 0 or not env.evaluation_result_list:
            return
        shown_iter = env.iteration + 1
        step = max(getattr(env, "chunk", 1) or 1, 1)
        if shown_iter // period > (shown_iter - step) // period:
            print("[%d]\t%s" % (shown_iter, _fmt_line(env.evaluation_result_list, show_stdv)))

    _callback.order = 10  # type: ignore[attr-defined]
    return _callback


def record_evaluation(eval_result: Dict) -> Callable:
    """Append each boundary's values into ``eval_result`` in place, as
    {dataset_name: {metric_name: [v0, v1, ...]}}."""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")
    eval_result.clear()

    def _callback(env: CallbackEnv) -> None:
        for entry in env.evaluation_result_list:
            series = eval_result.setdefault(entry[0], collections.OrderedDict())
            series.setdefault(entry[1], []).append(entry[2])

    _callback.order = 20  # type: ignore[attr-defined]
    return _callback


def reset_parameter(**kwargs) -> Callable:
    """Set parameters before each boosting round: each keyword maps a
    parameter to a list (one value a round) or a callable of the round
    index. On the port only ``learning_rate`` and the split parameters take
    effect (``GBDT.reset_parameter``); the learning rate is a device scalar,
    so a schedule replays the captured iteration without capturing again."""

    def _resolve(name: str, schedule, round_idx: int, num_rounds: int):
        if isinstance(schedule, list):
            if len(schedule) != num_rounds:
                raise ValueError("Length of list %r has to equal to 'num_boost_round'." % name)
            return schedule[round_idx]
        if callable(schedule):
            return schedule(round_idx)
        raise ValueError(
            "Only list and callable values are supported "
            "as a mapping from boosting round index to new parameter value"
        )

    def _callback(env: CallbackEnv) -> None:
        round_idx = env.iteration - env.begin_iteration
        num_rounds = env.end_iteration - env.begin_iteration
        updates = {name: _resolve(name, schedule, round_idx, num_rounds)
                   for name, schedule in kwargs.items()}
        if updates:
            env.model.reset_parameter(updates)

    _callback.before_iteration = True  # type: ignore[attr-defined]
    _callback.order = 10  # type: ignore[attr-defined]
    return _callback


class _EarlyStopper:
    """Per-metric best trackers of :func:`early_stopping`."""

    def __init__(self, stopping_rounds: int, first_metric_only: bool, verbose: bool) -> None:
        self.stopping_rounds = stopping_rounds
        self.first_metric_only = first_metric_only
        self.verbose = verbose
        self.initialized = False
        self.active = True
        self.best_value: List[float] = []
        self.best_iter: List[int] = []
        self.best_entries: List = []
        self.improves: List[Callable] = []

    def _setup(self, env: CallbackEnv) -> None:
        self.initialized = True
        if any(env.params.get(a) == "dart" for a in ("boosting", "boosting_type", "boost")):
            # as in the JAX package: DART rescales past trees, so no
            # iteration's score stays the best one's
            self.active = False
            warnings.warn("Early stopping is not available in dart mode")
            return
        if not env.evaluation_result_list:
            raise ValueError(
                "For early stopping, at least one dataset and eval metric is required for evaluation"
            )
        if self.verbose:
            print("Training until validation scores don't improve for %d rounds." % self.stopping_rounds)
        for entry in env.evaluation_result_list:
            higher_better = bool(entry[3])
            self.best_value.append(float("-inf") if higher_better else float("inf"))
            self.best_iter.append(0)
            self.best_entries.append(None)
            self.improves.append(
                (lambda new, old: new > old) if higher_better else (lambda new, old: new < old)
            )

    def _stop(self, i: int, message: str) -> None:
        if self.verbose:
            print("%s\n[%d]\t%s" % (message, self.best_iter[i] + 1, _fmt_line(self.best_entries[i])))
        raise EarlyStopException(self.best_iter[i], self.best_entries[i])

    def __call__(self, env: CallbackEnv) -> None:
        if not self.initialized:
            self._setup(env)
        if not self.active:
            return
        for i, entry in enumerate(env.evaluation_result_list):
            value = entry[2]
            if self.best_entries[i] is None or self.improves[i](value, self.best_value[i]):
                self.best_value[i] = value
                self.best_iter[i] = env.iteration
                self.best_entries[i] = env.evaluation_result_list
            elif env.iteration - self.best_iter[i] >= self.stopping_rounds:
                self._stop(i, "Early stopping, best iteration is:")
            if env.iteration == env.end_iteration - 1:
                self._stop(i, "Did not meet early stopping. Best iteration is:")
            if self.first_metric_only:
                break


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True) -> Callable:
    """Stop training when no eval metric improves for ``stopping_rounds``."""
    stopper = _EarlyStopper(stopping_rounds, first_metric_only, verbose)

    def _callback(env: CallbackEnv) -> None:
        stopper(env)

    _callback.order = 30  # type: ignore[attr-defined]
    # engine.train clamps the chunk to this window
    _callback.stopping_rounds = stopping_rounds  # type: ignore[attr-defined]
    return _callback
