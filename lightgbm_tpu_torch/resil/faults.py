"""Deterministic, env-gated fault injection.

The port's copy of lightgbm_tpu/resil/faults.py. Recovery paths (the serve
dispatch retry, the batcher's shutdown force-fail) are exercised in tests
by real induced failures at named sites:

    LIGHTGBM_TPU_FAULTS=site:occurrence[:action[:arg]][,spec...]

fires at the ``occurrence``-th execution (1-based) of ``maybe_fire(site)``.
Actions:

  * ``raise`` (default) — raise :class:`InjectedFault` (a RuntimeError, so
    handlers of client faults, LightGBMError/ValueError, pass it on to the
    device-failure path);
  * ``kill``            — ``SIGKILL`` the process;
  * ``hang``            — sleep ``arg`` seconds (default 30; a wedged
    worker for join-timeout paths).

Sites of the port:

  ``serve.dispatch``    serve model dispatch (serve/server.py ServeApp)
  ``serve.batcher``     batcher worker, per gathered batch (serve/batcher.py)

Occurrence counters are plain per-process integers, so one plan against
one workload fires at the same point every run. Disabled cost: one
``os.environ.get`` a site execution. Each fired spec is counted in the obs
registry (``resil_faults_fired_total{site=...}``).
"""
from __future__ import annotations

import os
import signal
import threading
import time
from typing import Dict, List, Tuple

ENV_FAULTS = "LIGHTGBM_TPU_FAULTS"

_ACTIONS = ("raise", "kill", "hang")


class InjectedFault(RuntimeError):
    """The error an injected ``raise`` fault surfaces as."""


class FaultPlanError(ValueError):
    """A malformed LIGHTGBM_TPU_FAULTS spec (fails loudly, not silently off)."""


_lock = threading.Lock()
_counts: Dict[str, int] = {}
_plan_env: str = ""
_plan: Dict[str, List[Tuple[int, str, str]]] = {}


def _parse(env: str) -> Dict[str, List[Tuple[int, str, str]]]:
    plan: Dict[str, List[Tuple[int, str, str]]] = {}
    for spec in env.split(","):
        spec = spec.strip()
        if not spec:
            continue
        parts = spec.split(":")
        if len(parts) < 2:
            raise FaultPlanError("fault spec %r needs site:occurrence[:action[:arg]]" % spec)
        site, occ_s = parts[0], parts[1]
        action = parts[2] if len(parts) > 2 else "raise"
        arg = parts[3] if len(parts) > 3 else ""
        try:
            occ = int(occ_s)
        except ValueError:
            raise FaultPlanError("fault spec %r: occurrence %r is not an int" % (spec, occ_s))
        if occ < 1:
            raise FaultPlanError("fault spec %r: occurrence must be >= 1" % spec)
        if action not in _ACTIONS:
            raise FaultPlanError("fault spec %r: unknown action %r (expected %s)"
                                 % (spec, action, "/".join(_ACTIONS)))
        plan.setdefault(site, []).append((occ, action, arg))
    return plan


def _current_plan() -> Dict[str, List[Tuple[int, str, str]]]:
    """The parsed plan of the current env value (tests change os.environ, so
    the cache is keyed on the raw string)."""
    global _plan_env, _plan
    env = os.environ.get(ENV_FAULTS, "")
    with _lock:
        if env != _plan_env:
            _plan = _parse(env) if env else {}
            _plan_env = env
            _counts.clear()
        return _plan


def enabled() -> bool:
    """True when a fault plan is set (the one gate ``maybe_fire`` uses)."""
    return bool(os.environ.get(ENV_FAULTS, ""))


def maybe_fire(site: str) -> None:
    """Count one execution of ``site``; fire the configured action when its
    occurrence number comes up. One env read when no plan is set."""
    if not enabled():
        # forget the cached plan and its counters when the env goes empty,
        # so re-arming the identical spec later fires again
        if _plan_env:
            reset()
        return
    specs = _current_plan().get(site)
    if not specs:
        return
    with _lock:
        _counts[site] = n = _counts.get(site, 0) + 1
    for occ, action, arg in specs:
        if occ == n:
            _fire(site, n, action, arg)


def _fire(site: str, occurrence: int, action: str, arg: str) -> None:
    from ..obs import registry as obs_registry
    from ..utils import log

    obs_registry.REGISTRY.counter("resil_faults_fired").inc(site=site)
    log.warning("faults: firing %r at site %r occurrence %d" % (action, site, occurrence))
    if action == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
        raise InjectedFault("SIGKILL at %s #%d did not kill" % (site, occurrence))
    if action == "hang":
        time.sleep(float(arg) if arg else 30.0)
        return
    raise InjectedFault("injected fault at %s #%d" % (site, occurrence))


def fire_count(site: str) -> int:
    """Executions of ``site`` counted so far (tests)."""
    with _lock:
        return _counts.get(site, 0)


def reset() -> None:
    """Forget occurrence counters and the parsed plan (tests)."""
    global _plan_env, _plan
    with _lock:
        _counts.clear()
        _plan_env = ""
        _plan = {}
