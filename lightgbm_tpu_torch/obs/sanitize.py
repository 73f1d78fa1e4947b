"""Runtime sanitizer: exactness and concurrency tripwires, env-gated.

The port's copy of lightgbm_tpu/obs/sanitize.py, its lock mode.
``LIGHTGBM_TPU_SAN=locks`` (or ``=all`` / ``=1``) arms it; unset,
``make_lock`` returns a plain ``threading.Lock`` and ``transfer_scope``
hands back one shared nullcontext.

Modes
-----
``transfer``
    Not ported. In the JAX package it wraps JAX's host-to-device transfer
    guard around the serve dispatch; PyTorch has no such guard, so asking
    for it (``LIGHTGBM_TPU_SAN=transfer``) raises NotImplementedError.
    ``transfer_scope`` stays a site marker (serve/cache.py's dispatch), as
    it is in the JAX package with the mode off.

``nan``
    Not ported: the JAX package checks the training score carry at chunk
    boundaries (its engine); ``LIGHTGBM_TPU_SAN=nan`` raises
    NotImplementedError.

``locks``
    :func:`make_lock` returns instrumented locks that record each thread's
    acquisition order into a process-global order graph and fail on the
    first lock-order inversion (lock B taken under A somewhere, A under B
    elsewhere: the shape of a deadlock).
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Dict, List, Optional, Tuple

from ..utils.log import LightGBMError

ENV_SAN = "LIGHTGBM_TPU_SAN"

#: the modes of the port, and the JAX package's modes it lacks
_ALL_MODES = ("locks",)
_UNPORTED_MODES = ("transfer", "nan")


class SanitizerError(LightGBMError):
    """A sanitizer tripwire fired (never raised when LIGHTGBM_TPU_SAN is unset)."""


def _parse_modes(raw: Optional[str]) -> frozenset:
    if raw is None:
        return frozenset()
    raw = raw.strip().lower()
    if raw in ("", "0", "off", "false"):
        return frozenset()
    if raw in ("1", "all", "on", "true"):
        return frozenset(_ALL_MODES)
    modes = frozenset(tok for tok in (t.strip() for t in raw.split(",")) if tok)
    unported = sorted(modes & frozenset(_UNPORTED_MODES))
    if unported:
        raise NotImplementedError(
            "%s=%s: the sanitizer's %s mode is not ported to lightgbm_tpu_torch (the transfer "
            "mode wraps JAX's transfer guard, which PyTorch lacks)"
            % (ENV_SAN, unported[0], unported[0])
        )
    unknown = modes - frozenset(_ALL_MODES)
    if unknown:
        raise LightGBMError(
            "%s: unknown sanitizer mode(s) %s (known: %s)"
            % (ENV_SAN, ", ".join(sorted(unknown)), ", ".join(_ALL_MODES + _UNPORTED_MODES))
        )
    return modes


#: armed modes, set at import; tests re-read them with :func:`refresh`
MODES: frozenset = frozenset()
LOCKS: bool = False


def refresh() -> frozenset:
    """Re-read LIGHTGBM_TPU_SAN; returns the armed mode set."""
    global MODES, LOCKS
    MODES = _parse_modes(os.environ.get(ENV_SAN))
    LOCKS = "locks" in MODES
    return MODES


refresh()

#: the one nullcontext every transfer_scope() call returns
_NULL = contextlib.nullcontext()


def transfer_scope(site: str = "dispatch"):
    """Marker of a region where every host-to-device copy is explicit
    (``site`` names it); a shared nullcontext in the port."""
    return _NULL


# --------------------------------------------------------------------------
# locks mode
# --------------------------------------------------------------------------
#: process-global lock-order graph: (id(a), id(b)) -> (name_a, name_b, where),
#: "b was acquired while holding a"; guarded by a plain meta-lock
_edges: Dict[Tuple[int, int], Tuple[str, str, str]] = {}
_meta = threading.Lock()
_tls = threading.local()


def _held_stack() -> List["_SanLock"]:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


class _SanLock:
    """A non-reentrant lock that records each thread's acquisition order
    and raises on the first lock-order inversion. Duck-types
    threading.Lock, so threading.Condition can wrap it."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()

    def _note_acquired(self) -> None:
        stack = _held_stack()
        me = id(self)
        for held in stack:
            h = id(held)
            if h == me:
                continue
            with _meta:
                back = _edges.get((me, h))
                if back is not None:
                    raise SanitizerError(
                        "sanitizer(locks): lock-order inversion — acquiring %r while "
                        "holding %r, but %r was previously acquired while holding %r "
                        "(at %s); pick one order and declare it (_LOCK_ORDER)"
                        % (self.name, held.name, back[1], back[0], back[2])
                    )
                _edges.setdefault((h, me), (held.name, self.name,
                                            threading.current_thread().name))
        stack.append(self)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            try:
                self._note_acquired()
            except SanitizerError:
                self._lock.release()
                raise
        return got

    def release(self) -> None:
        self._lock.release()
        stack = _held_stack()
        # the most recent entry of this lock (Condition.wait releases out of order)
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.release()

    def __repr__(self) -> str:
        return "<_SanLock %r %s>" % (self.name, "locked" if self.locked() else "unlocked")


def make_lock(name: str = "lock"):
    """The lock factory of the serve and obs stack: a plain
    ``threading.Lock`` unless the ``locks`` mode is armed, then an
    order-recording :class:`_SanLock`."""
    if not LOCKS:
        return threading.Lock()
    return _SanLock(name)


def lock_edges() -> List[Tuple[str, str]]:
    """The recorded acquisition-order edges (outer, inner)."""
    with _meta:
        return sorted(set((a, b) for (a, b, _w) in _edges.values()))


def reset_lock_graph() -> None:
    """Forget recorded orders (tests)."""
    with _meta:
        _edges.clear()
