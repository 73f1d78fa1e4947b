"""Exponential backoff: the one retry-delay schedule of the port.

The port's copy of lightgbm_tpu/resil/backoff.py. The serve dispatch retry
(serve/server.py) draws its sleep from ``delays``; the retry loop itself
stays with its caller. Stdlib only.

Two opt-in extensions (the defaults keep the plain schedule):

  * ``jitter``/``seed`` — each delay is scaled by a factor drawn uniformly
    from ``[1 - jitter, 1 + jitter]``; with ``seed`` the stream is
    ``random.Random(seed)`` and so reproducible.
  * ``max_elapsed_s`` — a total sleep budget: the last delay is truncated
    to what remains of it and the schedule stops.
"""
from __future__ import annotations

import random
from typing import Iterator, Optional


def delays(
    attempts: int,
    base_s: float = 1.0,
    factor: float = 2.0,
    max_s: float = 60.0,
    jitter: float = 0.0,
    seed: Optional[int] = None,
    max_elapsed_s: Optional[float] = None,
) -> Iterator[float]:
    """The sleep (seconds) before each retry of an ``attempts``-attempt loop:
    up to ``attempts - 1`` values, ``base_s * factor**i`` capped at ``max_s``,
    optionally jittered (deterministically when ``seed`` is given) and
    bounded by the ``max_elapsed_s`` total budget. With ``jitter=0`` the
    schedule is deterministic, as the fault-injection tests need."""
    rng = random.Random(seed) if jitter > 0 else None
    elapsed = 0.0
    for i in range(max(attempts - 1, 0)):
        d = min(base_s * (factor ** i), max_s)
        if rng is not None:
            # scale, then re-cap: a jittered delay still honours max_s
            d = min(d * (1.0 + jitter * (2.0 * rng.random() - 1.0)), max_s)
        if max_elapsed_s is not None and elapsed + d >= max_elapsed_s:
            d = max_elapsed_s - elapsed
            if d > 0:
                yield d
            return
        elapsed += d
        yield d


def decorrelated(
    base_s: float = 1.0,
    max_s: float = 60.0,
    seed: Optional[int] = None,
) -> Iterator[float]:
    """Decorrelated-jitter schedule: ``sleep_n = min(max_s, uniform(base_s,
    3 * sleep_{n-1}))``, unbounded (the pacer of a supervisor that runs
    indefinitely and caps rapid restarts itself). Every value is in
    ``[base_s, max_s]``; ``seed`` makes the stream reproducible."""
    if base_s <= 0:
        raise ValueError("decorrelated: base_s must be > 0 (got %r)" % (base_s,))
    rng = random.Random(seed)
    prev = base_s
    while True:
        prev = min(max_s, rng.uniform(base_s, 3.0 * prev))
        yield prev
