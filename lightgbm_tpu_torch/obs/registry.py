"""A small process-wide registry of labelled counters.

The port's counterpart of the counters in lightgbm_tpu/obs/registry.py,
without the exposition: ``REGISTRY.counter(name, help).inc(label=value)``
and ``value(label=value)`` to read one.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple


class Counter:
    def __init__(self, name: str, help_text: str) -> None:
        self.name = name
        self.help = help_text
        self._values: Dict[Tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(tuple(sorted(labels.items())), 0.0)


class Registry:
    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_text: str = "") -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name, help_text)
            return c


REGISTRY = Registry()
