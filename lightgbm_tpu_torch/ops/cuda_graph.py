"""One captured CUDA graph of a queued callable, with the kernel wrappers'
launch counts carried into every replay.

The device-resident boosting iteration (models/gbdt.py) queues some 800
kernels from Python a tree. Captured once into a CUDA graph, a replay
launches all of them with one host call. Each kernel module counts its
wrappers' launches in Python, in a dict ``launches`` keyed by
instantiation (the names of chip_smoke.py's kernels line), and a replay
calls none of them, so :class:`Graph` records how many
launches of each wrapper the capture recorded, takes them back off (a
capture runs nothing), and adds them again at each replay: the counts stay
those of the kernels that ran.

A capture that fails raises (a wrapper's launch on a stream other than the
capturing one, a synchronizing call, a capture on a stream that cannot be
captured); nothing falls back to the eager launches. Building and loading
the kernels' libraries must happen before a capture: run the callable once
eagerly first.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from . import (
    grow_step_kernel, hist_kernel, packed_kernel, partition_kernel, predict_kernel, rank_kernel,
    remap_kernel, shap_kernel, split_kernel,
)

#: the modules whose wrappers count their launches in a dict ``launches``
#: keyed by instantiation, each with a ``reset_launches``
KERNEL_MODULES = (hist_kernel, grow_step_kernel, split_kernel, partition_kernel, predict_kernel,
                  remap_kernel, rank_kernel, packed_kernel, shap_kernel)


def reset_launches() -> None:
    """Every kernel wrapper's launch count to 0."""
    for mod in KERNEL_MODULES:
        mod.reset_launches()


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count, by instantiation (the keys of
    the modules' ``launches``)."""
    counts: Dict[str, int] = {}
    for mod in KERNEL_MODULES:
        counts.update(mod.launches)
    return counts


def add_launches(delta: Dict[str, int]) -> None:
    """Add ``delta`` (keys of :func:`launch_counts`) to the wrappers' counts."""
    for name, n in delta.items():
        next(mod for mod in KERNEL_MODULES if name in mod.launches).launches[name] += n


class Graph:
    """``fn`` (no arguments; it queues work on the current stream and reads
    nothing back) captured as one CUDA graph on ``device``.

    ``out`` is what ``fn`` returned during the capture: tensors in the
    graph's memory, rewritten by each replay. ``launches`` is the wrappers'
    launch counts of one replay. ``stream`` is the capture stream (None:
    PyTorch's side stream for captures)."""

    def __init__(self, fn: Callable, device: torch.device,
                 stream: Optional[torch.cuda.Stream] = None) -> None:
        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.device(device):
                with torch.cuda.graph(self.graph, stream=stream):
                    self.out = fn()
            after = launch_counts()
        finally:
            # the capture ran nothing: the counts it added go until a replay
            add_launches({k: before[k] - v for k, v in launch_counts().items()})
        self.launches = {k: v - before[k] for k, v in after.items() if v != before[k]}

    def replay(self) -> None:
        """Launch the graph on the current stream and count its kernels."""
        self.graph.replay()
        add_launches(self.launches)
