"""``train``: the boosting loop entry point (engine.py:train's core)."""
from __future__ import annotations

from typing import Dict, Optional

from .basic import Booster, Dataset
from .config import Config


def train(
    params: Dict,
    train_set: Dataset,
    num_boost_round: int = 100,
    device: Optional[str] = None,
) -> Booster:
    """Train ``num_boost_round`` iterations (or ``num_iterations`` in
    ``params``) and stop early when a tree cannot split. Runs on CUDA
    unless ``device="cpu"`` (or the ``device`` param) says otherwise."""
    params = Config.canonicalize(dict(params) if params else {})
    if "num_iterations" in params:
        num_boost_round = int(params.pop("num_iterations"))
    booster = Booster(params, train_set, device=device)
    for _ in range(num_boost_round):
        if booster.update():
            break
    return booster
