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
    unless ``device="cpu"`` (or the ``device`` param) says otherwise.

    With ``device_chunk_size`` n > 1 and no fallback reason
    (``GBDT.device_chunk_fallback_reason``) the loop steps by chunks, as the
    reference's ``_boost_loop`` does: the first iteration alone, then whole
    chunks of n (``Booster.update_chunk``), then a tail shorter than a chunk
    one iteration at a time."""
    params = Config.canonicalize(dict(params) if params else {})
    if "num_iterations" in params:
        num_boost_round = int(params.pop("num_iterations"))
    booster = Booster(params, train_set, device=device)
    chunk = booster._gbdt.device_chunk()
    i = 0
    while i < num_boost_round:
        if chunk > 1 and num_boost_round - i >= chunk:
            done, finished = booster.update_chunk(chunk)
            if done == 0:
                break
        else:
            done, finished = 1, booster.update()
        i += done
        if finished:
            break
    return booster
