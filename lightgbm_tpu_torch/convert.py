"""State carried from the JAX package, as numpy arrays, into the port.

The JAX package is never imported here: its state arrives as numpy arrays
(``np.asarray`` of its device arrays) or as model text, so a test can feed
one input through both packages and compare.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .basic import Booster
from .binning import BIN_NUMERICAL, BinMapper
from .dataset import BinnedDataset, Metadata
from .ops.grow import TreeArrays


def binned_from_numpy(
    bins: np.ndarray, feature_meta: Mapping[str, np.ndarray], label=None
) -> BinnedDataset:
    """A port BinnedDataset over a ``[F, N]`` uint8 bin matrix.

    Each feature gets a numerical BinMapper with the meta's num_bin,
    missing_type and default_bin, whose bin upper bounds are the bin
    indices themselves — a bin-space view, so a tree's real thresholds read
    as bin numbers. ``feature_meta["monotone"]`` becomes the monotone
    constraints."""
    bins = np.ascontiguousarray(bins, dtype=np.uint8)
    F, N = bins.shape
    mappers = []
    for f in range(F):
        m = BinMapper()
        m.num_bin = int(feature_meta["num_bin"][f])
        m.missing_type = int(feature_meta["missing_type"][f])
        m.default_bin = int(feature_meta["default_bin"][f])
        m.bin_type = BIN_NUMERICAL
        m.bin_upper_bound = [float(b) for b in range(m.num_bin)]
        m.min_val, m.max_val = 0.0, float(m.num_bin - 1)
        mappers.append(m)
    mono = [int(v) for v in feature_meta.get("monotone", np.zeros(F))]
    return BinnedDataset(
        bins, mappers, list(range(F)), F, Metadata(N, label=label),
        monotone_constraints=mono,
    )


def meta_tensors(feature_meta: Mapping[str, np.ndarray], device="cpu") -> Dict[str, torch.Tensor]:
    """The grower's int32 feature-meta tensors from numpy arrays."""
    return {
        k: torch.as_tensor(np.asarray(feature_meta[k]).astype(np.int32), device=device)
        for k in ("num_bin", "missing_type", "default_bin", "monotone")
    }


def tree_arrays_from_numpy(arrays: Mapping[str, np.ndarray]) -> TreeArrays:
    """TreeArrays (host tensors) from a dict of numpy arrays keyed by field."""
    return TreeArrays(**{k: torch.as_tensor(np.asarray(arrays[k])) for k in TreeArrays._fields})


def booster_from_model_string(text: str, device=None) -> Booster:
    """A port Booster from LightGBM model text, e.g. written by the JAX package."""
    return Booster(model_str=text, device=device)
