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
from .binning import BIN_CATEGORICAL, BIN_NUMERICAL, BinMapper
from .dataset import BinnedDataset, Metadata
from .ops.grow import TreeArrays


def binned_from_numpy(
    bins: np.ndarray, feature_meta: Mapping[str, np.ndarray], label=None
) -> BinnedDataset:
    """A port BinnedDataset over a ``[F, N]`` bin matrix (uint8, or int32
    past 256 bins a feature, as the datasets store them).

    Each feature gets a numerical BinMapper with the meta's num_bin,
    missing_type and default_bin, whose bin upper bounds are the bin
    indices themselves — a bin-space view, so a tree's real thresholds read
    as bin numbers; a feature that ``feature_meta["is_categorical"]`` marks
    gets a categorical one whose bins are its categories (bin b holds
    category b). ``feature_meta["monotone"]`` becomes the monotone
    constraints."""
    wide = int(np.max(feature_meta["num_bin"], initial=0)) > 256
    bins = np.ascontiguousarray(bins, dtype=np.int32 if wide else np.uint8)
    F, N = bins.shape
    is_cat = feature_meta.get("is_categorical", np.zeros(F, bool))
    mappers = []
    for f in range(F):
        m = BinMapper()
        m.num_bin = int(feature_meta["num_bin"][f])
        m.missing_type = int(feature_meta["missing_type"][f])
        m.default_bin = int(feature_meta["default_bin"][f])
        m.min_val, m.max_val = 0.0, float(m.num_bin - 1)
        if is_cat[f]:
            m.bin_type = BIN_CATEGORICAL
            m.bin_2_categorical = list(range(m.num_bin))
            m.categorical_2_bin = {b: b for b in range(m.num_bin)}
        else:
            m.bin_type = BIN_NUMERICAL
            m.bin_upper_bound = [float(b) for b in range(m.num_bin)]
        mappers.append(m)
    mono = [int(v) for v in feature_meta.get("monotone", np.zeros(F))]
    return BinnedDataset(
        bins, mappers, list(range(F)), F, Metadata(N, label=label),
        monotone_constraints=mono,
    )


def meta_tensors(feature_meta: Mapping[str, np.ndarray], device="cpu") -> Dict[str, torch.Tensor]:
    """The grower's int32 feature-meta tensors from numpy arrays, and
    ``is_categorical`` as bool when the meta has it."""
    out = {
        k: torch.as_tensor(np.asarray(feature_meta[k]).astype(np.int32), device=device)
        for k in ("num_bin", "missing_type", "default_bin", "monotone")
    }
    if "is_categorical" in feature_meta:
        out["is_categorical"] = torch.as_tensor(
            np.asarray(feature_meta["is_categorical"]).astype(bool), device=device)
    return out


def tree_arrays_from_numpy(arrays: Mapping[str, np.ndarray]) -> TreeArrays:
    """TreeArrays (host tensors) from a dict of numpy arrays keyed by field."""
    return TreeArrays(**{k: torch.as_tensor(np.asarray(arrays[k])) for k in TreeArrays._fields})


def packed_trees_from_numpy(packed, device="cpu"):
    """The port's :class:`~lightgbm_tpu_torch.ops.predict.PackedTrees` on
    ``device`` from the JAX package's ``PackedTrees`` as numpy arrays (a
    NamedTuple or mapping of ``np.asarray`` of its fields), each field in the
    port's dtype — the JAX package's packed model, to drive the port's
    kernels or to hold ``pack_booster``'s output field by field."""
    from .serve.packed import packed_trees_to

    return packed_trees_to(packed, device)


def booster_from_model_string(text: str, device=None) -> Booster:
    """A port Booster from LightGBM model text, e.g. written by the JAX package."""
    return Booster(model_str=text, device=device)
