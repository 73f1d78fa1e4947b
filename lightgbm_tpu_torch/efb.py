"""Exclusive Feature Bundling (EFB) + sparse ingestion; the PyTorch port's
copy of lightgbm_tpu/efb.py, so dataset construction makes the same
bundling decision. The port trains, validates and predicts the bundled
layout (ops/remap.py; the kernels' bundled instantiations).

Counterpart of the reference's feature bundling
(LightGBM src/io/dataset.cpp:68-178 FindGroups/FastFeatureBundling) and
its sparse bin storage (src/io/sparse_bin.hpp). The reference keeps sparse
features as per-feature delta-encoded pair lists; on TPU ragged storage defeats
the vectorized histogram/partition kernels, so sparsity is exploited the EFB
way only: mutually (nearly-)exclusive features pack into one dense bundled
column, shrinking the [F, N] bin matrix to [G, N] with G << F while everything
downstream stays dense and static-shaped.

Bundle encoding (one uint8/int32 column per group):
    group_bin = 0                      -> every member feature at its default
    group_bin = off(f) + rank_f(s)     -> feature f at sub-bin s != default
with off(f) = 1 + sum over previous members (num_bin - 1) and
rank_f(s) = s - (s > default_bin(f)), so each member contributes its
(num_bin - 1) non-default bins. Decode is 3-constant arithmetic per feature
(offset, default_bin, num_bin) — one gather + compare on device. A feature's
default-bin histogram row is recovered as leaf_total - sum(non-default rows)
(exact without conflicts; conflicts are bounded by max_conflict_rate, the
standard EFB approximation).

Group width is capped at 256 bins so bundled columns stay uint8 (the same
cap the reference uses for its GPU bin packing, dataset.cpp:92). A feature
of more than 256 bins takes a group of its own, as wide as its bins: the
host table keeps such groups as int32, as the JAX package does, and the
training device as int16, up to 1024 bins (models/gbdt.py
``device_bin_dtype``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

MAX_GROUP_BINS = 256
MAX_SEARCH_GROUP = 100  # dataset.cpp:78


def find_groups(
    nz_rows_per_feature: Sequence[np.ndarray],
    num_bins: Sequence[int],
    num_data: int,
    max_conflict_rate: float,
    rng: Optional[np.random.RandomState] = None,
) -> List[List[int]]:
    """Greedy conflict-bounded grouping (FindGroups, dataset.cpp:68-140).

    Features are scanned in two orders (given + by non-zero count descending)
    and the grouping with fewer bundles wins (FastFeatureBundling,
    dataset.cpp:144-178). Each group tracks a row-occupancy mark; a feature
    joins the first of (up to MAX_SEARCH_GROUP sampled) groups whose added
    conflicts stay within the group's remaining error budget.
    """
    F = len(nz_rows_per_feature)
    if rng is None:
        rng = np.random.RandomState(num_data)
    max_error_cnt = int(num_data * max_conflict_rate)

    def run(order: Sequence[int]) -> List[List[int]]:
        groups: List[List[int]] = []
        marks: List[np.ndarray] = []  # bool row-occupancy per group
        conflict_cnt: List[int] = []
        nonzero_cnt: List[int] = []
        group_bins: List[int] = []
        for f in order:
            nz = nz_rows_per_feature[f]
            fbins = int(num_bins[f]) - 1  # non-default bins contributed
            avail = [
                g
                for g in range(len(groups))
                if nonzero_cnt[g] + len(nz) <= num_data + max_error_cnt
                and group_bins[g] + fbins <= MAX_GROUP_BINS
            ]
            placed = False
            if avail:
                search = [avail[-1]]
                rest = avail[:-1]
                if len(rest) > MAX_SEARCH_GROUP - 1:
                    pick = rng.choice(len(rest), MAX_SEARCH_GROUP - 1, replace=False)
                    search += [rest[i] for i in pick]
                else:
                    search += rest
                for g in search:
                    budget = max_error_cnt - conflict_cnt[g]
                    cnt = int(np.count_nonzero(marks[g][nz]))
                    if cnt <= budget:
                        groups[g].append(f)
                        conflict_cnt[g] += cnt
                        nonzero_cnt[g] += len(nz) - cnt
                        marks[g][nz] = True
                        group_bins[g] += fbins
                        placed = True
                        break
            if not placed:
                groups.append([f])
                m = np.zeros(num_data, bool)
                m[nz] = True
                marks.append(m)
                conflict_cnt.append(0)
                nonzero_cnt.append(len(nz))
                group_bins.append(1 + fbins)
        return groups

    order_a = list(range(F))
    by_cnt = sorted(order_a, key=lambda f: -len(nz_rows_per_feature[f]))
    ga = run(order_a)
    gb = run(by_cnt)
    return gb if len(gb) < len(ga) else ga


class BundleInfo:
    """Per-feature decode constants for a bundled bin matrix."""

    def __init__(self, groups: List[List[int]], num_bins: Sequence[int]):
        F = sum(len(g) for g in groups)
        self.groups = groups
        self.num_groups = len(groups)
        self.group_id = np.zeros(F, np.int32)
        self.bin_offset = np.zeros(F, np.int32)
        self.group_width = np.zeros(self.num_groups, np.int32)
        for g, members in enumerate(groups):
            off = 1
            for f in members:
                self.group_id[f] = g
                self.bin_offset[f] = off
                off += int(num_bins[f]) - 1
            self.group_width[g] = off

    @classmethod
    def from_binned(cls, binned) -> "BundleInfo":
        """Reconstruct the bundle layout of an already-bundled BinnedDataset
        (validation-data path: re-encode new rows into the training layout)."""
        info = cls.__new__(cls)
        groups: List[List[int]] = [[] for _ in range(binned.num_groups)]
        for f in range(len(binned.mappers)):
            groups[int(binned.group_id[f])].append(f)
        info.groups = groups
        info.num_groups = binned.num_groups
        info.group_id = np.asarray(binned.group_id, np.int32)
        info.bin_offset = np.asarray(binned.bin_offset, np.int32)
        info.group_width = np.asarray([binned.max_group_bins], np.int32)
        return info

    @property
    def max_group_bins(self) -> int:
        return int(self.group_width.max()) if self.num_groups else 1

    @property
    def is_trivial(self) -> bool:
        """True when every group is a singleton (bundling won nothing)."""
        return all(len(g) == 1 for g in self.groups)


def encode_subbin(sub: np.ndarray, default_bin: int, offset: int) -> np.ndarray:
    """sub-bin (!= default) -> group bin: off + (s - (s > default))."""
    return offset + sub - (sub > default_bin).astype(sub.dtype)


def build_bundled_matrix(
    sub_bins_per_feature,  # callable f -> (row_idx, sub_bin) of non-default rows
    info: BundleInfo,
    default_bins: Sequence[int],
    num_data: int,
) -> np.ndarray:
    """[G, N] bundled bin matrix (uint8 when every group fits)."""
    dtype = np.uint8 if info.max_group_bins <= 256 else np.int32
    out = np.zeros((info.num_groups, num_data), dtype)
    for g, members in enumerate(info.groups):
        row = out[g]
        for f in members:
            idx, sub = sub_bins_per_feature(f)
            enc = encode_subbin(
                sub.astype(np.int32), int(default_bins[f]), int(info.bin_offset[f])
            )
            # conflicts: later features overwrite earlier ones (bounded by
            # max_conflict_rate at grouping time)
            row[idx] = enc.astype(dtype)
    return out


def decode_subbin(
    group_col: np.ndarray, offset: int, default_bin: int, num_bin: int
) -> np.ndarray:
    """Inverse of encode_subbin for one feature (host-side; the device decode
    lives in ops/grow.py / ops/predict.py)."""
    r = group_col.astype(np.int64) - offset
    in_range = (r >= 0) & (r < num_bin - 1)
    s = r + (r >= default_bin)
    return np.where(in_range, s, default_bin).astype(np.int32)
