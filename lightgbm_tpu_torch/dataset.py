"""Binned dataset construction; the PyTorch port's copy of
lightgbm_tpu/dataset.py, with its binary-file save and load (the same magic
string, npz fields and layout, so a file written by either package loads in
the other).

Counterpart of the reference Dataset/DatasetLoader/Metadata
(LightGBM src/io/dataset.cpp, dataset_loader.cpp, metadata.cpp). Instead of
polymorphic per-group Bin stores (dense/sparse/4-bit/ordered), the TPU layout is a
single dense feature-major bin matrix ``[num_features, num_rows]`` (uint8 when all
features have <=256 bins) — the shape the Pallas/XLA histogram kernels consume
directly, sharded over rows on a device mesh.

Sparse inputs (scipy CSR/CSC) bin without densifying, and EFB feature bundling
(dataset.cpp:68-178, efb.py here) packs mutually-exclusive sparse features into
shared dense columns — the [F, N] matrix becomes [G, N] with G << F, so
Bosch/Allstate-shaped data (thousands of mostly-zero columns) fits in memory
while every downstream kernel stays dense and static-shaped. The reference's
ragged per-feature sparse stores (sparse_bin.hpp) are deliberately not
replicated: ragged storage defeats the vectorized TPU histogram/partition
kernels, and EFB recovers the memory win in a dense layout.

Binning follows DatasetLoader::CostructFromSampleData (dataset_loader.cpp:535):
sample rows (bin_construct_sample_cnt, data_random_seed), per-feature FindBin on the
non-zero sampled values, drop trivial features, then bin every row.

On the reference's 4-bit packing (dense_nbits_bin.hpp:42, max_bin <= 16):
a measurement kernel exists (ops/hist_pallas.py histogram_pallas_packed4 —
nibble-packed bins halve the dominant HBM stream of the histogram pass) and
the TPU bring-up chain measures it against the u8 layout at the max_bin=15
bench shape (helpers/tpu_bringup.py "pack4" stage -> PACK4_MEASURE.json).
Adoption is gated on that measurement showing >10%: the packed layout also
complicates every row-gather in the partition path (two rows per byte), so
the dense u8 matrix stays the storage format until the win is demonstrated.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from .binning import (
    BIN_CATEGORICAL,
    BIN_NUMERICAL,
    K_ZERO_THRESHOLD,
    MISSING_NAN,
    MISSING_NONE,
    MISSING_ZERO,
    BinMapper,
)
from .config import Config
from .utils import log
from .utils.vfile import vopen


class Metadata:
    """Labels / weights / query boundaries / init score (dataset.h:40-248)."""

    def __init__(
        self,
        num_data: int,
        label: Optional[np.ndarray] = None,
        weight: Optional[np.ndarray] = None,
        group: Optional[np.ndarray] = None,
        init_score: Optional[np.ndarray] = None,
    ) -> None:
        self.num_data = num_data
        self.label = None if label is None else np.asarray(label, dtype=np.float32).reshape(-1)
        self.weight = None if weight is None else np.asarray(weight, dtype=np.float32).reshape(-1)
        self.init_score = None if init_score is None else np.asarray(init_score, dtype=np.float64)
        self.query_boundaries: Optional[np.ndarray] = None
        if group is not None:
            group = np.asarray(group)
            if len(group) == num_data and not self._looks_like_sizes(group, num_data):
                # per-row query ids -> boundaries
                change = np.nonzero(np.diff(group))[0] + 1
                sizes = np.diff(np.concatenate([[0], change, [num_data]]))
            else:
                sizes = group.astype(np.int64)
            self.query_boundaries = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
            if self.query_boundaries[-1] != num_data:
                log.fatal(
                    "Sum of query counts (%d) != number of data (%d)"
                    % (int(self.query_boundaries[-1]), num_data)
                )
        self._validate()

    @staticmethod
    def _looks_like_sizes(group: np.ndarray, num_data: int) -> bool:
        return int(np.sum(group)) == num_data

    def _validate(self) -> None:
        for name, arr in (("label", self.label), ("weight", self.weight)):
            if arr is not None and len(arr) != self.num_data:
                log.fatal("Length of %s (%d) != number of data (%d)" % (name, len(arr), self.num_data))
        if self.init_score is not None:
            n = self.init_score.reshape(-1).shape[0]
            # num_data or num_class * num_data (Metadata::SetInitScore,
            # metadata.cpp:192 "Initial score size doesn't match data size")
            if n == 0 or self.num_data == 0 or n % self.num_data != 0:
                log.fatal(
                    "Initial score size doesn't match data size (%d vs %d)"
                    % (n, self.num_data)
                )

    @property
    def num_queries(self) -> int:
        return 0 if self.query_boundaries is None else len(self.query_boundaries) - 1

    def query_weights(self) -> Optional[np.ndarray]:
        if self.query_boundaries is None or self.weight is None:
            return None
        return np.array(
            [self.weight[self.query_boundaries[i]] for i in range(self.num_queries)],
            dtype=np.float32,
        )


class BinnedDataset:
    """Dense binned matrix + per-feature BinMappers (dataset.h:267-635 analogue).

    Attributes:
      bins: ``[num_features, num_data]`` integer bin matrix (feature-major so a
        split's column gather is a contiguous dynamic_slice on device).
      mappers: per-feature BinMapper for used (non-trivial) features.
      used_feature_idx: original column index per used feature.
      num_total_features: columns in the raw input (incl. trivial ones).
    """

    def __init__(
        self,
        bins: np.ndarray,
        mappers: List[BinMapper],
        used_feature_idx: List[int],
        num_total_features: int,
        metadata: Metadata,
        feature_names: Optional[List[str]] = None,
        monotone_constraints: Optional[List[int]] = None,
        group_id: Optional[np.ndarray] = None,
        bin_offset: Optional[np.ndarray] = None,
        max_group_bins: Optional[int] = None,
    ) -> None:
        self.bins = bins
        self.mappers = mappers
        self.used_feature_idx = used_feature_idx
        self.num_total_features = num_total_features
        self.metadata = metadata
        if feature_names is None:
            feature_names = ["Column_%d" % i for i in range(num_total_features)]
        self.feature_names = feature_names
        self.monotone_constraints = monotone_constraints or []
        # EFB bundling (efb.py): when set, ``bins`` is [num_groups, N] with the
        # offset encoding; group_id/bin_offset [F] decode each feature's column
        self.group_id = group_id
        self.bin_offset = bin_offset
        self._max_group_bins = max_group_bins

    @property
    def is_bundled(self) -> bool:
        return self.group_id is not None

    @property
    def num_data(self) -> int:
        return self.bins.shape[1]

    @property
    def num_features(self) -> int:
        return len(self.mappers)

    @property
    def num_groups(self) -> int:
        return self.bins.shape[0]

    @property
    def max_num_bin(self) -> int:
        return max((m.num_bin for m in self.mappers), default=1)

    @property
    def max_group_bins(self) -> int:
        """Histogram width: bundled group width, else max feature bins.

        The THEORETICAL width from BundleInfo, never derived from the data —
        a row subset may lack the rows carrying the top encodings, and an
        undersized histogram would silently clamp the remap gathers."""
        if self.is_bundled:
            if self._max_group_bins is not None:
                return int(self._max_group_bins)
            # legacy files without the stored width: a group's width is its
            # last member's offset + contributed bins
            return int(
                max(
                    int(self.bin_offset[f]) + m.num_bin - 1
                    for f, m in enumerate(self.mappers)
                )
            )
        return self.max_num_bin

    def num_bins_per_feature(self) -> np.ndarray:
        return np.array([m.num_bin for m in self.mappers], dtype=np.int32)

    def feature_meta_arrays(self) -> Dict[str, np.ndarray]:
        """Static per-feature arrays consumed by the split-finding kernel."""
        F = self.num_features
        mono_full = self.monotone_constraints
        mono = np.zeros(F, dtype=np.int8)
        if mono_full:
            for j, orig in enumerate(self.used_feature_idx):
                if orig < len(mono_full):
                    mono[j] = mono_full[orig]
        meta = {
            "num_bin": self.num_bins_per_feature(),
            "missing_type": np.array([m.missing_type for m in self.mappers], dtype=np.int32),
            "default_bin": np.array([m.default_bin for m in self.mappers], dtype=np.int32),
            "monotone": mono,
        }
        if self.is_bundled:
            # key presence is the static "EFB bundled" switch for the grower
            meta["group_id"] = self.group_id.astype(np.int32)
            meta["bin_offset"] = self.bin_offset.astype(np.int32)
        is_cat = np.array(
            [m.bin_type == BIN_CATEGORICAL for m in self.mappers], dtype=bool
        )
        if is_cat.any():
            # key presence is the static "has categorical features" switch: the
            # split scan only builds its CTR/one-hot machinery when present, so
            # all-numerical workloads trace none of it
            meta["is_categorical"] = is_cat
        return meta


BINARY_MAGIC = "lightgbm_tpu.binned.v1"


def save_binary_dataset(binned: BinnedDataset, path: str) -> None:
    """Persist the binned dataset for fast reload (Dataset::SaveBinaryFile,
    dataset.cpp:615, as an npz): the bins, the used features, the EFB plan
    of a bundled table (``group_id``, ``bin_offset``, ``max_group_bins``),
    the metadata fields and a JSON record of the mappers and names."""
    import json as _json

    md = binned.metadata
    arrays: Dict[str, np.ndarray] = {
        "bins": binned.bins,
        "used_feature_idx": np.asarray(binned.used_feature_idx, np.int64),
    }
    if binned.is_bundled:
        arrays["group_id"] = binned.group_id
        arrays["bin_offset"] = binned.bin_offset
        arrays["max_group_bins"] = np.asarray([binned.max_group_bins], np.int64)
    for name, arr in (("label", md.label), ("weight", md.weight), ("init_score", md.init_score),
                      ("query_boundaries", md.query_boundaries)):
        if arr is not None:
            arrays[name] = arr
    meta = {
        "magic": BINARY_MAGIC,
        "num_total_features": binned.num_total_features,
        "feature_names": binned.feature_names,
        "monotone_constraints": list(binned.monotone_constraints),
        "mappers": [m.to_dict() for m in binned.mappers],
    }
    arrays["meta_json"] = np.frombuffer(_json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    with vopen(path, "wb") as fh:
        np.savez_compressed(fh, **arrays)


def is_binary_dataset_file(path: str) -> bool:
    """True when ``path`` is a dataset written by ``save_binary`` (a zip with
    the meta record): the LoadFromBinFile sniff (dataset_loader.cpp:268)."""
    try:
        with vopen(path, "rb") as fh:
            if fh.read(2) != b"PK":
                return False
        with vopen(path, "rb") as fh, np.load(fh, allow_pickle=False) as z:
            return "meta_json" in z.files
    except Exception:
        return False


def load_binary_dataset(path: str) -> BinnedDataset:
    """Reload a ``save_binary`` dataset (DatasetLoader::LoadFromBinFile)."""
    import json as _json

    with vopen(path, "rb") as fh, np.load(fh, allow_pickle=False) as z:
        meta = _json.loads(bytes(z["meta_json"].tobytes()).decode("utf-8"))
        if meta.get("magic") != BINARY_MAGIC:
            log.fatal("File %s is not a lightgbm_tpu binary dataset" % path)
        bins = z["bins"]
        md = Metadata(
            bins.shape[1],
            label=z["label"] if "label" in z.files else None,
            weight=z["weight"] if "weight" in z.files else None,
            init_score=z["init_score"] if "init_score" in z.files else None,
        )
        if "query_boundaries" in z.files:
            md.query_boundaries = z["query_boundaries"].astype(np.int64)
        used = [int(i) for i in z["used_feature_idx"]]
        group_id = z["group_id"] if "group_id" in z.files else None
        bin_offset = z["bin_offset"] if "bin_offset" in z.files else None
        mgb = int(z["max_group_bins"][0]) if "max_group_bins" in z.files else None
    return BinnedDataset(
        bins, [BinMapper.from_dict(d) for d in meta["mappers"]], used,
        int(meta["num_total_features"]), md, feature_names=meta["feature_names"],
        monotone_constraints=meta["monotone_constraints"], group_id=group_id,
        bin_offset=bin_offset, max_group_bins=mgb,
    )


def _sample_rows(num_data: int, sample_cnt: int, seed: int) -> np.ndarray:
    if sample_cnt >= num_data:
        return np.arange(num_data)
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    return np.sort(rng.choice(num_data, size=sample_cnt, replace=False))


def _parse_categorical(categorical_feature, num_cols: int, feature_names: Optional[List[str]]) -> set:
    cats: set = set()
    if categorical_feature is None or categorical_feature == "":
        return cats
    if isinstance(categorical_feature, str):
        items: Sequence = [x for x in categorical_feature.split(",") if x != ""]
    else:
        items = categorical_feature
    for it in items:
        if isinstance(it, str) and it.startswith("name:"):
            it = it[5:]
        if isinstance(it, str) and not it.lstrip("-").isdigit():
            if feature_names and it in feature_names:
                cats.add(feature_names.index(it))
            else:
                log.warning("Unknown categorical feature name: %s" % it)
        else:
            cats.add(int(it))
    return {c for c in cats if 0 <= c < num_cols}


def construct_dataset(
    data: np.ndarray,
    config: Config,
    label: Optional[np.ndarray] = None,
    weight: Optional[np.ndarray] = None,
    group: Optional[np.ndarray] = None,
    init_score: Optional[np.ndarray] = None,
    feature_names: Optional[List[str]] = None,
    categorical_feature=None,
    reference: Optional[BinnedDataset] = None,
) -> BinnedDataset:
    """Bin a raw row-major float matrix into a BinnedDataset.

    With ``reference`` set, reuses its BinMappers (validation data path — the
    reference's Dataset::CreateValid / CheckAlign contract, dataset.h:300).
    scipy sparse matrices bin without densifying and may EFB-bundle (efb.py).
    """
    if data.shape[0] == 0:
        # DatasetLoader fatals on an empty data file; an empty in-memory
        # matrix is the same user error, not a trainable dataset
        log.fatal("Cannot construct a Dataset with 0 rows")
    if _is_scipy_sparse(data):
        return _construct_sparse(
            data, config, label=label, weight=weight, group=group,
            init_score=init_score, feature_names=feature_names,
            categorical_feature=categorical_feature, reference=reference,
        )
    data = np.asarray(data)
    if data.ndim != 2:
        log.fatal("Input data must be 2-dimensional, got shape %s" % (data.shape,))
    num_data, num_cols = data.shape
    if data.dtype not in (np.float32, np.float64):
        data = data.astype(np.float64)
    metadata = Metadata(num_data, label=label, weight=weight, group=group, init_score=init_score)

    if reference is not None:
        if num_cols != reference.num_total_features:
            log.fatal(
                "Validation data has %d features, training data had %d"
                % (num_cols, reference.num_total_features)
            )
        bins = _bin_matrix(data, reference.mappers, reference.used_feature_idx)
        if reference.is_bundled:
            # the training set is EFB-bundled [G, N]: re-encode this data into
            # the same bundled layout, or GBDT's group-space feature_meta would
            # decode a per-feature matrix as groups (silently wrong eval)
            from . import efb

            feat_bins = bins

            def get(f):
                sub = feat_bins[f].astype(np.int32)
                keep = sub != reference.mappers[f].default_bin
                return np.nonzero(keep)[0], sub[keep]

            bins = efb.build_bundled_matrix(
                get,
                efb.BundleInfo.from_binned(reference),
                [m.default_bin for m in reference.mappers],
                num_data,
            )
        return BinnedDataset(
            bins,
            reference.mappers,
            reference.used_feature_idx,
            reference.num_total_features,
            metadata,
            feature_names=reference.feature_names,
            monotone_constraints=reference.monotone_constraints,
            group_id=reference.group_id,
            bin_offset=reference.bin_offset,
            max_group_bins=reference._max_group_bins,
        )

    cat_idx = _parse_categorical(
        categorical_feature if categorical_feature is not None else config.categorical_feature,
        num_cols,
        feature_names,
    )

    sample_idx = _sample_rows(num_data, config.bin_construct_sample_cnt, config.data_random_seed)
    sample = data[sample_idx]
    total_sample_cnt = len(sample_idx)

    mappers: List[BinMapper] = []
    used: List[int] = []
    for j in range(num_cols):
        col = np.asarray(sample[:, j], dtype=np.float64)
        # keep NaN and non-zero values; zeros are counted implicitly
        keep = np.isnan(col) | (np.abs(col) > K_ZERO_THRESHOLD)
        vals = col[keep]
        m = BinMapper()
        m.find_bin(
            vals,
            total_sample_cnt,
            config.max_bin,
            config.min_data_in_bin,
            config.min_data_in_leaf,
            bin_type=BIN_CATEGORICAL if j in cat_idx else BIN_NUMERICAL,
            use_missing=config.use_missing,
            zero_as_missing=config.zero_as_missing,
        )
        if not m.is_trivial:
            mappers.append(m)
            used.append(j)
    if not used:
        log.warning("There are no meaningful features, as all feature values are constant.")
    bins = _bin_matrix(data, mappers, used)
    mono = list(config.monotone_constraints) if config.monotone_constraints else []
    return BinnedDataset(
        bins,
        mappers,
        used,
        num_cols,
        metadata,
        feature_names=feature_names,
        monotone_constraints=mono,
    )


def _is_scipy_sparse(x) -> bool:
    return hasattr(x, "tocsc") and hasattr(x, "nnz")


def _construct_sparse(
    data,
    config: Config,
    label=None,
    weight=None,
    group=None,
    init_score=None,
    feature_names=None,
    categorical_feature=None,
    reference: Optional[BinnedDataset] = None,
) -> BinnedDataset:
    """Bin a scipy sparse matrix column-by-column (no densification), then
    EFB-bundle when enable_bundle finds exclusive groups (dataset.cpp:68-178).
    """
    from . import efb

    csc = data.tocsc()
    num_data, num_cols = csc.shape
    metadata = Metadata(
        num_data, label=label, weight=weight, group=group, init_score=init_score
    )

    def col_nonzeros(j):
        lo, hi = csc.indptr[j], csc.indptr[j + 1]
        return csc.indices[lo:hi], np.asarray(csc.data[lo:hi], np.float64)

    def subbins_fn(mappers, used):
        """f -> (row_idx, sub_bin) for rows whose sub-bin != default.

        Memoized: find_groups consumes every column's nonzero rows before
        build_bundled_matrix re-reads them — without the cache each column's
        O(nnz) values_to_bins would run twice."""
        memo = {}

        def get(f):
            if f not in memo:
                idx, vals = col_nonzeros(used[f])
                sub = mappers[f].values_to_bins(vals).astype(np.int32)
                keep = sub != mappers[f].default_bin
                memo[f] = (idx[keep], sub[keep])
            return memo[f]

        return get

    if reference is not None:
        if num_cols != reference.num_total_features:
            log.fatal(
                "Validation data has %d features, training data had %d"
                % (num_cols, reference.num_total_features)
            )
        mappers, used = reference.mappers, reference.used_feature_idx
        get = subbins_fn(mappers, used)
        if reference.is_bundled:
            bins = efb.build_bundled_matrix(
                get,
                efb.BundleInfo.from_binned(reference),
                [m.default_bin for m in mappers],
                num_data,
            )
        else:
            max_bin = max((m.num_bin for m in mappers), default=2)
            dtype = np.uint8 if max_bin <= 256 else np.int32
            bins = np.zeros((len(used), num_data), dtype)
            for f, m in enumerate(mappers):
                bins[f, :] = m.default_bin
                idx, sub = get(f)
                bins[f, idx] = sub.astype(dtype)
        return BinnedDataset(
            bins, mappers, used, num_cols, metadata,
            feature_names=reference.feature_names,
            monotone_constraints=reference.monotone_constraints,
            group_id=reference.group_id, bin_offset=reference.bin_offset,
            max_group_bins=reference._max_group_bins,
        )

    cat_idx = _parse_categorical(
        categorical_feature if categorical_feature is not None else config.categorical_feature,
        num_cols,
        feature_names,
    )
    sample_idx = _sample_rows(
        num_data, config.bin_construct_sample_cnt, config.data_random_seed
    )
    total_sample_cnt = len(sample_idx)
    sampled = csc if total_sample_cnt == num_data else data.tocsr()[sample_idx].tocsc()

    mappers: List[BinMapper] = []
    used: List[int] = []
    for j in range(num_cols):
        lo, hi = sampled.indptr[j], sampled.indptr[j + 1]
        vals = np.asarray(sampled.data[lo:hi], np.float64)
        vals = vals[np.isnan(vals) | (np.abs(vals) > K_ZERO_THRESHOLD)]
        m = BinMapper()
        m.find_bin(
            vals,
            total_sample_cnt,
            config.max_bin,
            config.min_data_in_bin,
            config.min_data_in_leaf,
            bin_type=BIN_CATEGORICAL if j in cat_idx else BIN_NUMERICAL,
            use_missing=config.use_missing,
            zero_as_missing=config.zero_as_missing,
        )
        if not m.is_trivial:
            mappers.append(m)
            used.append(j)
    if not used:
        log.warning("There are no meaningful features, as all feature values are constant.")

    mono = list(config.monotone_constraints) if config.monotone_constraints else []
    get = subbins_fn(mappers, used)
    kwargs = dict(feature_names=feature_names, monotone_constraints=mono)

    if config.enable_bundle and len(used) > 1:
        nz_rows = [get(f)[0] for f in range(len(used))]
        groups = efb.find_groups(
            nz_rows,
            [m.num_bin for m in mappers],
            num_data,
            config.max_conflict_rate,
        )
        info = efb.BundleInfo(groups, [m.num_bin for m in mappers])
        if info.num_groups < len(used):
            log.info(
                "EFB bundled %d features into %d groups (max %d bins/group)"
                % (len(used), info.num_groups, info.max_group_bins)
            )
            bins = efb.build_bundled_matrix(
                get, info, [m.default_bin for m in mappers], num_data
            )
            return BinnedDataset(
                bins, mappers, used, num_cols, metadata,
                group_id=info.group_id, bin_offset=info.bin_offset,
                max_group_bins=info.max_group_bins, **kwargs,
            )

    # no winning bundle: dense per-feature bin matrix, built from the columns
    max_bin = max((m.num_bin for m in mappers), default=2)
    dtype = np.uint8 if max_bin <= 256 else np.int32
    bins = np.zeros((len(used), num_data), dtype)
    for f, m in enumerate(mappers):
        bins[f, :] = m.default_bin
        idx, sub = get(f)
        bins[f, idx] = sub.astype(dtype)
    return BinnedDataset(bins, mappers, used, num_cols, metadata, **kwargs)


def _bin_matrix(data: np.ndarray, mappers: List[BinMapper], used: List[int]) -> np.ndarray:
    max_bin = max((m.num_bin for m in mappers), default=2)
    dtype = np.uint8 if max_bin <= 256 else np.int32
    out = np.zeros((len(used), data.shape[0]), dtype=dtype)
    for f, (m, j) in enumerate(zip(mappers, used)):
        out[f] = m.values_to_bins(np.asarray(data[:, j], dtype=np.float64)).astype(dtype)
    return out
