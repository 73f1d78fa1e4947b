"""Feature discretization (value -> bin); the PyTorch port's copy of
lightgbm_tpu/binning.py.

Counterpart of the reference BinMapper (LightGBM src/io/bin.cpp:74-402,
include/LightGBM/bin.h). The binning *math* is reproduced exactly — greedy equal-count
bins (GreedyFindBin, bin.cpp:74), zero-as-its-own-bin (FindBinWithZeroAsOneBin,
bin.cpp:152), missing types None/Zero/NaN with the NaN bin last (bin.cpp:208-301),
count-sorted categorical bins (bin.cpp:302-377) — but the *output* is a dense int
bin matrix suitable for TPU histogramming instead of polymorphic Bin column stores.

Binning runs once on host (numpy); the hot path consumes only the resulting arrays.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .utils import log

K_ZERO_THRESHOLD = 1e-35  # meta.h:44
_INF = float("inf")

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

BIN_NUMERICAL = 0
BIN_CATEGORICAL = 1


def _next_after_up(x: float) -> float:
    """Common::GetDoubleUpperBound (utils/common.h:862)."""
    return math.inf if x == math.inf else float(np.nextafter(x, np.inf))


def _double_equal_ordered(a: float, b: float) -> bool:
    """Common::CheckDoubleEqualOrdered (utils/common.h:857): requires a <= b on entry."""
    return b <= _next_after_up(a)


def greedy_find_bin(
    distinct_values: np.ndarray,
    counts: np.ndarray,
    max_bin: int,
    total_cnt: int,
    min_data_in_bin: int,
) -> List[float]:
    """Greedy equal-count bin boundaries over sorted distinct values (bin.cpp:74-150)."""
    num_distinct = len(distinct_values)
    bin_upper_bound: List[float] = []
    assert max_bin > 0
    if num_distinct <= max_bin:
        cur_cnt_inbin = 0
        for i in range(num_distinct - 1):
            cur_cnt_inbin += int(counts[i])
            if cur_cnt_inbin >= min_data_in_bin:
                val = _next_after_up((float(distinct_values[i]) + float(distinct_values[i + 1])) / 2.0)
                if not bin_upper_bound or not _double_equal_ordered(bin_upper_bound[-1], val):
                    bin_upper_bound.append(val)
                    cur_cnt_inbin = 0
        bin_upper_bound.append(_INF)
        return bin_upper_bound

    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, total_cnt // min_data_in_bin))
    mean_bin_size = total_cnt / max_bin

    # values with count >= mean get a dedicated bin
    counts = np.asarray(counts, dtype=np.int64)
    is_big = counts >= mean_bin_size
    rest_bin_cnt = max_bin - int(is_big.sum())
    rest0 = total_cnt - int(counts[is_big].sum())
    rest_sample_cnt = rest0
    mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)

    # The reference walks every distinct value (bin.cpp:101-137); a bin closes at
    # index i when is_big[i], the running count reaches mean_bin_size, or the
    # next value is big and the count reached mean/2. Each close point is the
    # minimum of three searchable candidates, so this walks per BIN instead.
    csum = np.concatenate([[0], np.cumsum(counts)])  # csum[i] = counts[:i].sum()
    csum_small = np.concatenate([[0], np.cumsum(counts * ~is_big)])
    big_idx = np.nonzero(is_big)[0]

    upper_bounds = [_INF] * max_bin
    lower_bounds = [_INF] * max_bin
    bin_cnt = 0
    lower_bounds[0] = float(distinct_values[0])
    s = 0  # current bin's first distinct-value index
    last_i = num_distinct - 2  # the loop never closes at the final value
    while s <= last_i:
        pos = np.searchsorted(big_idx, s)
        b = int(big_idx[pos]) if pos < len(big_idx) else num_distinct
        if b == s:
            i = s
        else:
            # smallest i with counts[s..i].sum() >= mean_bin_size
            i_mean = max(
                int(np.searchsorted(csum, csum[s] + mean_bin_size, side="left")) - 1, s
            )
            cand = []
            if i_mean <= last_i:
                cand.append(i_mean)
            if s <= b - 1 <= last_i and (
                csum[b] - csum[s] >= max(1.0, mean_bin_size * 0.5)
            ):
                cand.append(b - 1)
            if b <= last_i:
                cand.append(b)
            if not cand:
                break  # tail accumulates into the final open bin
            i = min(cand)
        upper_bounds[bin_cnt] = float(distinct_values[i])
        bin_cnt += 1
        lower_bounds[bin_cnt] = float(distinct_values[i + 1])
        if bin_cnt >= max_bin - 1:
            break
        if not is_big[i]:
            rest_bin_cnt -= 1
            rest_sample_cnt = rest0 - int(csum_small[i + 1])
            mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
        s = i + 1
    bin_cnt += 1
    bin_upper_bound = []
    for i in range(bin_cnt - 1):
        val = _next_after_up((upper_bounds[i] + lower_bounds[i + 1]) / 2.0)
        if not bin_upper_bound or not _double_equal_ordered(bin_upper_bound[-1], val):
            bin_upper_bound.append(val)
    bin_upper_bound.append(_INF)
    return bin_upper_bound


def find_bin_with_zero_as_one_bin(
    distinct_values: np.ndarray,
    counts: np.ndarray,
    max_bin: int,
    total_sample_cnt: int,
    min_data_in_bin: int,
) -> List[float]:
    """Bins with [-kZero, kZero] forced as its own bin (bin.cpp:152-206)."""
    left_cnt_data = int(counts[distinct_values <= -K_ZERO_THRESHOLD].sum())
    cnt_zero = int(
        counts[(distinct_values > -K_ZERO_THRESHOLD) & (distinct_values <= K_ZERO_THRESHOLD)].sum()
    )
    right_cnt_data = int(counts[distinct_values > K_ZERO_THRESHOLD].sum())

    gt = np.nonzero(distinct_values > -K_ZERO_THRESHOLD)[0]
    left_cnt = int(gt[0]) if len(gt) else len(distinct_values)

    bin_upper_bound: List[float] = []
    if left_cnt > 0:
        denom = total_sample_cnt - cnt_zero
        left_max_bin = max(1, int(left_cnt_data / max(denom, 1) * (max_bin - 1)))
        bin_upper_bound = greedy_find_bin(
            distinct_values[:left_cnt], counts[:left_cnt], left_max_bin, left_cnt_data, min_data_in_bin
        )
        bin_upper_bound[-1] = -K_ZERO_THRESHOLD

    gt2 = np.nonzero(distinct_values[left_cnt:] > K_ZERO_THRESHOLD)[0]
    right_start = (left_cnt + int(gt2[0])) if len(gt2) else -1

    if right_start >= 0:
        right_max_bin = max_bin - 1 - len(bin_upper_bound)
        if right_max_bin <= 0:
            # the reference CHECK-fails here too (bin.cpp:197): max_bin is too
            # small to hold negative bins + zero bin + positive bins
            log.fatal(
                "max_bin=%d is too small for a feature with both negative and "
                "positive values (needs >= 4)" % max_bin
            )
        right_bounds = greedy_find_bin(
            distinct_values[right_start:], counts[right_start:], right_max_bin, right_cnt_data, min_data_in_bin
        )
        bin_upper_bound.append(K_ZERO_THRESHOLD)
        bin_upper_bound.extend(right_bounds)
    else:
        bin_upper_bound.append(_INF)
    return bin_upper_bound


def _need_filter(cnt_in_bin: Sequence[int], total_cnt: int, filter_cnt: int, bin_type: int) -> bool:
    """True if no split of this feature can satisfy min_data (bin.cpp:50-72)."""
    if bin_type == BIN_NUMERICAL:
        sum_left = 0
        for i in range(len(cnt_in_bin) - 1):
            sum_left += cnt_in_bin[i]
            if sum_left >= filter_cnt and total_cnt - sum_left >= filter_cnt:
                return False
    else:
        if len(cnt_in_bin) <= 2:
            for i in range(len(cnt_in_bin) - 1):
                if cnt_in_bin[i] >= filter_cnt and total_cnt - cnt_in_bin[i] >= filter_cnt:
                    return False
        else:
            return False
    return True


class BinMapper:
    """Per-feature value->bin map (bin.h:63-460)."""

    __slots__ = (
        "num_bin",
        "missing_type",
        "is_trivial",
        "sparse_rate",
        "bin_type",
        "bin_upper_bound",
        "bin_2_categorical",
        "categorical_2_bin",
        "min_val",
        "max_val",
        "default_bin",
    )

    def __init__(self) -> None:
        self.num_bin = 1
        self.missing_type = MISSING_NONE
        self.is_trivial = True
        self.sparse_rate = 1.0
        self.bin_type = BIN_NUMERICAL
        self.bin_upper_bound: List[float] = [_INF]
        self.bin_2_categorical: List[int] = []
        self.categorical_2_bin: Dict[int, int] = {}
        self.min_val = 0.0
        self.max_val = 0.0
        self.default_bin = 0

    # -- construction ---------------------------------------------------

    def find_bin(
        self,
        values: np.ndarray,
        total_sample_cnt: int,
        max_bin: int,
        min_data_in_bin: int,
        min_split_data: int,
        bin_type: int = BIN_NUMERICAL,
        use_missing: bool = True,
        zero_as_missing: bool = False,
    ) -> None:
        """BinMapper::FindBin (bin.cpp:208-402).

        ``values``: sampled non-zero values of this feature (may contain NaN);
        ``total_sample_cnt`` = len(values) + number of sampled zeros.
        """
        values = np.asarray(values, dtype=np.float64)
        nan_mask = np.isnan(values)
        nan_total = int(nan_mask.sum())
        values = values[~nan_mask]

        # na_cnt is nonzero only when NaN is the detected missing type; otherwise
        # NaNs fold into the zero bucket (bin.cpp:217-233, ValueToBin bin.h:462-467).
        na_cnt = 0
        if not use_missing:
            self.missing_type = MISSING_NONE
        elif zero_as_missing:
            self.missing_type = MISSING_ZERO
        else:
            if nan_total == 0:
                self.missing_type = MISSING_NONE
            else:
                self.missing_type = MISSING_NAN
                na_cnt = nan_total
        num_kept = len(values)

        self.bin_type = bin_type
        self.default_bin = 0
        zero_cnt = int(total_sample_cnt - num_kept - na_cnt)

        distinct_values, counts = self._distinct_with_zero(values, zero_cnt)
        self.min_val = float(distinct_values[0]) if len(distinct_values) else 0.0
        self.max_val = float(distinct_values[-1]) if len(distinct_values) else 0.0
        num_distinct = len(distinct_values)

        cnt_in_bin: List[int] = []
        if bin_type == BIN_NUMERICAL:
            if self.missing_type == MISSING_ZERO:
                self.bin_upper_bound = find_bin_with_zero_as_one_bin(
                    distinct_values, counts, max_bin, total_sample_cnt, min_data_in_bin
                )
                if len(self.bin_upper_bound) == 2:
                    self.missing_type = MISSING_NONE
            elif self.missing_type == MISSING_NONE:
                self.bin_upper_bound = find_bin_with_zero_as_one_bin(
                    distinct_values, counts, max_bin, total_sample_cnt, min_data_in_bin
                )
            else:
                self.bin_upper_bound = find_bin_with_zero_as_one_bin(
                    distinct_values, counts, max_bin - 1, total_sample_cnt - na_cnt, min_data_in_bin
                )
                self.bin_upper_bound.append(float("nan"))
            self.num_bin = len(self.bin_upper_bound)
            n_real = self.num_bin - (1 if self.missing_type == MISSING_NAN else 0)
            ub = np.asarray(self.bin_upper_bound[:n_real], dtype=np.float64)
            idx = np.minimum(
                np.searchsorted(ub, distinct_values, side="left"), n_real - 1
            )
            cnt_in_bin = list(
                np.bincount(idx, weights=counts, minlength=self.num_bin).astype(np.int64)
            )
            if self.missing_type == MISSING_NAN:
                cnt_in_bin[self.num_bin - 1] = na_cnt
            assert self.num_bin <= max_bin
        else:
            # categorical: ints sorted by count, rare categories -> NaN bin (bin.cpp:302-377)
            ints = distinct_values.astype(np.int64)
            neg = ints < 0
            if neg.any():
                na_cnt += int(counts[neg].sum())
                log.warning("Met negative value in categorical features, will convert it to NaN")
            keep_i = ints[~neg]
            keep_c = counts[~neg]
            # distinct floats can truncate to the same int; merge (sorted already)
            uniq, inv = np.unique(keep_i, return_inverse=True)
            merged_c = np.bincount(inv, weights=keep_c, minlength=len(uniq)).astype(np.int64)
            dv_int: List[int] = [int(v) for v in uniq]
            cnt_int: List[int] = [int(c) for c in merged_c]
            self.num_bin = 0
            rest_cnt = total_sample_cnt - na_cnt
            if rest_cnt > 0:
                # sort desc by count (stable)
                order = sorted(range(len(dv_int)), key=lambda i: (-cnt_int[i], i))
                dv_int = [dv_int[i] for i in order]
                cnt_int = [cnt_int[i] for i in order]
                if dv_int and dv_int[0] == 0:
                    if len(dv_int) == 1:
                        dv_int.append(dv_int[0] + 1)
                        cnt_int.append(0)
                    dv_int[0], dv_int[1] = dv_int[1], dv_int[0]
                    cnt_int[0], cnt_int[1] = cnt_int[1], cnt_int[0]
                cut_cnt = int((total_sample_cnt - na_cnt) * 0.99)
                used_cnt = 0
                eff_max_bin = min(len(dv_int), max_bin)
                self.categorical_2_bin = {}
                self.bin_2_categorical = []
                cnt_in_bin = []
                cur_cat = 0
                while cur_cat < len(dv_int) and (used_cnt < cut_cnt or self.num_bin < eff_max_bin):
                    if cnt_int[cur_cat] < min_data_in_bin and cur_cat > 1:
                        break
                    self.bin_2_categorical.append(dv_int[cur_cat])
                    self.categorical_2_bin[dv_int[cur_cat]] = self.num_bin
                    used_cnt += cnt_int[cur_cat]
                    cnt_in_bin.append(cnt_int[cur_cat])
                    self.num_bin += 1
                    cur_cat += 1
                if cur_cat == len(dv_int) and na_cnt > 0:
                    self.bin_2_categorical.append(-1)
                    self.categorical_2_bin[-1] = self.num_bin
                    cnt_in_bin.append(0)
                    self.num_bin += 1
                if cur_cat == len(dv_int) and na_cnt == 0:
                    self.missing_type = MISSING_NONE
                elif na_cnt == 0:
                    self.missing_type = MISSING_ZERO
                else:
                    self.missing_type = MISSING_NAN
                if cnt_in_bin:
                    cnt_in_bin[-1] += total_sample_cnt - used_cnt

        self.is_trivial = self.num_bin <= 1
        if not self.is_trivial and _need_filter(cnt_in_bin, total_sample_cnt, min_split_data, bin_type):
            self.is_trivial = True
        if not self.is_trivial:
            self.default_bin = int(self.value_to_bin(0.0))
            self.sparse_rate = cnt_in_bin[self.default_bin] / max(total_sample_cnt, 1)
        else:
            self.sparse_rate = 1.0

    @staticmethod
    def _distinct_with_zero(values: np.ndarray, zero_cnt: int) -> Tuple[np.ndarray, np.ndarray]:
        """Sorted distinct values with the zero bucket inserted (bin.cpp:238-270).

        Near-equal doubles (within one ulp, ordered) merge keeping the larger
        value, like the reference's CheckDoubleEqualOrdered merge loop —
        vectorized: within-ulp runs become groups via a cumulative break mask.
        """
        values = np.sort(np.asarray(values, dtype=np.float64), kind="stable")
        n = len(values)
        if n == 0:
            return np.asarray([0.0]), np.asarray([zero_cnt], dtype=np.int64)
        if n == 1:
            distinct = values
            counts = np.asarray([1], dtype=np.int64)
        else:
            # group i+1 merges into i when values[i+1] <= nextafter(values[i], inf)
            merged = values[1:] <= np.nextafter(values[:-1], np.inf)
            breaks = np.nonzero(~merged)[0]  # values[b+1] starts a new group
            starts = np.concatenate([[0], breaks + 1])
            ends = np.concatenate([breaks, [n - 1]])
            distinct = values[ends]  # larger (last) value of each run wins
            counts = (ends - starts + 1).astype(np.int64)
        # zero-bucket insertion (values exclude zeros by the caller's contract)
        if distinct[0] > 0.0 and zero_cnt > 0:
            distinct = np.concatenate([[0.0], distinct])
            counts = np.concatenate([[zero_cnt], counts])
        elif distinct[-1] < 0.0:
            if zero_cnt > 0:
                distinct = np.concatenate([distinct, [0.0]])
                counts = np.concatenate([counts, [zero_cnt]])
        else:
            sign_change = np.nonzero((distinct[:-1] < 0.0) & (distinct[1:] > 0.0))[0]
            if len(sign_change):
                j = int(sign_change[0]) + 1
                distinct = np.concatenate([distinct[:j], [0.0], distinct[j:]])
                counts = np.concatenate([counts[:j], [zero_cnt], counts[j:]])
        return distinct, counts

    # -- mapping --------------------------------------------------------

    def value_to_bin(self, value: float) -> int:
        """BinMapper::ValueToBin (bin.h:461-496)."""
        if math.isnan(value):
            if self.missing_type == MISSING_NAN:
                return self.num_bin - 1
            value = 0.0
        if self.bin_type == BIN_NUMERICAL:
            ub = self.bin_upper_bound
            hi = self.num_bin - 1 - (1 if self.missing_type == MISSING_NAN else 0)
            lo = 0
            while lo < hi:
                mid = (hi + lo - 1) // 2
                if value <= ub[mid]:
                    hi = mid
                else:
                    lo = mid + 1
            return lo
        iv = int(value)
        if iv < 0:
            return self.num_bin - 1
        return self.categorical_2_bin.get(iv, self.num_bin - 1)

    def values_to_bins(self, values: np.ndarray) -> np.ndarray:
        """Vectorized ValueToBin over a column."""
        values = np.asarray(values, dtype=np.float64)
        if self.bin_type == BIN_NUMERICAL:
            ub = np.asarray(self.bin_upper_bound, dtype=np.float64)
            n_search = self.num_bin - (1 if self.missing_type == MISSING_NAN else 0)
            nan_mask = np.isnan(values)
            out = np.zeros(len(values), dtype=np.int32)
            safe = np.where(nan_mask, 0.0, values)
            idx = np.searchsorted(ub[:n_search], safe, side="left")
            idx = np.minimum(idx, n_search - 1)
            out[:] = idx
            if self.missing_type == MISSING_NAN:
                out[nan_mask] = self.num_bin - 1
        else:
            out = np.zeros(len(values), dtype=np.int32)
            nan_mask = np.isnan(values)
            safe = np.where(nan_mask, 0.0, values)
            iv = safe.astype(np.int64)
            if self.categorical_2_bin:
                keys = np.fromiter(self.categorical_2_bin.keys(), dtype=np.int64)
                vals = np.fromiter(self.categorical_2_bin.values(), dtype=np.int64)
                order = np.argsort(keys)
                keys, vals = keys[order], vals[order]
                pos = np.searchsorted(keys, iv)
                pos_c = np.clip(pos, 0, len(keys) - 1)
                hit = keys[pos_c] == iv
                out[:] = np.where(hit, vals[pos_c], self.num_bin - 1)
            else:
                out[:] = self.num_bin - 1
            out[iv < 0] = self.num_bin - 1
            if self.missing_type == MISSING_NAN:
                out[nan_mask] = self.num_bin - 1
            else:
                zero_bin = self.categorical_2_bin.get(0, self.num_bin - 1)
                out[nan_mask] = zero_bin
        return out

    def bin_to_value(self, bin_idx: int) -> float:
        """BinMapper::BinToValue (bin.h:113)."""
        if self.bin_type == BIN_NUMERICAL:
            return self.bin_upper_bound[bin_idx]
        return float(self.bin_2_categorical[bin_idx])

    # -- (de)serialization ----------------------------------------------

    def to_dict(self) -> dict:
        return {
            "num_bin": self.num_bin,
            "missing_type": self.missing_type,
            "is_trivial": self.is_trivial,
            "sparse_rate": self.sparse_rate,
            "bin_type": self.bin_type,
            "bin_upper_bound": list(self.bin_upper_bound),
            "bin_2_categorical": list(self.bin_2_categorical),
            "min_val": self.min_val,
            "max_val": self.max_val,
            "default_bin": self.default_bin,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BinMapper":
        m = cls()
        m.num_bin = int(d["num_bin"])
        m.missing_type = int(d["missing_type"])
        m.is_trivial = bool(d["is_trivial"])
        m.sparse_rate = float(d["sparse_rate"])
        m.bin_type = int(d["bin_type"])
        m.bin_upper_bound = [float(x) for x in d["bin_upper_bound"]]
        m.bin_2_categorical = [int(x) for x in d["bin_2_categorical"]]
        m.categorical_2_bin = {c: i for i, c in enumerate(m.bin_2_categorical)}
        m.min_val = float(d["min_val"])
        m.max_val = float(d["max_val"])
        m.default_bin = int(d["default_bin"])
        return m
