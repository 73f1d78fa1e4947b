"""Best numerical split over leaf histograms: the plain PyTorch version.

Counterpart of lightgbm_tpu/ops/split.py's numerical ``find_best_split``
and its helpers (feature_histogram.hpp:91-650 semantics): kEpsilon seeds,
missing-value scan directions, L1/L2/max_delta_step, the monotone clamp and
the reference tie-breaks (dir=-1 prefers the largest threshold among equal
gains, dir=+1 the smallest, dir=+1 must strictly beat dir=-1, the feature
argmax the smallest index). ``find_best_split_pair`` scans C children at
once and returns the packed record of lightgbm_tpu/ops/grow.py (``_BEST_F``
order, [C, 9] f32, plus [C, 4] int32 feature/threshold/num_cat/
default_left) — the output of the Pallas kernel
lightgbm_tpu/ops/split_pallas.py:find_best_split_pair_pallas. It is the
oracle of the CUDA kernel in ops/split_kernel.py, op for op.

The inclusive bin prefix is a sequential left fold in f32 (the CPU fold
order of lightgbm_tpu/ops/split.py ``_bin_prefix``), not ``torch.cumsum``,
whose CPU kernel accumulates floats in double.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from . import grow_state as gs

K_EPSILON = 1e-15  # meta.h:42
K_MIN_SCORE = -math.inf

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

BIG_I = 1 << 30

#: packed record column order (lightgbm_tpu/ops/grow.py _BEST_F)
BEST_F = (
    "gain", "left_sum_grad", "left_sum_hess", "left_count",
    "right_sum_grad", "right_sum_hess", "right_count",
    "left_output", "right_output",
)
#: int columns: _BEST_I plus default_left
BEST_I = ("feature", "threshold", "num_cat", "default_left")


class SplitParams(NamedTuple):
    """Static split hyperparameters (subset of Config used by the scan)."""

    lambda_l1: float
    lambda_l2: float
    max_delta_step: float
    min_data_in_leaf: int
    min_sum_hessian_in_leaf: float
    min_gain_to_split: float


class SplitResult(NamedTuple):
    """Unpacked split records ([C] tensors), field names of the JAX package."""

    gain: torch.Tensor
    feature: torch.Tensor
    threshold: torch.Tensor
    default_left: torch.Tensor
    left_sum_grad: torch.Tensor
    left_sum_hess: torch.Tensor
    left_count: torch.Tensor
    right_sum_grad: torch.Tensor
    right_sum_hess: torch.Tensor
    right_count: torch.Tensor
    left_output: torch.Tensor
    right_output: torch.Tensor
    num_cat: torch.Tensor


def unpack(outf: torch.Tensor, outi: torch.Tensor) -> SplitResult:
    """Packed ([C, 9] f32, [C, 4] int32) records -> SplitResult."""
    kw = {n: outf[:, k] for k, n in enumerate(BEST_F)}
    kw.update(
        feature=outi[:, 0], threshold=outi[:, 1], num_cat=outi[:, 2],
        default_left=outi[:, 3] > 0,
    )
    return SplitResult(**kw)


def threshold_l1(s: torch.Tensor, l1: float) -> torch.Tensor:
    """ThresholdL1 (feature_histogram.hpp:446)."""
    if l1 == 0.0:
        return s
    return torch.sign(s) * torch.clamp(torch.abs(s) - l1, min=0.0)


def calculate_leaf_output(sum_grad, sum_hess, p: SplitParams):
    """CalculateSplittedLeafOutput without monotone clamp (feature_histogram.hpp:451)."""
    ret = -threshold_l1(sum_grad, p.lambda_l1) / (sum_hess + p.lambda_l2)
    if p.max_delta_step > 0.0:
        ret = torch.clamp(ret, -p.max_delta_step, p.max_delta_step)
    return ret


def _leaf_output_constrained(sum_grad, sum_hess, p: SplitParams, min_c, max_c):
    return torch.clamp(calculate_leaf_output(sum_grad, sum_hess, p), min_c, max_c)


def _gain_given_output(sum_grad, sum_hess, output, p: SplitParams):
    """GetLeafSplitGainGivenOutput (feature_histogram.hpp:505)."""
    sg_l1 = threshold_l1(sum_grad, p.lambda_l1)
    return -(2.0 * sg_l1 * output + (sum_hess + p.lambda_l2) * output * output)


def leaf_split_gain(sum_grad, sum_hess, p: SplitParams):
    """GetLeafSplitGain (feature_histogram.hpp:498): parent gain, unconstrained."""
    out = calculate_leaf_output(sum_grad, sum_hess, p)
    return _gain_given_output(sum_grad, sum_hess, out, p)


def _bin_prefix(contrib: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix over the bin axis (dim -2 of [..., B, 3]) as a
    sequential f32 left fold."""
    out = torch.empty_like(contrib)
    carry = torch.zeros_like(contrib[..., 0, :])
    for b in range(contrib.shape[-2]):
        carry = carry + contrib[..., b, :]
        out[..., b, :] = carry
    return out


def missing_flags(num_bin, missing):
    """(multi_bin, use_na, skip_def, single_scan) per feature."""
    multi_bin = num_bin > 2
    use_na = (missing == MISSING_NAN) & multi_bin
    skip_def = (missing == MISSING_ZERO) & multi_bin
    return multi_bin, use_na, skip_def, ~(use_na | skip_def)


def excluded_bins(bins, num_bin, default_bin, use_na, skip_def):
    """[F, B] mask of bins excluded from explicit accumulation (padding,
    the zero bin under missing=Zero, the NaN bin under missing=NaN)."""
    nan_bin = (num_bin - 1)[:, None]
    excl = bins >= num_bin[:, None]
    excl |= skip_def[:, None] & (bins == default_bin[:, None])
    excl |= use_na[:, None] & (bins == nan_bin)
    return excl


def candidate_gains(
    lg, lh, rg, rh, lc, rc, valid, mono_b, min_c, max_c, min_gain_shift, p
):
    """Masked split gains for one scan direction (broadcast-polymorphic)."""
    ok = (
        valid
        & (lc >= p.min_data_in_leaf)
        & (rc >= p.min_data_in_leaf)
        & (lh >= p.min_sum_hessian_in_leaf)
        & (rh >= p.min_sum_hessian_in_leaf)
    )
    lo = _leaf_output_constrained(lg, lh, p, min_c, max_c)
    ro = _leaf_output_constrained(rg, rh, p, min_c, max_c)
    g = _gain_given_output(lg, lh, lo, p) + _gain_given_output(rg, rh, ro, p)
    mono_bad = ((mono_b > 0) & (lo > ro)) | ((mono_b < 0) & (lo < ro))
    g = torch.where(mono_bad, torch.zeros_like(g), g)
    ok &= g > min_gain_shift
    return torch.where(ok, g, torch.full_like(g, K_MIN_SCORE))


def valid_pos_mask(thresholds, num_bin_b, default_bin_b, skip_def_b, not_single_b):
    """dir=+1 candidate validity (runs only for missing-handling scans)."""
    v = thresholds <= (num_bin_b - 2)
    v &= ~(skip_def_b & (thresholds == default_bin_b))
    return v & not_single_b


def valid_neg_mask(thresholds, num_bin_b, default_bin_b, skip_def_b, use_na_b):
    """dir=-1 candidate validity (excludes the NaN bin's threshold)."""
    v = thresholds <= (num_bin_b - 2 - use_na_b.to(torch.int32))
    return v & ~(skip_def_b & (thresholds == default_bin_b - 1))


def find_best_split_pair(
    hist: torch.Tensor,  # [C, F, B, 3], or [M, F, B, 3] with leaves
    sums: torch.Tensor,  # [C, 3]: sum_grad, sum_hess, num_data
    cons: torch.Tensor,  # [C, 2]: monotone window min, max
    feature_meta: Dict[str, torch.Tensor],  # num_bin/missing_type/default_bin/monotone [F]
    feature_mask: torch.Tensor,  # [F] bool
    params: SplitParams,
    two_way: bool = True,
    leaves: Optional[Sequence[int]] = None,  # rows of hist to scan, else all
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best numerical split of each of C leaves: ([C, 9] f32, [C, 4] int32).
    With ``leaves``, ``hist`` is the grower's [M, F, B, 3] and the C leaves
    are its rows ``leaves``."""
    p = params
    if leaves is not None:
        hist = hist[list(leaves)]
    C, F, B, _ = hist.shape
    dev = hist.device
    num_bin = feature_meta["num_bin"].to(torch.int32)
    missing = feature_meta["missing_type"].to(torch.int32)
    default_bin = feature_meta["default_bin"].to(torch.int32)
    mono = feature_meta["monotone"].to(torch.int32)[None, :, None]

    sum_grad = sums[:, 0].view(C, 1, 1)
    sum_hess = sums[:, 1].view(C, 1, 1)
    num_data = sums[:, 2].view(C, 1, 1)
    min_c = cons[:, 0].view(C, 1, 1)
    max_c = cons[:, 1].view(C, 1, 1)
    sum_hess_eff = sum_hess + 2 * K_EPSILON  # feature_histogram.hpp:87
    gain_shift = leaf_split_gain(sums[:, 0], sums[:, 1] + 2 * K_EPSILON, p)
    mgs = (gain_shift + p.min_gain_to_split).view(C, 1, 1)

    multi_bin, use_na, skip_def, single_scan = missing_flags(num_bin, missing)
    bins = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
    excl = excluded_bins(bins, num_bin, default_bin, use_na, skip_def)
    contrib = torch.where(excl[None, :, :, None], torch.zeros_like(hist), hist)
    prefix = _bin_prefix(contrib)  # [C, F, B, 3]
    total = prefix[:, :, B - 1, :]
    thresholds = bins[None]  # [1, 1, B]
    nb_b, db_b = num_bin[None, :, None], default_bin[None, :, None]

    def gains_for(lg, lh, rg, rh, lc, rc, valid):
        return candidate_gains(
            lg, lh, rg, rh, lc, rc, valid, mono, min_c, max_c, mgs, p
        )

    # ---- dir = +1 (left-to-right; default_left = False) ------------------
    lg_pos = prefix[..., 0]
    lh_pos = prefix[..., 1] + K_EPSILON
    lc_pos = prefix[..., 2]
    # ---- dir = -1 (right-to-left; default_left = True) -------------------
    rg_neg = total[:, :, None, 0] - prefix[..., 0]
    rh_neg = total[:, :, None, 1] - prefix[..., 1] + K_EPSILON
    rc_neg = total[:, :, None, 2] - prefix[..., 2]
    lg_neg = sum_grad - rg_neg
    lh_neg = sum_hess_eff - rh_neg
    lc_neg = num_data - rc_neg
    valid_neg = valid_neg_mask(
        thresholds, nb_b, db_b, skip_def[None, :, None], use_na[None, :, None]
    )
    gains_neg = gains_for(lg_neg, lh_neg, rg_neg, rh_neg, lc_neg, rc_neg, valid_neg)

    g_neg = gains_neg.max(dim=2).values  # [C, F]
    t_neg = torch.where(
        gains_neg >= g_neg[..., None], thresholds, torch.full_like(thresholds, -1)
    ).max(dim=2).values
    if two_way:
        valid_pos = valid_pos_mask(
            thresholds, nb_b, db_b, skip_def[None, :, None], (~single_scan)[None, :, None]
        )
        gains_pos = gains_for(
            lg_pos, lh_pos, sum_grad - lg_pos, sum_hess_eff - lh_pos,
            lc_pos, num_data - lc_pos, valid_pos,
        )
        g_pos = gains_pos.max(dim=2).values
        t_pos = torch.where(
            gains_pos >= g_pos[..., None], thresholds, torch.full_like(thresholds, BIG_I)
        ).min(dim=2).values
        use_pos = g_pos > g_neg  # strict: +1 must beat -1
        g_f = torch.where(use_pos, g_pos, g_neg)
        t_f = torch.where(use_pos, t_pos, t_neg)
    else:
        use_pos = torch.zeros((C, F), dtype=torch.bool, device=dev)
        g_f, t_f = g_neg, t_neg
    dl_f = ~use_pos
    two_bin_nan = (missing == MISSING_NAN) & ~multi_bin
    dl_f = dl_f & ~two_bin_nan[None, :]
    g_f = torch.where(feature_mask.to(torch.bool)[None, :], g_f, torch.full_like(g_f, K_MIN_SCORE))

    def at_t(a_pos, a_neg):  # [C, F] value at each feature's threshold/direction
        idx = t_f.long()[..., None]
        return torch.where(
            use_pos, a_pos.gather(2, idx)[..., 0], a_neg.gather(2, idx)[..., 0]
        )

    lg_f = at_t(lg_pos, lg_neg)
    lh_f = at_t(lh_pos, lh_neg)  # includes +eps
    lc_f = at_t(lc_pos, lc_neg)

    # ---- feature argmax (first max wins ties = smallest index) -----------
    g_best = g_f.max(dim=1).values  # [C]
    f_iota = torch.arange(F, dtype=torch.int32, device=dev)[None, :]
    f_best = torch.where(
        g_f >= g_best[:, None], f_iota, torch.full_like(f_iota, BIG_I)
    ).min(dim=1).values
    has_split = g_best > K_MIN_SCORE
    f_best = torch.where(has_split, f_best, torch.zeros_like(f_best))
    sel = f_best.long()[:, None]

    def pick(a):
        return a.gather(1, sel)[:, 0]

    left_g, left_h, left_c = pick(lg_f), pick(lh_f), pick(lc_f)
    right_g = sums[:, 0] - left_g
    right_h = (sums[:, 1] + 2 * K_EPSILON) - left_h
    right_c = sums[:, 2] - left_c
    left_out = _leaf_output_constrained(left_g, left_h, p, cons[:, 0], cons[:, 1])
    right_out = _leaf_output_constrained(right_g, right_h, p, cons[:, 0], cons[:, 1])
    gain = torch.where(has_split, g_best - mgs.view(C), torch.full_like(g_best, K_MIN_SCORE))
    outf = torch.stack(
        [
            gain, left_g, left_h - K_EPSILON, left_c,
            right_g, right_h - K_EPSILON, right_c, left_out, right_out,
        ],
        dim=-1,
    ).to(torch.float32)
    outi = torch.stack(
        [
            torch.where(has_split, f_best, torch.full_like(f_best, -1)),
            pick(t_f),
            torch.zeros_like(f_best),
            pick(dl_f.to(torch.int32)),
        ],
        dim=-1,
    ).to(torch.int32)
    return outf, outi


def find_best_split(
    hist: torch.Tensor,  # [F, B, 3]
    sum_grad, sum_hess, num_data,  # leaf totals (scalars)
    min_constraint, max_constraint,  # the leaf's monotone window
    feature_meta: Dict[str, torch.Tensor],
    feature_mask: torch.Tensor,
    params: SplitParams,
    two_way: bool = True,
) -> SplitResult:
    """Best numerical split of one leaf (lightgbm_tpu/ops/split.py
    ``find_best_split``): ``find_best_split_pair`` on a single leaf, with
    scalar fields."""
    dev = hist.device

    def row(*xs):
        return torch.stack([torch.as_tensor(x, dtype=torch.float32, device=dev) for x in xs])[None]

    outf, outi = find_best_split_pair(
        hist[None], row(sum_grad, sum_hess, num_data), row(min_constraint, max_constraint),
        feature_meta, feature_mask, params, two_way,
    )
    return SplitResult(*(field[0] for field in unpack(outf, outi)))


def split_pair_step(s: gs.GrowState, C: int) -> None:
    """The split loop's scan on a :class:`~.grow_state.GrowState` ``s``:
    :func:`find_best_split_pair` of leaf ``ctl[BEST]`` (C = 1, the root) or
    of the children ``ctl[BEST]`` and ``ctl[NEW]`` (C = 2) out of
    ``s.hist``, their sums and windows from ``s.laux``, each record written
    to the leaf's row of ``s.best_f`` / ``s.best_i`` with the gain -inf at a
    depth >= ``s.max_depth`` (> 0). Nothing once ``ctl[ACTIVE]`` is 0. The
    plain version of ops/split_kernel.py ``split_pair_step``."""
    ctl = s.ctl
    if not int(ctl[gs.ACTIVE]):
        return
    leaves = [int(ctl[gs.BEST]), int(ctl[gs.NEW])][:C]
    aux = s.laux[leaves]
    outf, outi = find_best_split_pair(
        s.hist, aux[:, :3].contiguous(), aux[:, 3:].contiguous(), s.feature_meta,
        s.feature_mask, s.params, s.two_way, leaves,
    )
    if s.max_depth > 0:
        outf[s.leaf_i[leaves, 1] >= s.max_depth, 0] = K_MIN_SCORE
    s.best_f[leaves] = outf
    s.best_i[leaves] = outi
