"""Best split over leaf histograms: the plain PyTorch version.

Counterpart of lightgbm_tpu/ops/split.py's ``find_best_split`` and its
helpers (feature_histogram.hpp:91-650 semantics): kEpsilon seeds,
missing-value scan directions, L1/L2/max_delta_step, the monotone clamp and
the reference tie-breaks (dir=-1 prefers the largest threshold among equal
gains, dir=+1 the smallest, dir=+1 must strictly beat dir=-1, the feature
argmax the smallest index). ``find_best_split_pair`` scans C children at
once and returns the packed record of lightgbm_tpu/ops/grow.py (``_BEST_F``
order, [C, 9] f32, plus [C, 4] int32 feature/threshold/num_cat/
default_left) — the output of the Pallas kernel
lightgbm_tpu/ops/split_pallas.py:find_best_split_pair_pallas — and the
[C, W] int32 words of each winner's left-side bin membership. It is the
oracle of the CUDA kernel in ops/split_kernel.py, op for op.

Categorical features (``is_categorical`` in the meta, whose presence is the
switch, as in the JAX package) take the reference's categorical candidates
alone (lightgbm_tpu/ops/split.py:325-468, FindBestThresholdCategorical):
the one-hot branch when num_bin <= max_cat_to_onehot, else the CTR-sorted
many-vs-many scan from both ends with cat_l2 and min_data_per_group. Their
membership is a bitset over bins, W = ceil(B / 32) words, bit b of word
b // 32 for bin b; a numerical winner's is the one-hot of its threshold.
Without categorical features W is 0.

The inclusive bin prefix is a sequential left fold in f32 (the CPU fold
order of lightgbm_tpu/ops/split.py ``_bin_prefix``), not ``torch.cumsum``,
whose CPU kernel accumulates floats in double.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
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
    # categorical split knobs (config.h:510-540), the reference's defaults
    max_cat_to_onehot: int = 4
    cat_smooth: float = 10.0
    cat_l2: float = 10.0
    max_cat_threshold: int = 32
    min_data_per_group: int = 100


class CegbParams(NamedTuple):
    """CEGB (cost-effective gradient boosting) switches (config.h:389-405),
    lightgbm_tpu/ops/split.py ``CegbParams``: the tradeoff, the split
    penalty, and whether the coupled and the lazy per-feature penalty
    vectors are given (the vectors themselves ride in ops/grow_state.py
    ``Cegb``)."""

    tradeoff: float = 1.0
    penalty_split: float = 0.0
    has_coupled: bool = False
    has_lazy: bool = False

    @property
    def enabled(self) -> bool:
        return self.penalty_split != 0.0 or self.has_coupled or self.has_lazy


def cegb_penalty(cegb: CegbParams, count: torch.Tensor, feature_used: torch.Tensor,
                 unused: Optional[torch.Tensor], coupled_t: Optional[torch.Tensor],
                 lazy_t: Optional[torch.Tensor]) -> torch.Tensor:
    """[C, F] f32 gain penalties of C leaves (lightgbm_tpu/ops/grow.py:1010-1020,
    ``leaf_penalties``; serial_tree_learner.cpp:537-543, 568-573): the f32
    ``tradeoff * penalty_split`` times each leaf's ``count`` [C], plus
    ``coupled_t[f]`` (``tradeoff * coupled``, f32) where feature f is not
    yet ``feature_used`` [F], plus ``lazy_t[f]`` (``tradeoff * lazy``) times
    the leaf's ``unused`` [C, F] count of bagged rows that have not paid for
    f, in that order of f32 operations."""
    ps = torch.tensor(np.float32(cegb.tradeoff * cegb.penalty_split), device=count.device)
    pen = (ps * count.to(torch.float32))[:, None].expand(count.numel(), feature_used.numel())
    if cegb.has_coupled:
        pen = pen + coupled_t[None, :] * (~feature_used.to(torch.bool))[None, :].to(torch.float32)
    if cegb.has_lazy:
        pen = pen + lazy_t[None, :] * unused
    return pen


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
    cat_bitset: torch.Tensor  # [W] int32 words of the left-side bin membership


def unpack(outf: torch.Tensor, outi: torch.Tensor, outb: torch.Tensor) -> SplitResult:
    """Packed ([C, 9] f32, [C, 4] int32, [C, W] int32) records -> SplitResult."""
    kw = {n: outf[:, k] for k, n in enumerate(BEST_F)}
    kw.update(
        feature=outi[:, 0], threshold=outi[:, 1], num_cat=outi[:, 2],
        default_left=outi[:, 3] > 0, cat_bitset=outb,
    )
    return SplitResult(**kw)


def num_words(num_bins: int, categorical: bool) -> int:
    """Words of a membership bitset over ``num_bins`` bins: ceil(B / 32)
    with categorical features, else 0."""
    return -(-num_bins // 32) if categorical else 0


def member_words(member: torch.Tensor, W: int) -> torch.Tensor:
    """[..., B] bool membership -> [..., W] int32 words (bit b % 32 of word
    b // 32 is bin b)."""
    B = member.shape[-1]
    if W == 0:
        return torch.zeros(member.shape[:-1] + (0,), dtype=torch.int32, device=member.device)
    bits = torch.zeros(member.shape[:-1] + (W * 32,), dtype=torch.int64, device=member.device)
    bits[..., :B] = member.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=member.device)
    words = (bits.view(member.shape[:-1] + (W, 32)) << shifts).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def words_member(words: torch.Tensor, B: int) -> torch.Tensor:
    """[..., W] int32 words -> [..., B] bool membership."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words.to(torch.int64)[..., None] >> shifts) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :B] > 0


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
    sequential f32 left fold (on the CPU numpy's ``add.accumulate``, the
    same fold)."""
    if contrib.device.type == "cpu" and contrib.dtype == torch.float32:
        return torch.from_numpy(np.add.accumulate(contrib.numpy(), axis=-2, dtype=np.float32))
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


class CatCandidates(NamedTuple):
    """Each feature's best categorical candidate ([C, F] unless noted)."""

    gain: torch.Tensor  # -inf where none
    threshold: torch.Tensor  # int32: the one-hot bin, or the CTR candidate index
    left_g: torch.Tensor
    left_h: torch.Tensor  # includes +kEpsilon
    left_c: torch.Tensor
    member: torch.Tensor  # [C, F, B] bool: the left side's bins
    num_cat: torch.Tensor  # int32
    use_ctr: torch.Tensor  # [F] bool: the CTR branch (cat_l2 in the leaf outputs)


def categorical_candidates(hist, sum_grad, sum_hess, num_data, min_c, max_c, mgs,
                           num_bin, missing, p: SplitParams) -> CatCandidates:
    """FindBestThresholdCategorical (feature_histogram.hpp:118-279) of every
    feature of C leaves, op for op lightgbm_tpu/ops/split.py:325-468.
    ``hist`` [C, F, B, 3]; the sums, windows and ``mgs`` (min_gain_shift)
    [C, 1, 1]. The one-hot branch (num_bin <= max_cat_to_onehot): the left
    side is one bin, the smallest among equal gains. The CTR branch: the bins
    below used_bin with a count >= cat_smooth, stably sorted by
    sum_grad / (sum_hess + cat_smooth), scanned from both ends (the right
    side's hessian sum_hess, not sum_hess_eff), lambda_l2 + cat_l2 in gains
    and outputs, candidates grouped by min_data_per_group in order (the
    count resets when one is emitted), at most min(max_cat_threshold,
    (used + 1) // 2) categories on the left, the first maximum of [forward,
    reverse] winning."""
    C, F, B, _ = hist.shape
    dev = hist.device
    i32 = torch.int32
    bins = torch.arange(B, dtype=i32, device=dev)
    used_bin = (num_bin - (missing != MISSING_NONE).to(i32)).view(1, F, 1)

    # ---- one-hot branch: left = the single bin t -------------------------
    oh_lg, oh_lh_raw, oh_lc = hist[..., 0], hist[..., 1], hist[..., 2]
    oh_lh = oh_lh_raw + K_EPSILON
    oh_rg = sum_grad - oh_lg
    oh_rh = (sum_hess + 2 * K_EPSILON) - oh_lh
    oh_rc = num_data - oh_lc
    oh_valid = bins < used_bin
    oh_valid = oh_valid & (oh_lc >= p.min_data_in_leaf) & (oh_rc >= p.min_data_in_leaf)
    oh_valid = oh_valid & (oh_lh_raw >= p.min_sum_hessian_in_leaf) & (
        oh_rh >= p.min_sum_hessian_in_leaf)
    oh_lo = _leaf_output_constrained(oh_lg, oh_lh, p, min_c, max_c)
    oh_ro = _leaf_output_constrained(oh_rg, oh_rh, p, min_c, max_c)
    oh_g = _gain_given_output(oh_lg, oh_lh, oh_lo, p) + _gain_given_output(oh_rg, oh_rh, oh_ro, p)
    oh_valid = oh_valid & (oh_g > mgs)
    gains_oh = torch.where(oh_valid, oh_g, torch.full_like(oh_g, K_MIN_SCORE))
    t_oh = torch.argmax(gains_oh, dim=2, keepdim=True)  # the first max: the smallest bin
    g_oh = gains_oh.gather(2, t_oh)[..., 0]

    # ---- CTR-sorted branch -------------------------------------------------
    p_cat = p._replace(lambda_l2=p.lambda_l2 + p.cat_l2)
    bin_valid = (bins < used_bin) & (oh_lc >= p.cat_smooth)  # [C, F, B]
    ctr = hist[..., 0] / (hist[..., 1] + p.cat_smooth)
    key = torch.where(bin_valid, ctr, torch.full_like(ctr, math.inf))
    sort_idx = torch.sort(key, dim=2, stable=True).indices
    rank = torch.empty_like(sort_idx).scatter_(
        2, sort_idx, torch.arange(B, device=dev).expand_as(sort_idx))
    used_ctr = bin_valid.sum(dim=2, keepdim=True).to(i32)  # [C, F, 1]
    max_num_cat = torch.clamp((used_ctr + 1) // 2, max=p.max_cat_threshold)
    i_pos = bins.view(1, 1, B)
    hist_sorted = hist.gather(2, sort_idx[..., None].expand(C, F, B, 3))

    def ctr_dir(h_dir):
        """Gains and left sums of the candidates of one direction: candidate
        i takes the first i + 1 bins of ``h_dir`` [C, F, B, 3]."""
        pref = _bin_prefix(h_dir)
        lg = pref[..., 0]
        lh = pref[..., 1] + K_EPSILON
        lc = pref[..., 2]
        rg = sum_grad - lg
        rh = sum_hess - lh
        rc = num_data - lc
        left_ok = (lc >= p.min_data_in_leaf) & (lh >= p.min_sum_hessian_in_leaf)
        right_ok = ((rc >= p.min_data_in_leaf) & (rc >= p.min_data_per_group)
                    & (rh >= p.min_sum_hessian_in_leaf))
        ok_i = left_ok & right_ok
        emit = torch.zeros_like(ok_i)
        gcnt = torch.zeros((C, F), dtype=hist.dtype, device=dev)
        # positions past a feature's used bins emit nothing that counts
        for i in range(int(used_ctr.max()) if B else 0):
            gcnt = gcnt + h_dir[:, :, i, 2]
            e = ok_i[:, :, i] & (gcnt >= p.min_data_per_group)
            emit[:, :, i] = e
            gcnt = torch.where(e, torch.zeros_like(gcnt), gcnt)
        lo = _leaf_output_constrained(lg, lh, p_cat, min_c, max_c)
        ro = _leaf_output_constrained(rg, rh, p_cat, min_c, max_c)
        g = _gain_given_output(lg, lh, lo, p_cat) + _gain_given_output(rg, rh, ro, p_cat)
        ok = emit & (i_pos < used_ctr) & (i_pos < max_num_cat) & (g > mgs)
        return torch.where(ok, g, torch.full_like(g, K_MIN_SCORE)), lg, lh, lc

    g_fwd, lg_fwd, lh_fwd, lc_fwd = ctr_dir(hist_sorted)
    # the reverse traversal starts at sorted position used_ctr - 1 and walks down
    rev_pos = torch.clamp(used_ctr - 1 - i_pos, 0, B - 1).long()
    g_rev, lg_rev, lh_rev, lc_rev = ctr_dir(
        hist_sorted.gather(2, rev_pos[..., None].expand(C, F, B, 3)))
    g_all = torch.cat([g_fwd, g_rev], dim=2)  # candidate order: forward, then reverse
    j_best = torch.argmax(g_all, dim=2, keepdim=True)  # the first maximum
    g_ctr = g_all.gather(2, j_best)[..., 0]
    fwd_won = j_best < B
    i_best = torch.where(fwd_won, j_best, j_best - B)

    def pick_dir(a_fwd, a_rev):
        return torch.where(fwd_won, a_fwd.gather(2, i_best), a_rev.gather(2, i_best))[..., 0]

    member_ctr = torch.where(fwd_won, rank <= i_best, rank >= used_ctr - 1 - i_best) & bin_valid

    # per feature, one-hot or CTR by num_bin, not by gain
    use_onehot = (num_bin <= p.max_cat_to_onehot).view(1, F)
    oh = use_onehot[..., None]
    return CatCandidates(
        gain=torch.where(use_onehot, g_oh, g_ctr),
        threshold=torch.where(use_onehot, t_oh[..., 0], i_best[..., 0]).to(i32),
        left_g=torch.where(use_onehot, oh_lg.gather(2, t_oh)[..., 0], pick_dir(lg_fwd, lg_rev)),
        left_h=torch.where(use_onehot, oh_lh.gather(2, t_oh)[..., 0], pick_dir(lh_fwd, lh_rev)),
        left_c=torch.where(use_onehot, oh_lc.gather(2, t_oh)[..., 0], pick_dir(lc_fwd, lc_rev)),
        member=torch.where(oh, bins == t_oh, member_ctr),
        num_cat=torch.where(use_onehot, torch.ones_like(i_best[..., 0]), i_best[..., 0] + 1).to(i32),
        use_ctr=~use_onehot[0],
    )


def find_best_split_pair(
    hist: torch.Tensor,  # [C, F, B, 3], or [M, F, B, 3] with leaves
    sums: torch.Tensor,  # [C, 3]: sum_grad, sum_hess, num_data
    cons: torch.Tensor,  # [C, 2]: monotone window min, max
    feature_meta: Dict[str, torch.Tensor],  # num_bin/missing_type/default_bin/monotone [F]
    feature_mask: torch.Tensor,  # [F] bool
    params: SplitParams,
    two_way: bool = True,
    leaves: Optional[Sequence[int]] = None,  # rows of hist to scan, else all
    penalty: Optional[torch.Tensor] = None,  # [C, F] f32 CEGB gain penalties
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best split of each of C leaves: ([C, 9] f32, [C, 4] int32, [C, W]
    int32 membership words). With ``leaves``, ``hist`` is the grower's [M,
    F, B, 3] and the C leaves are its rows ``leaves``. ``penalty``
    (:func:`cegb_penalty`) is subtracted from each feature's best gain
    before the argmax over features, and the record's gain is the
    penalised one (lightgbm_tpu/ops/split.py:649-653)."""
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
    is_cat = feature_meta.get("is_categorical")
    W = num_words(B, is_cat is not None)
    if is_cat is not None:  # categorical features take their categorical candidate alone
        is_cat = is_cat.to(device=dev, dtype=torch.bool)[None, :]
        cat = categorical_candidates(hist, sum_grad, sum_hess, num_data, min_c, max_c, mgs,
                                     num_bin, missing, p)
        g_f = torch.where(is_cat, cat.gain, g_f)
        t_f = torch.where(is_cat, cat.threshold, t_f)
        dl_f = dl_f & ~is_cat
    g_f = torch.where(feature_mask.to(torch.bool)[None, :], g_f, torch.full_like(g_f, K_MIN_SCORE))
    if penalty is not None:
        g_f = g_f - penalty

    def at_t(a_pos, a_neg):  # [C, F] value at each feature's threshold/direction
        idx = t_f.long()[..., None]
        return torch.where(
            use_pos, a_pos.gather(2, idx)[..., 0], a_neg.gather(2, idx)[..., 0]
        )

    lg_f = at_t(lg_pos, lg_neg)
    lh_f = at_t(lh_pos, lh_neg)  # includes +eps
    lc_f = at_t(lc_pos, lc_neg)
    if W:
        lg_f = torch.where(is_cat, cat.left_g, lg_f)
        lh_f = torch.where(is_cat, cat.left_h, lh_f)
        lc_f = torch.where(is_cat, cat.left_c, lc_f)

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
    t_best = pick(t_f)
    num_cat = torch.zeros_like(f_best)
    member = bins == t_best[:, None]  # a numerical winner's: the one-hot of its threshold
    if W:
        # the CTR branch's leaf outputs take lambda_l2 + cat_l2 (feature_histogram.hpp:246-255)
        win_cat = is_cat[0].gather(0, f_best.long())
        use_ctr = win_cat & cat.use_ctr.gather(0, f_best.long())
        p_cat = p._replace(lambda_l2=p.lambda_l2 + p.cat_l2)
        left_out = torch.where(use_ctr, _leaf_output_constrained(
            left_g, left_h, p_cat, cons[:, 0], cons[:, 1]), left_out)
        right_out = torch.where(use_ctr, _leaf_output_constrained(
            right_g, right_h, p_cat, cons[:, 0], cons[:, 1]), right_out)
        num_cat = torch.where(win_cat, pick(cat.num_cat), num_cat)
        cat_member = cat.member.gather(1, sel[..., None].expand(C, 1, B))[:, 0]
        member = torch.where(win_cat[:, None], cat_member, member)
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
            t_best,
            num_cat,
            pick(dl_f.to(torch.int32)),
        ],
        dim=-1,
    ).to(torch.int32)
    return outf, outi, member_words(member, W)


def find_best_split(
    hist: torch.Tensor,  # [F, B, 3]
    sum_grad, sum_hess, num_data,  # leaf totals (scalars)
    min_constraint, max_constraint,  # the leaf's monotone window
    feature_meta: Dict[str, torch.Tensor],
    feature_mask: torch.Tensor,
    params: SplitParams,
    penalty: Optional[torch.Tensor] = None,  # [F] CEGB gain penalty
    two_way: bool = True,
) -> SplitResult:
    """Best numerical split of one leaf (lightgbm_tpu/ops/split.py
    ``find_best_split``, whose argument order this keeps):
    ``find_best_split_pair`` on a single leaf, with scalar fields."""
    dev = hist.device

    def row(*xs):
        return torch.stack([torch.as_tensor(x, dtype=torch.float32, device=dev) for x in xs])[None]

    outf, outi, outb = find_best_split_pair(
        hist[None], row(sum_grad, sum_hess, num_data), row(min_constraint, max_constraint),
        feature_meta, feature_mask, params, two_way,
        penalty=None if penalty is None else penalty.reshape(1, -1),
    )
    return SplitResult(*(field[0] for field in unpack(outf, outi, outb)))


def gather_info_for_threshold(
    hist_f: torch.Tensor,  # [B, 3] one feature's histogram
    sum_grad, sum_hess, num_data,  # the leaf's totals (f32 scalars)
    threshold: int, num_bin: int, missing_type: int, default_bin: int, is_cat: bool,
    params: SplitParams,
) -> SplitResult:
    """The record of a forced (feature, threshold) split
    (FeatureHistogram::GatherInfoForThreshold, feature_histogram.hpp:281-420;
    lightgbm_tpu/ops/split.py ``gather_info_for_threshold``, op for op).
    Numerical: the right side is bins ``max(threshold, 1) .. num_bin - 1 -
    use_na``, the default bin skipped under missing=Zero, summed in bin
    order (a left fold in f32, which csrc/split_pair.cu's forced record
    follows), ``default_left`` True. Categorical: the left side is the
    single bin (one-hot), ``default_left`` False. The outputs are
    unconstrained; the gain is -inf unless the split's gain is above
    ``min_gain_shift`` (the leaf's unshifted gain plus min_gain_to_split).
    The feature is left -1 for the caller; ``cat_bitset`` is the bool
    one-hot of the threshold over the B bins."""
    p = params
    B = hist_f.shape[0]
    f32 = torch.float32
    dev = hist_f.device

    def t(x):
        return torch.as_tensor(x, dtype=f32, device=dev)

    sum_grad, sum_hess, num_data = t(sum_grad), t(sum_hess), t(num_data)
    use_na = missing_type == MISSING_NAN
    skip_def = missing_type == MISSING_ZERO
    min_gain_shift = leaf_split_gain(sum_grad, sum_hess, p) + p.min_gain_to_split
    right = torch.zeros(3, dtype=f32, device=dev)
    if not is_cat:
        for b in range(max(threshold, 1), min(num_bin - 1 - int(use_na), B - 1) + 1):
            if not (skip_def and b == default_bin):
                right = right + hist_f[b]
        lg = sum_grad - right[0]
        lh = sum_hess - (right[1] + K_EPSILON)
        lc = num_data - right[2]
        ok_cat = True
    else:
        left = hist_f[threshold] if 0 <= threshold < B else torch.zeros(3, dtype=f32, device=dev)
        lg, lh, lc = left[0], left[1] + K_EPSILON, left[2]
        ok_cat = threshold < num_bin - (0 if missing_type == MISSING_NONE else 1)
    rg = sum_grad - lg
    rh = sum_hess - lh
    rc = num_data - lc
    current_gain = leaf_split_gain(lg, lh, p) + leaf_split_gain(rg, rh, p)
    ok = bool(current_gain > min_gain_shift) and ok_cat and not bool(torch.isnan(current_gain))
    gain = current_gain - min_gain_shift if ok else t(K_MIN_SCORE)
    bitset = torch.arange(B, device=dev) == threshold
    return SplitResult(
        gain=gain.to(f32), feature=torch.tensor(-1, dtype=torch.int32),
        threshold=torch.tensor(threshold, dtype=torch.int32),
        default_left=torch.tensor(not is_cat),
        left_sum_grad=lg, left_sum_hess=lh - K_EPSILON, left_count=lc,
        right_sum_grad=rg, right_sum_hess=rh - K_EPSILON, right_count=rc,
        left_output=calculate_leaf_output(lg, lh, p), right_output=calculate_leaf_output(rg, rh, p),
        num_cat=torch.tensor(1 if is_cat else 0, dtype=torch.int32), cat_bitset=bitset,
    )


def split_pair_step(s: gs.GrowState, C: int, penalised: bool = True) -> None:
    """The split loop's scan on a :class:`~.grow_state.GrowState` ``s``:
    :func:`find_best_split_pair` of leaf ``ctl[BEST]`` (C = 1, the root) or
    of the children ``ctl[BEST]`` and ``ctl[NEW]`` (C = 2) out of
    ``s.hist`` (a pool's rows by slot), their sums and windows from
    ``s.laux``, each record written
    to the leaf's row of ``s.best_f`` / ``s.best_i`` with the gain -inf at a
    depth >= ``s.max_depth`` (> 0); under CEGB penalised unless
    ``penalised`` is False. Nothing once ``ctl[ACTIVE]`` is 0. The plain
    version of ops/split_kernel.py ``split_pair_step``."""
    ctl = s.ctl
    if not int(ctl[gs.ACTIVE]):
        return
    _scan_leaves(s, [int(ctl[gs.BEST]), int(ctl[gs.NEW])][:C], penalised)


def _scan_leaves(s: gs.GrowState, leaves, penalised: bool = True) -> None:
    """The records of ``leaves`` of the state, penalised under CEGB (unless
    ``penalised`` is False), the gain -inf at a depth >= ``s.max_depth`` (> 0)."""
    aux = s.laux[leaves]
    outf, outi, outb = find_best_split_pair(
        s.hist, aux[:, :3].contiguous(), aux[:, 3:].contiguous(), s.feature_meta,
        s.feature_mask, s.params, s.two_way, [s.hist_row(leaf) for leaf in leaves],
        penalty=state_penalty(s, leaves) if penalised else None,
    )
    if s.max_depth > 0:
        outf[s.leaf_i[leaves, 1] >= s.max_depth, 0] = K_MIN_SCORE
    s.best_f[leaves] = outf
    s.best_i[leaves] = outi
    s.best_b[leaves] = outb


def state_penalty(s: gs.GrowState, leaves) -> Optional[torch.Tensor]:
    """[len(leaves), F] CEGB penalties of ``leaves`` of the state
    (:func:`cegb_penalty` from its laux counts, the training's paid features
    and the leaves' unused counts), or None without CEGB."""
    c = s.cegb
    if c is None:
        return None
    return cegb_penalty(c.params, s.laux[leaves, 2], c.feature_used,
                        s.unused_cnt[leaves] if c.params.has_lazy else None, c.coupled_t, c.lazy_t)


def split_pair_all(s: gs.GrowState) -> int:
    """CEGB's rescan of every other leaf after a step that paid a coupled
    feature first (``ctl[NEWLY]``; lightgbm_tpu/ops/grow.py:1022-1047
    ``rescan_all``): the penalised records of the leaves below
    ``ctl[NUM_LEAVES]`` but the step's two children (which the folded scan
    rescanned). Nothing once ``ctl[ACTIVE]`` is 0 or on a step that paid
    nothing new. The plain version of csrc/split_pair.cu's all-leaves entry.

    Under a histogram pool (``rescan_resident``, :1049-1108) only the
    leaves that hold a slot (``slot_leaf``, stamped) are rescanned, from
    their slot's row: the step's two children at every step (a pooled
    step's folded scan is not penalised, ops/grow_step.py
    ``split_pair_fold``; so with or without coupled penalties), the
    others after a first payment. Then every
    other leaf keeps its cached record, whose gain takes the step's
    feature's coupled penalty back (``coupled_t[f]`` added, f32) when that
    record's feature is the step's split feature ``f`` and its gain is
    above -inf. Returns the records so patched (0 without a pool): a
    resident leaf's cached record equals its rescan except at a first
    payment, so the reference's rescan of every step and this one give
    the same records."""
    ctl = s.ctl
    if not int(ctl[gs.ACTIVE]):
        return 0
    newly = bool(int(ctl[gs.NEWLY]))
    children = (int(ctl[gs.BEST]), int(ctl[gs.NEW]))
    nl = int(ctl[gs.NUM_LEAVES])
    if not s.P:
        leaves = [leaf for leaf in range(nl) if leaf not in children]
        if newly and leaves:
            _scan_leaves(s, leaves)
        return 0
    resident = [int(leaf) for q, leaf in enumerate(s.slot_leaf.tolist())
                if 0 <= leaf < nl and int(s.slot_age[q]) > 0 and (newly or leaf in children)]
    if resident:
        _scan_leaves(s, resident)
    if not newly:
        return 0
    f = int(s.node_i[int(ctl[gs.STEP]) - 1, 0])
    evicted = (s.slot_of[:nl] < 0) & (s.best_i[:nl, 0] == f) & (s.best_f[:nl, 0] > K_MIN_SCORE)
    s.best_f[:nl, 0][evicted] += s.cegb.coupled_t[f]
    return int(evicted.sum())


def forced_record(s: gs.GrowState, k: int) -> None:
    """Step ``k`` of the forced-split preamble's record
    (lightgbm_tpu/ops/grow.py:1600-1637): :func:`gather_info_for_threshold`
    of the table's row k (leaf, feature, threshold) from the leaf's
    histogram (its slot under a pool) and laux sums, into ``frec_f`` /
    ``frec_i`` / ``frec_b`` and ``ctl[FLEAF]``; an invalid split (gain -inf,
    or the leaf at ``max_depth`` > 0) sets ``ctl[ABORT]`` instead. Nothing
    once ``ctl[ACTIVE]`` is 0 or the preamble has aborted. The plain version
    of csrc/split_pair.cu's forced record."""
    ctl = s.ctl
    if not int(ctl[gs.ACTIVE]) or int(ctl[gs.ABORT]):
        return
    leaf, f, thr = (int(v) for v in s.forced[k])
    row = max(s.hist_row(leaf), 0)
    m = s.feature_meta
    cat = s.is_cat is not None and bool(s.is_cat[f])
    rec = gather_info_for_threshold(
        s.hist[row, f], s.laux[leaf, 0], s.laux[leaf, 1], s.laux[leaf, 2], thr,
        int(m["num_bin"][f]), int(m["missing_type"][f]), int(m["default_bin"][f]), cat, s.params)
    depth_ok = s.max_depth <= 0 or int(s.leaf_i[leaf, 1]) < s.max_depth
    if not (bool(rec.gain > K_MIN_SCORE) and depth_ok):
        ctl[gs.ABORT] = 1
        return
    s.frec_f.copy_(torch.stack([getattr(rec, n) for n in BEST_F]).to(torch.float32))
    s.frec_i.copy_(torch.tensor([f, thr, int(rec.num_cat), int(bool(rec.default_left))],
                                dtype=torch.int32))
    s.frec_b.copy_(member_words(rec.cat_bitset, s.W))
    ctl[gs.FLEAF] = leaf
