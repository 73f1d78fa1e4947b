"""Drive the PyTorch port's training path on one NVIDIA GPU and check it.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--out results.json]

Phases (each prints one line; any failure exits non-zero):
 1. device and build: the card, its power limit, every kernel source of
    lightgbm_tpu_torch/csrc built with one nvcc each, all started at once,
    and each kernel's registers per thread and spill bytes as ptxas reports
    them (hist_v1's instances on their own, none spilling);
 2. leaf-histogram kernel vs its plain PyTorch version at the root shape
    (1M rows x 28 features, B=255) and at a leaf segment given by ``rows``:
    exact on dyadic values, within the f32 bound of two summation orders on
    real gradients; times against the bound and one ``index_add_``; then,
    on a line of its own, the kernel at the sizes of one tree's calls
    (sorted random segments of 256, 1024, 4096, 16384 and 100k rows, and
    the root) in f32 and bf16: exact on dyadic values, hist_v1 equal to it;
    hist_v1 on real values equal bit for bit to its host mirror
    (``hist_kernel.hist_v1_mirror``) up to 100k rows and to itself over 5
    calls at the root; each time beside its bytes bound and hist_v1's time
    on the same rows;
 3. two-child split-scan kernel vs its plain version on both children of
    phase 2's histograms, with missing types none/zero/nan and a monotone
    feature: every field exact (NaN where both are NaN) on dyadic and on
    real-valued histograms, also read by leaf index out of a grower-like
    buffer, and on 300 features of synthetic dyadic histograms;
 4. the main path: ``lightgbm_tpu_torch.train`` on make_higgs_like(1M, 28),
    binary, max_bin=255, num_leaves=255, learning_rate=0.1, 10 iterations,
    with the kernels' launch counters set to 0 just before and read just
    after; iterations per second and the training AUC; then one more
    iteration under torch.profiler for the device busy time by kernel, the
    top 8 and every kernel of the split scan or of an indexing copy;
 5. the same configuration at 100k rows for 3 iterations on device="cuda"
    and device="cpu" (the plain versions), every histogram call of the CUDA
    run held to its plain version within the two-order bound: trees equal
    up to an f32 near-tie flip; each side's split gains against the f64
    gains of its own splits, the kernel's largest error no larger than the
    plain version's; at a flip, the CUDA run's split no worse in f64 than
    the plain version's (rtol 1e-5); raw scores of all 3 trees within rtol
    1e-4 / atol 1e-4; and each side's root histogram against an f64 sum;
 6. the histogram kernel family on synthetic 1M x 28 bins at B = 15, 63 and
    255 with f32 and bf16 operands: every kernel the caps allow (histogram,
    hist_onehot, hist_bitplane, hist_packed4 at B=15, and the oracle
    hist_v1), at the root and at a 100k-row segment, against its plain
    version (exact on dyadic values, within the two-order bound on real
    ones) and hist_v1 against histogram, and on real values against its
    mirror at the segment and itself at the root; hist_packed4 reads the nibble-packed
    copy the grower makes at set-up, by row at the segment, and is also
    timed at the root on pack4's input; times against the bytes bound and
    one ``index_add_``, and hist_onehot's root times at every width on a
    line of their own;
 7. the tune sweep: ``python -m lightgbm_tpu_torch.obs.tune`` in process at
    1M rows, at the widths the datasets at max_bin 15/63/255 emit, f32 and
    bf16, into a temporary table; every winner is a hand-written kernel;
 8. routed training, 10 iterations at 1M x 28 each: under the sweep's table
    at (max_bin 15, f32), (63, bf16) and (255, bf16), and under a hand-built
    table that sends alternate row classes to cuda_onehot / cuda_bitplane
    (and cuda_packed4) at (63, f32) and (15, f32); every routable kernel
    launches; each run is timed, then trained again with every call of
    each routed kernel held to its plain version on the same rows within
    the two-order bound; AUC > 0.7 in both, and the
    f32 runs grow the default route's trees up to a flip whose gain gap
    lies within the f32 error bound of the sums behind the flipped node;
 9. one JSON line of every kernel's numbers (launches summed over the
    main-path runs: phase 4, the sweep and the routed trainings, each with
    the counts set to 0 just before it and read just after), the seconds
    of each phase, then the result line.

Exits non-zero without a result when CUDA is not available or the package
is missing. Imports no JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
ROOT_ROWS = 1_000_000
FEATURES = 28
TRAIN_PARAMS = {
    "objective": "binary", "metric": "auc", "max_bin": 255, "num_leaves": 255,
    "learning_rate": 0.1, "verbose": -1,
}


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def err_over_bound(got, want, abs_sum):
    """(largest cell of |got - want| over the f32 worst-case bound of two
    summation orders, count * 2^-23 * (sum of |values|); largest error).
    A histogram passes at a ratio of at most 1."""
    err = (got - want).abs()
    return float((err / (want[..., 2:] * 2.0 ** -23 * abs_sum + 1e-6)).max()), float(err.max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="", help="also write the results as JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.config import Config
    from helpers.bench_data import make_higgs_like
    from lightgbm_tpu_torch.obs import tune
    from lightgbm_tpu_torch.ops import cuda_build, hist_kernel, split_kernel
    from lightgbm_tpu_torch.ops.histogram import (
        leaf_histogram, leaf_histogram_packed4_rows, leaf_values,
    )
    from lightgbm_tpu_torch.ops.split import (
        MISSING_NAN, MISSING_ZERO, SplitParams, find_best_split_pair,
    )

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    phase_s = {}
    clock = [time.perf_counter()]

    def say(phase, **kw):
        now = time.perf_counter()
        phase_s[phase] = now - clock[0]
        clock[0] = now
        results[phase] = kw
        print(json.dumps({"phase": phase, **kw}), flush=True)

    # median device time between two CUDA events, the L2 flushed and the
    # host's launch overhead hidden behind a spin kernel (obs/tune.py)
    time_ms = tune.CudaTimer(dev)

    # ---- 1. device and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    print(card)
    t0 = time.perf_counter()
    build_s = cuda_build.build()
    ptxas = {name: cuda_build.ptxas_usage(cuda_build.library_path(name).with_suffix(".log").read_text())
             for name in cuda_build.SOURCES}
    assert all(ptxas.values()), ("ptxas reported no kernel", ptxas)
    # hist_onehot: one instance per (16-bin tile count, operand type)
    onehot_instances = sorted(k for k in ptxas["hist_onehot"] if k.startswith("onehot_kernel<"))
    assert len(onehot_instances) == 10, onehot_instances
    # hist_v1: one instance per (operand type, bin path), and the chunks' reduction
    hist_v1_ptxas = ptxas["hist_v1"]
    assert len([k for k in hist_v1_ptxas if k.startswith("v1_kernel<")]) == 4, hist_v1_ptxas
    assert all(u.get("spill_stores", 0) == u.get("spill_loads", 0) == 0
               for u in hist_v1_ptxas.values()), ("hist_v1 spills", hist_v1_ptxas)
    say("build", device=torch.cuda.get_device_name(0), nvidia_smi=card,
        seconds=round(time.perf_counter() - t0, 3), per_source=build_s, ptxas=ptxas,
        hist_v1=hist_v1_ptxas)

    # ---- data: the main path's dataset ---------------------------------------
    X, y = make_higgs_like(ROOT_ROWS, FEATURES)
    t0 = time.perf_counter()
    train_set = lgb.Dataset(X, label=y)
    cfg = Config.from_params(dict(TRAIN_PARAMS))
    binned = train_set.get_binned(cfg)
    bin_s = time.perf_counter() - t0
    N = binned.num_data
    F = binned.num_features
    B = binned.max_num_bin
    bins = torch.from_numpy(np.ascontiguousarray(binned.bins)).to(dev)
    bins_nf = bins.t().contiguous()
    hist_bins = bins_nf.t()  # the grower's layout: [F, N] view of the [N, F] copy
    rng = np.random.RandomState(0)
    dy_vals = leaf_values(
        torch.tensor(rng.randint(-64, 65, N) / 64.0, dtype=torch.float32, device=dev),
        torch.tensor(rng.randint(1, 65, N) / 64.0, dtype=torch.float32, device=dev),
        torch.ones(N, device=dev),
    )
    p0 = float(np.mean(y))
    score = np.log(p0 / (1 - p0))
    # real gradients: binary log-loss at the boost-from-average score
    resp = (-np.where(y > 0, 1.0, -1.0) / (1.0 + np.exp(np.where(y > 0, 1.0, -1.0) * score)))
    real_vals = leaf_values(
        torch.tensor(resp, dtype=torch.float32, device=dev),
        torch.tensor(np.abs(resp) * (1 - np.abs(resp)), dtype=torch.float32, device=dev),
        torch.ones(N, device=dev),
    )
    seg_rows = torch.from_numpy(
        np.sort(rng.permutation(N)[: N // 10]).astype(np.int32)
    ).to(dev)
    say("data", rows=N, features=F, num_bins=B, binning_s=round(bin_s, 3),
        segment_rows=int(seg_rows.numel()))

    # ---- 2. histogram kernel vs plain ------------------------------------------
    def hist_case(values, rows):
        got = hist_kernel.histogram(hist_bins, values, B, rows)
        want = leaf_histogram(bins, values, B, rows)
        return got, want

    got, want = hist_case(dy_vals, None)
    assert torch.equal(got, want), "histogram kernel != plain on dyadic root"
    got_s, want_s = hist_case(dy_vals, seg_rows)
    assert torch.equal(got_s, want_s), "histogram kernel != plain on dyadic segment"
    def check_real(rows):
        """Real values sum in other orders on the two sides: each cell must lie
        within the f32 worst-case bound of two summation orders,
        count * 2^-23 * (sum of |values|)."""
        got_r, want_r = hist_case(real_vals, rows)
        ratio, err = err_over_bound(got_r, want_r, leaf_histogram(bins, real_vals.abs(), B, rows))
        assert ratio <= 1.0, ("histogram kernel off on real values", err, ratio)
        return err, ratio, want_r

    hist_err, hist_ratio, want_r = check_real(None)
    seg_err, seg_ratio, _ = check_real(seg_rows)

    flat_idx = (bins.long() + torch.arange(F, device=dev)[:, None] * B).reshape(-1)
    flat_vals = real_vals.repeat(F, 1)
    lib_out = torch.zeros((F * B, 3), device=dev)

    def library_root():
        lib_out.zero_()
        lib_out.index_add_(0, flat_idx, flat_vals)

    library_root()
    lib_err = float((lib_out.view(F, B, 3) - want_r).abs().max())
    out_bytes = F * B * 12
    root_bound, root_by = bound(N * F + N * 12 + out_bytes, 3 * N * F)
    n_s = int(seg_rows.numel())
    seg_bound, seg_by = bound(n_s * F + n_s * 12 + n_s * 4 + out_bytes, 3 * n_s * F)
    hist_root = dict(
        ms=time_ms(lambda: hist_kernel.histogram(hist_bins, real_vals, B)),
        plain_ms=time_ms(lambda: leaf_histogram(bins, real_vals, B), reps=3),
        library_ms=time_ms(library_root),
        bound_ms=root_bound, bound_by=root_by,
    )
    hist_seg = dict(
        ms=time_ms(lambda: hist_kernel.histogram(hist_bins, real_vals, B, seg_rows)),
        plain_ms=time_ms(lambda: leaf_histogram(bins, real_vals, B, seg_rows), reps=3),
        bound_ms=seg_bound, bound_by=seg_by,
    )
    say("histogram", dyadic_exact=True, real_max_abs_err=hist_err,
        real_err_over_bound=hist_ratio, segment_max_abs_err=seg_err,
        segment_err_over_bound=seg_ratio, library_max_abs_err=lib_err,
        root=hist_root, segment=hist_seg)

    # ---- 2b. histogram at the sizes of one tree's calls ---------------------------
    q = 1024  # dyadic grid on which bf16 rounds and every per-bin sum stays exact in f32
    dyq_vals = leaf_values(
        torch.tensor(rng.randint(-q, q + 1, N) / q, dtype=torch.float32, device=dev),
        torch.tensor(rng.randint(1, 65, N) / q, dtype=torch.float32, device=dev),
        torch.ones(N, device=dev),
    )
    size_rng = np.random.RandomState(1)
    narrow = {Bn: (bins_nf % Bn).t() for Bn in (15, 63)}  # the grower's layout at narrower widths
    sms = hist_kernel._sm_count(dev)
    real_host = real_vals.cpu().numpy()
    sizes = {}
    for n in (256, 1024, 4096, 16384, 100_000, N):
        rows = None if n == N else torch.from_numpy(
            np.sort(size_rng.permutation(N)[:n]).astype(np.int32)).to(dev)
        size_bound, _ = bound(n * F + n * 12 + (0 if rows is None else n * 4) + out_bytes, 3 * n * F)
        rec = dict(grid=hist_kernel.histogram_grid(n, F, sms), v1_grid=hist_kernel.v1_grid(n, F, sms),
                   bound_ms=size_bound)
        for dt in ("float32", "bfloat16"):
            got = hist_kernel.histogram(hist_bins, dyq_vals, B, rows, dt)
            assert torch.equal(got, leaf_histogram(bins, dyq_vals, B, rows, dt)), (n, dt)
            assert torch.equal(hist_kernel.hist_v1(hist_bins, dyq_vals, B, rows, dt), got), (n, dt)
            # hist_v1's order is fixed: its mirror's bits on real values, the
            # same bits on every call at the root
            v1_real = hist_kernel.hist_v1(hist_bins, real_vals, B, rows, dt)
            if rows is None:
                for _ in range(4):
                    assert torch.equal(hist_kernel.hist_v1(hist_bins, real_vals, B, None, dt),
                                       v1_real), ("hist_v1 changed between calls", dt)
            else:
                assert np.array_equal(v1_real.cpu().numpy(), hist_kernel.hist_v1_mirror(
                    binned.bins, real_host, B, rows.cpu().numpy(), dt, sms)), (
                    "hist_v1 != its mirror", n, dt)
            for Bn, bins_n in narrow.items():
                assert torch.equal(hist_kernel.histogram(bins_n, dyq_vals, Bn, rows, dt),
                                   leaf_histogram(bins_n, dyq_vals, Bn, rows, dt)), (n, Bn, dt)
            rec[dt] = dict(
                ms=time_ms(lambda: hist_kernel.histogram(hist_bins, real_vals, B, rows, dt)),
                hist_v1_ms=time_ms(lambda: hist_kernel.hist_v1(hist_bins, real_vals, B, rows, dt)),
            )
        sizes["root" if rows is None else n] = rec
    del narrow
    say("histogram_sizes", num_bins=B, dyadic_exact_at_num_bins=[15, 63, B],
        hist_v1_real_equals_mirror_up_to=100_000, hist_v1_root_repeats_equal=5, sizes=sizes)

    # ---- 3. split kernel vs plain -----------------------------------------------
    hist2 = torch.stack([got_s, got - got_s]).contiguous()  # both children
    sums = hist2[:, 0].sum(dim=1).contiguous()
    cons = torch.tensor([[-np.inf, np.inf], [-np.inf, 0.5]], dtype=torch.float32, device=dev)
    meta_np = binned.feature_meta_arrays()
    meta = {
        "num_bin": torch.as_tensor(meta_np["num_bin"].astype(np.int32), device=dev),
        "missing_type": torch.arange(F, dtype=torch.int32, device=dev) % 3,
        "default_bin": torch.as_tensor(meta_np["default_bin"].astype(np.int32), device=dev),
        "monotone": torch.zeros(F, dtype=torch.int32, device=dev),
    }
    meta["monotone"][3] = 1
    fmask = torch.ones(F, dtype=torch.bool, device=dev)
    # the same children read by leaf index out of a grower-like buffer
    leaf_buf = torch.zeros((8, F, B, 3), dtype=torch.float32, device=dev)
    leaf_buf[5], leaf_buf[2] = hist2[0], hist2[1]
    # real-valued children: the same fold order and rounded ops, so bit for bit too
    seg_r = leaf_histogram(bins, real_vals, B, seg_rows)
    hist2_r = torch.stack([seg_r, want_r - seg_r]).contiguous()
    sums_r = hist2_r[:, 0].sum(dim=1).contiguous()
    # 300 features of synthetic dyadic histograms: many blocks race for a child's ticket
    F_wide = 300
    gen = torch.Generator(device=dev).manual_seed(3)
    cnt = torch.randint(0, 40, (2, F_wide, B), generator=gen, device=dev).float()
    grad_w = torch.randint(-64, 65, (2, F_wide, B), generator=gen, device=dev) / 64.0
    hist_w = torch.stack([grad_w * cnt.clamp(min=1), cnt * 0.25, cnt], -1).contiguous()
    meta_w = {
        "num_bin": torch.full((F_wide,), B, dtype=torch.int32, device=dev),
        "missing_type": torch.arange(F_wide, dtype=torch.int32, device=dev) % 3,
        "default_bin": torch.arange(F_wide, dtype=torch.int32, device=dev) % 3,
        "monotone": torch.zeros(F_wide, dtype=torch.int32, device=dev),
    }
    cases = {
        "dyadic": (hist2, sums, cons, meta, fmask, None),
        "dyadic_by_leaf": (leaf_buf, sums, cons, meta, fmask, (5, 2)),
        "real": (hist2_r, sums_r, cons, meta, fmask, None),
        "wide_dyadic": (hist_w, hist_w[:, 0].sum(dim=1).contiguous(), cons, meta_w,
                        torch.ones(F_wide, dtype=torch.bool, device=dev), None),
    }
    split_fields = dict.fromkeys(cases, 0)
    for pr in ((0.0, 0.0, 0.0, 20, 1e-3, 0.0), (0.5, 1.0, 0.3, 5, 0.5, 0.1)):
        params = SplitParams(*pr)
        for two_way in (True, False):
            for case, (h, s, cn, mt, fm, leaves) in cases.items():
                kf, ki = split_kernel.find_best_split_pair(h, s, cn, mt, fm, params, two_way, leaves)
                pf, pi = find_best_split_pair(h, s, cn, mt, fm, params, two_way, leaves)
                same_f = (kf == pf) | (torch.isnan(kf) & torch.isnan(pf))
                assert bool(same_f.all()) and torch.equal(ki, pi), (
                    "split kernel != plain", case, pr, two_way, kf, pf, ki, pi)
                split_fields[case] += kf.numel() + ki.numel()
    del leaf_buf, hist_w
    params = SplitParams(0.0, 0.0, 0.0, 20, 1e-3, 0.0)
    split_bound, split_by = bound(hist2.numel() * 4 + 2 * 21 * 4 + F * 17, 2 * F * B * 60)
    split_t = dict(
        ms=time_ms(lambda: split_kernel.find_best_split_pair(hist2, sums, cons, meta, fmask, params)),
        plain_ms=time_ms(lambda: find_best_split_pair(hist2, sums, cons, meta, fmask, params), reps=3),
        bound_ms=split_bound, bound_by=split_by, library_ms=None,
    )
    say("split", exact=True, fields_compared=split_fields, **split_t)

    # ---- 4. the main path ----------------------------------------------------------
    main_launches = {}  # summed over the main-path runs: phase 4, sweep, routed training

    def counted(fn):
        """Run ``fn`` with every launch count set to 0 just before and read
        just after; add the counts to the main path's."""
        hist_kernel.reset_launches()
        split_kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {k: v for k, v in hist_kernel.launches.items() if v}
        if split_kernel.launches:
            got["split_pair"] = split_kernel.launches
        for k, v in got.items():
            main_launches[k] = main_launches.get(k, 0) + v
        return out, secs, got

    booster, train_s, launches = counted(lambda: lgb.train(dict(TRAIN_PARAMS), train_set, 10))
    assert launches.get("histogram", 0) > 0 and launches.get("split_pair", 0) > 0, launches
    (_, metric, auc, _), = booster.eval_train()
    raw = booster.predict(X[:1000], raw_score=True)
    assert booster.num_trees() == 10 and np.all(np.isfinite(raw)) and raw.shape == (1000,)
    np.testing.assert_allclose(raw, booster._gbdt.train_score()[:1000], rtol=1e-5, atol=1e-5)
    assert auc > 0.7, auc
    leaves = [t.num_leaves for t in booster._gbdt.trees()]
    say("train", rows=N, iterations=10, seconds=round(train_s, 3),
        iterations_per_s=10 / train_s, auc=auc, launches=launches, leaves=leaves)

    # one more iteration under the profiler: device busy time by kernel
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        booster.update()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host ops carry their kernels' time too; count kernels once
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            by_kernel[ev.key[:60]] = [round(us / 1e3, 3), ev.count]
    busy_ms = sum(v[0] for v in by_kernel.values())
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8])
    # the split scan's kernels and any indexing copy (a hist[idx] gather),
    # whatever their rank
    split_and_copy = {k: v for k, v in by_kernel.items()
                      if "split" in k.lower() or "index_elementwise" in k or "gpu_index" in k}
    # the profiler's host-side tracing slows the profiled iteration many
    # times over, so the idle share is taken against phase 4's unprofiled
    # iteration time
    iter_ms = train_s / 10 * 1e3
    say("profile", profiled_iteration_wall_ms=wall_ms, unprofiled_iteration_ms=iter_ms,
        device_busy_ms=busy_ms,
        device_idle_share=(1 - busy_ms / iter_ms) if busy_ms else "not measured",
        top_device_ms_and_calls=top, split_and_copy_ms_and_calls=split_and_copy)

    def hold_calls():
        """Hold every call of each histogram kernel wrapper to its plain
        version on the same rows within the two-order bound, until the returned
        ``release()`` (which returns the counts and the worst ratio): every
        tree, those after a flip included."""
        plains = dict(histogram=leaf_histogram, hist_onehot=leaf_histogram,
                      hist_bitplane=leaf_histogram, hist_packed4_rows=leaf_histogram_packed4_rows)
        orig = {n: getattr(hist_kernel, n) for n in plains}
        held = dict(checked=dict.fromkeys(orig, 0), worst_err_over_bound=0.0)

        def check(name, got, plain, values):
            ratio, err = err_over_bound(got, plain(values), plain(values.abs()))
            assert ratio <= 1.0, ("routed call off its plain version", name, held["checked"][name], err, ratio)
            held["checked"][name] += 1
            held["worst_err_over_bound"] = max(held["worst_err_over_bound"], ratio)

        def rows_call(name):
            def call(bins_, values, num_bins, rows=None, hist_dtype="float32"):
                got = orig[name](bins_, values, num_bins, rows, hist_dtype)
                check(name, got, lambda v: plains[name](bins_, v, num_bins, rows, hist_dtype), values)
                return got
            return call

        # the packed form (pack4's input) goes through hist_packed4_rows too
        for name in plains:
            setattr(hist_kernel, name, rows_call(name))

        def release():
            for name, fn in orig.items():
                setattr(hist_kernel, name, fn)
            return held
        return release

    # ---- 5. cross-check: CUDA vs the plain versions on the CPU ------------------
    Xs, ys = X[:100_000], y[:100_000]
    release = hold_calls()  # every histogram call of the CUDA run held to its plain version
    on_gpu = lgb.train(dict(TRAIN_PARAMS), lgb.Dataset(Xs, label=ys), 3, device="cuda")
    held5 = release()
    assert held5["checked"]["histogram"] > 0, held5
    on_cpu = lgb.train(dict(TRAIN_PARAMS), lgb.Dataset(Xs, label=ys), 3, device="cpu")

    def same_trees(base, other, rtol=1e-5):
        """Trees equal in order up to the first f32 near-tie flip, whose
        gains must agree to ``rtol`` (None: the caller holds them); returns
        (identical trees, flips, (tree, node) of the flip or None)."""
        flips = 0
        agree = 0
        where = None
        for a, b in zip(base._gbdt.trees(), other._gbdt.trees()):
            diff = np.nonzero(
                (a.split_feature != b.split_feature) | (a.threshold_bin != b.threshold_bin)
            )[0] if a.num_leaves == b.num_leaves else np.array([0])
            if len(diff):
                k = int(diff[0])
                if rtol is not None:
                    np.testing.assert_allclose(b.split_gain[k], a.split_gain[k], rtol=rtol,
                                               err_msg="tree %d node %d" % (agree, k))
                flips += 1
                where = (agree, k)
                break
            agree += 1
        assert agree >= 1 or flips == 1, "the trees differ beyond a near-tie"
        return agree, flips, where

    def exact_gains(bst, t, gh):
        """f64 gain of every split of tree t of ``bst``,
        G_L^2 / (H_L + l2) + G_R^2 / (H_R + l2) - G^2 / (H + l2), from the
        sums of ``gh`` ([n, 2] f64 gradients and hessians) over the rows each
        node splits."""
        g0 = bst._gbdt
        fb = g0.bins_dev.to(dev)
        meta = {kk: v.cpu().tolist() for kk, v in g0.feature_meta.items()}
        lam = g0.config.lambda_l2
        ta = g0._tree_arrays[t]
        lc, rc = ta.left_child.tolist(), ta.right_child.tolist()
        reach = {0: torch.ones(fb.shape[1], dtype=torch.bool, device=dev)}
        gains = []
        for i in range(int(ta.num_leaves) - 1):
            f, thr = int(ta.split_feature[i]), int(ta.threshold_bin[i])
            col = fb[f].long()
            left = col <= thr
            if meta["missing_type"][f] == MISSING_ZERO:
                left[col == meta["default_bin"][f]] = bool(ta.default_left[i])
            elif meta["missing_type"][f] == MISSING_NAN:
                left[col == meta["num_bin"][f] - 1] = bool(ta.default_left[i])
            sides = reach[i] & left, reach[i] & ~left
            (g_l, h_l), (g_r, h_r) = (gh[s].sum(0).tolist() for s in sides)
            gains.append(g_l * g_l / (h_l + lam) + g_r * g_r / (h_r + lam)
                         - (g_l + g_r) ** 2 / (h_l + h_r + lam))
            for child, s in zip((lc[i], rc[i]), sides):
                if child > 0:
                    reach[child] = s
        return gains

    # Each side's f32 gains against the f64 gains of its own splits, over
    # the nodes the trees share and the flipped node, from the plain run's
    # log-loss gradients (the runs' scores differ only in the last bits of
    # the leaf values). The kernel's sums must be no further from exact than
    # the plain version's sequential f32 sums. At a flip, the two splits are
    # a near tie in f32; the CUDA run's split must be no worse in exact
    # arithmetic than the plain version's, to rtol 1e-5.
    agree, flips, where = same_trees(on_cpu, on_gpu, rtol=None)
    labels5 = torch.as_tensor(ys, dtype=torch.float64, device=dev)
    p5 = float(np.mean(ys))
    gain_err, at_flip = {}, {}
    for t in range(where[0] + 1 if where else 3):
        s = (torch.as_tensor(on_cpu.predict(Xs, num_iteration=t, raw_score=True), device=dev) if t
             else torch.full((len(ys),), float(np.float32(np.log(p5 / (1 - p5)))),
                             dtype=torch.float64, device=dev))  # boost from average
        p = torch.sigmoid(s)
        gh = torch.stack([p - labels5, p * (1 - p)], 1)
        for name, b in (("cuda", on_gpu), ("cpu_plain", on_cpu)):
            exact = exact_gains(b, t, gh)
            upto = where[1] + 1 if where and t == where[0] else len(exact)
            assert upto <= len(exact), ("no node at the flip", name, where)
            got = b._gbdt._tree_arrays[t].split_gain[:upto].tolist()
            errs = [abs(a - e) for a, e in zip(got, exact[:upto])]
            gain_err[name] = max([gain_err.get(name, 0.0)] + errs)
            if upto and where and t == where[0]:
                at_flip[name] = dict(gain=got[-1], exact_gain=exact[upto - 1])
    assert gain_err["cuda"] <= gain_err["cpu_plain"], ("gains further from exact", gain_err)
    if where is not None:
        ex_cuda, ex_cpu = at_flip["cuda"]["exact_gain"], at_flip["cpu_plain"]["exact_gain"]
        assert ex_cuda >= ex_cpu - 1e-5 * abs(ex_cpu), ("flip to a worse split", where, at_flip)
    ra = on_cpu.predict(Xs, raw_score=True)  # all 3 trees, a flip included
    rb = on_gpu.predict(Xs, raw_score=True)
    np.testing.assert_allclose(rb, ra, rtol=1e-4, atol=1e-4)
    worst = float(np.abs(ra - rb).max())
    # mean |error| of the g and h channels of the 100k-row root histogram
    # (real gradients) against an f64 sum: the kernel and the plain version
    fb5, nb5 = on_gpu._gbdt.bins_dev, on_gpu._gbdt.num_bins
    vals5 = real_vals[: fb5.shape[1]].contiguous()
    flat5 = (fb5.long() + torch.arange(F, device=dev)[:, None] * nb5).reshape(-1)
    exact5 = torch.zeros((F * nb5, 3), dtype=torch.float64, device=dev).index_add_(
        0, flat5, vals5.double().repeat(F, 1)).view(F, nb5, 3)

    def err_f64(h):
        return [float(v) for v in (h.double().to(dev) - exact5)[..., :2].abs().mean((0, 1))]

    root_err = dict(cuda=err_f64(hist_kernel.histogram(fb5, vals5, nb5)),
                    cpu_plain=err_f64(leaf_histogram(fb5.cpu(), vals5.cpu(), nb5)))
    say("cross_check", rows=100_000, iterations=3, trees_identical=agree,
        near_tie_flips=flips, flip_at=where, flip=at_flip, max_gain_err_vs_f64=gain_err,
        worst_raw_score_diff=worst, held_calls=held5, root_err_vs_f64=root_err)

    # ---- 6. the histogram kernel family --------------------------------------------
    n_s = int(seg_rows.numel())
    seg_long = seg_rows.long()
    seg_host = seg_rows.cpu().numpy()
    family = {}  # (kernel, dtype) -> {B: numbers}
    checked = 0
    for Bf in (15, 63, 255):
        gen = torch.Generator(device=dev).manual_seed(Bf)
        syn_nf = torch.randint(0, Bf, (N, F), generator=gen, device=dev, dtype=torch.uint8)
        syn = syn_nf.t()  # the grower's layout: [F, N] view of the [N, F] copy
        syn_host = syn_nf.cpu().numpy().T  # for hist_v1's mirror
        # the nibble-packed [N2, F] copy the grower makes at set-up when B <= 16
        syn_p4 = hist_kernel.pack_bins(syn_nf).t() if Bf <= 16 else None
        out_b = F * Bf * 12
        root_b = bound(N * F + N * 12 + out_b, 3 * N * F)
        seg_b = bound(n_s * F + n_s * 12 + n_s * 4 + out_b, 3 * n_s * F)
        # packed: each packed byte once (at the segment, the pairs its rows touch)
        packed_b = bound((N + 1) // 2 * F + N * 12 + out_b, 3 * N * F)
        seg_pairs = int(torch.unique(seg_rows >> 1).numel())
        packed_seg_b = bound(seg_pairs * F + n_s * 12 + n_s * 4 + out_b, 3 * n_s * F)
        flat = (syn.long() + torch.arange(F, device=dev)[:, None] * Bf).reshape(-1)
        lib_acc = torch.zeros((F * Bf, 3), device=dev)
        for dt in ("float32", "bfloat16"):
            real_op = real_vals.to(torch.bfloat16).float() if dt == "bfloat16" else real_vals
            lib_vals = real_op.repeat(F, 1)

            def library():
                lib_acc.zero_()
                lib_acc.index_add_(0, flat, lib_vals)

            library_ms = time_ms(library)
            plain = {}
            for rows in (None, seg_rows):
                key = "root" if rows is None else "segment"
                plain[key] = dict(
                    dyadic=leaf_histogram(syn, dyq_vals, Bf, rows, dt),
                    real=leaf_histogram(syn, real_vals, Bf, rows, dt),
                    abs_sum=leaf_histogram(syn, real_vals.abs(), Bf, rows, dt),
                    ms=time_ms(lambda r=rows: leaf_histogram(syn, real_vals, Bf, r, dt), reps=3),
                )
            for name, fn in (("histogram", hist_kernel.histogram), ("hist_v1", hist_kernel.hist_v1),
                             ("hist_onehot", hist_kernel.hist_onehot),
                             ("hist_bitplane", hist_kernel.hist_bitplane),
                             ("hist_packed4", hist_kernel.hist_packed4_rows)):
                if name in ("hist_onehot", "hist_bitplane") and not 2 <= Bf <= 256:
                    continue
                if name == "hist_packed4" and Bf > 16:
                    continue
                rec = {}
                bins_in = syn_p4 if name == "hist_packed4" else syn
                for rows in (None, seg_rows):
                    key = "root" if rows is None else "segment"

                    def run(v, r=rows, fn=fn, b=bins_in):
                        return fn(b, v, Bf, r, dt)
                    want = plain[key]
                    got = run(dyq_vals)
                    assert torch.equal(got, want["dyadic"]), (name, Bf, dt, key, "dyadic")
                    ratio, err = err_over_bound(run(real_vals), want["real"], want["abs_sum"])
                    assert ratio <= 1.0, (name, Bf, dt, key, err, ratio)
                    rec[key + "_max_abs_err"] = err
                    rec[key + "_err_over_bound"] = ratio
                    rec[key + "_ms"] = time_ms(lambda: run(real_vals))
                    rec[key + "_plain_ms"] = want["ms"]
                    checked += 2
                if name == "hist_packed4":
                    # its own plain version on the set-up copy, and the root on
                    # pack4's [F, N2] input (the JAX kernel's own contract)
                    for rows in (None, seg_rows):
                        key = "root" if rows is None else "segment"
                        rec[key + "_plain_ms"] = time_ms(
                            lambda r=rows: leaf_histogram_packed4_rows(syn_p4, real_vals, Bf, r, dt),
                            reps=3)
                    bp, vp = hist_kernel.pack4(syn, dyq_vals)
                    assert torch.equal(hist_kernel.hist_packed4(bp, vp, Bf, dt),
                                       plain["root"]["dyadic"]), (Bf, dt, "pack4 input")
                    bp, vp = hist_kernel.pack4(syn, real_vals)
                    rec["root_packed_input_ms"] = time_ms(lambda: hist_kernel.hist_packed4(bp, vp, Bf, dt))
                    checked += 1
                if name == "hist_v1":  # the oracle of the default kernel
                    for rows in (None, seg_rows):
                        assert torch.equal(
                            hist_kernel.hist_v1(syn, dyq_vals, Bf, rows, dt),
                            hist_kernel.histogram(syn, dyq_vals, Bf, rows, dt),
                        ), ("hist_v1 != histogram", Bf, dt)
                    # fixed order: the mirror's bits on real values at the
                    # segment, the same bits on every call at the root
                    assert np.array_equal(
                        hist_kernel.hist_v1(syn, real_vals, Bf, seg_rows, dt).cpu().numpy(),
                        hist_kernel.hist_v1_mirror(syn_host, real_host, Bf, seg_host, dt, sms),
                    ), ("hist_v1 != its mirror", Bf, dt)
                    first = hist_kernel.hist_v1(syn, real_vals, Bf, None, dt)
                    for _ in range(4):
                        assert torch.equal(hist_kernel.hist_v1(syn, real_vals, Bf, None, dt),
                                           first), ("hist_v1 changed between calls", Bf, dt)
                    checked += 2
                rb, sb = (packed_b, packed_seg_b) if name == "hist_packed4" else (root_b, seg_b)
                rec.update(root_bound_ms=rb[0], segment_bound_ms=sb[0], bound_by=rb[1],
                           library_ms=library_ms)
                family.setdefault((name, dt), {})[Bf] = rec
        del syn_nf, syn, syn_host, syn_p4, flat, lib_acc
    say("kernel_family", rows=N, features=F, segment_rows=n_s, dyadic_exact=True,
        checks=checked, numbers={"%s/%s" % k: v for k, v in family.items()})
    print(json.dumps({"hist_onehot_root_ms": {
        dt: {Bf: family[("hist_onehot", dt)][Bf]["root_ms"] for Bf in (15, 63, 255)}
        for dt in ("float32", "bfloat16")}}), flush=True)

    # ---- 7. the tune sweep -------------------------------------------------------------
    datasets = {255: train_set}
    for mb in (15, 63):
        datasets[mb] = lgb.Dataset(X, label=y)
        datasets[mb].construct(Config.from_params(dict(TRAIN_PARAMS, max_bin=mb)))
    widths = {mb: ds.get_binned(cfg).max_num_bin for mb, ds in datasets.items()}
    assert widths[15] <= 16, widths  # else cuda_packed4 never routes
    tmp = tempfile.TemporaryDirectory(prefix="lgbt-tune-")
    table_path = os.path.join(tmp.name, "tune.json")
    argv = ["--out", table_path, "--rows", str(ROOT_ROWS), "--features", str(FEATURES),
            "--bins", ",".join(str(widths[mb]) for mb in (15, 63, 255)),
            "--dtypes", "float32,bfloat16"]
    rc, sweep_s, sweep_launches = counted(lambda: tune.main(argv))
    assert rc == 0
    table = tune.load_table(table_path)
    hand_kernels = set(hist_kernel.KERNEL_CAPS)
    winners = {"B=%d,%s,rows=%d" % (e["B"], e["hist_dtype"], e["rows_bucket"]): e["impl"]
               for e in table["entries"]}
    assert winners and set(winners.values()) <= hand_kernels, winners
    wins = {}
    for impl in winners.values():
        wins[impl] = wins.get(impl, 0) + 1
    say("sweep", argv=argv, seconds=sweep_s, widths=widths, entries=len(table["entries"]),
        device_family=table["device_family"], digest=table["digest"], wins=wins,
        winners=winners, launches=sweep_launches,
        times_ms=[{"B": e["B"], "dt": e["hist_dtype"], "rows": e["rows_bucket"], **e["times_ms"],
                   **e["baseline_ms"]} for e in table["entries"]])

    # ---- 8. routed training --------------------------------------------------------------
    classes = sorted({hist_kernel.rows_bucket(s) for s in hist_kernel.bucket_sizes(N)})

    def hand_table(mb, dt):
        """Alternate row classes to cuda_onehot / cuda_bitplane (/ cuda_packed4)."""
        B_mb = widths[mb]
        kinds = ["cuda_onehot", "cuda_bitplane"] + (["cuda_packed4"] if B_mb <= 16 else [])
        ents = [{"B": B_mb, "K": 3, "hist_dtype": dt, "rows_bucket": r, "impl": kinds[i % len(kinds)]}
                for i, r in enumerate(classes)]
        path = os.path.join(tmp.name, "hand-%d-%s.json" % (mb, dt))
        tune.save_table(tune.build_table(ents, device_kind=torch.cuda.get_device_name(0)), path)
        return path

    def train_at(mb, dt, tune_path):
        params = dict(TRAIN_PARAMS, max_bin=mb, tpu_hist_dtype=dt, hist_tune=tune_path)
        return lgb.train(params, datasets[mb], 10)

    U = 2.0 ** -24  # f32 unit roundoff
    labels = torch.as_tensor(y, dtype=torch.float64, device=dev)

    def flip_bound(base, other, t, k):
        """(gap, bound, detail) at the first node where two f32 runs differ,
        node k of tree t. Each run takes the best split of its own f32 sums,
        so the gap between the two runs' gains there is at most
        2 max(err_base, err_other), where err bounds the f32 error of a
        run's gain at node k against exact sums. The split leaf's histogram
        is that of its nearest directly built ancestor D less the smaller
        siblings between them, so a cell is off by at most
        (2 count_D + depth + B + 4) u sum_D |v| (sums, subtractions, the
        scan's prefix); the leaf's totals also carry every ancestor's
        histogram error. Both runs start tree 0 from the same scores and
        share its root sums; after tree 0 the gradients drift by the leaf
        values' last bits, so the bound adds the measured drift and the
        root sums' worst-case error, which at 1M rows admits a wide gap:
        there the per-call checks of ``hold_calls`` hold the kernels. At
        deep nodes of 1M-row trees a side's hessian sum can lie within its
        worst-case error, and the bound is then infinite."""
        g0 = base._gbdt
        fb = g0.bins_dev  # [F, N] u8, the same binned data in both runs
        nb = g0.num_bins
        lam = g0.config.lambda_l2
        meta = {kk: v.cpu().tolist() for kk, v in g0.feature_meta.items()}
        feat_off = torch.arange(F, device=dev)[:, None] * nb

        def grad_hess(bst):
            if t == 0:
                s = torch.full((N,), float(np.float32(score)), dtype=torch.float64, device=dev)
            else:
                s = torch.as_tensor(bst.predict(X, num_iteration=t, raw_score=True), device=dev)
            p = torch.sigmoid(s)
            return torch.stack([p - labels, p * (1 - p)], 1), s

        gh, s = grad_hess(base)
        absv = torch.cat([gh.abs(), torch.ones((N, 1), dtype=torch.float64, device=dev)], 1)
        drift = torch.zeros(2, dtype=torch.float64, device=dev)
        root = drift.clone()
        if t:
            gh_o, s_o = grad_hess(other)
            # training scores are f32: t rounded adds per run, gradients 1/4-Lipschitz
            slack = N * t * U * float(torch.maximum(s.abs().max(), s_o.abs().max())) / 2
            drift = (gh_o - gh).abs().sum(0) + slack
            root = 2 * N * U * absv[:, :2].sum(0) + drift

        def decide(f, thr, dl):
            col = fb[f].long()
            left = col <= thr
            if meta["missing_type"][f] == MISSING_ZERO:
                left[col == meta["default_bin"][f]] = dl
            elif meta["missing_type"][f] == MISSING_NAN:
                left[col == meta["num_bin"][f] - 1] = dl
            return left

        def abs_hist(rows):  # [F, B, 3] f64 sums of |g|, |h| and counts over rows
            out = torch.zeros((F * nb, 3), dtype=torch.float64, device=dev)
            out.index_add_(0, (fb[:, rows].long() + feat_off).reshape(-1), absv[rows].repeat(F, 1))
            return out.view(F, nb, 3)

        def split_error(ta):
            """(reported gain, error bound) of node k of one run's tree;
            (0, 0) where the tree has no node k (its best gain was <= 0)."""
            if k >= int(ta.num_leaves) - 1:
                return 0.0, 0.0
            lc, rc = ta.left_child.tolist(), ta.right_child.tolist()
            parent = {c: (i, c == lc[i]) for i in range(k) for c in (lc[i], rc[i]) if c > 0}
            path, node = [], k
            while node in parent:
                node, went_left = parent[node]
                path.append((node, went_left))
            rows = torch.ones(N, dtype=torch.bool, device=dev)
            a_d = abs_hist(rows)

            def hist_err(depth):
                w = (2 * a_d[..., 2:] + depth + nb + 4) * U
                return (w * a_d[..., :2]).sum(1).max(0).values + drift

            e_sum, e_hist = root, hist_err(0)
            for depth, (p, went_left) in enumerate(reversed(path), 1):
                e_sum = e_sum + e_hist  # the child's totals: its parent's split record
                gl = decide(int(ta.split_feature[p]), int(ta.threshold_bin[p]), bool(ta.default_left[p]))
                n_l, n_r = int((rows & gl).sum()), int((rows & ~gl).sum())
                rows = rows & (gl if went_left else ~gl)
                if (n_l <= n_r) == went_left:  # the smaller child: built from its own rows
                    a_d = abs_hist(rows)
                e_hist = hist_err(depth)
            gl = decide(int(ta.split_feature[k]), int(ta.threshold_bin[k]), bool(ta.default_left[k]))
            sides = [gh[rows & gl].sum(0), gh[rows & ~gl].sum(0)]
            sides.append(sides[0] + sides[1])
            eg, eh = (float(v) for v in e_sum + e_hist)
            err, terms = 0.0, 0.0
            for G, H in sides:  # left, right, parent: G^2 / (H + lambda_l2) each
                G, H = abs(float(G)), float(H) + lam
                if H - eh <= 0:
                    return float(ta.split_gain[k]), float("inf")
                term = G * G / H
                terms += term
                err += max((G + eg) ** 2 / (H - eh) - term, term - max(G - eg, 0.0) ** 2 / (H + eh))
            return float(ta.split_gain[k]), err + 8 * U * terms

        (gain_a, err_a), (gain_b, err_b) = (split_error(b._gbdt._tree_arrays[t]) for b in (base, other))
        return abs(gain_a - gain_b), 2 * max(err_a, err_b), dict(
            gains=[gain_a, gain_b], gain_error_bounds=[err_a, err_b], after_tree_0=bool(t))

    defaults = {}
    default_ips = {}
    for mb in (15, 63):  # the default route at the same widths, the f32 runs' yardstick
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        defaults[mb] = train_at(mb, "float32", "off")
        torch.cuda.synchronize()
        default_ips[mb] = 10 / (time.perf_counter() - t0)
    runs = [("table", 15, "float32", table_path), ("table", 63, "bfloat16", table_path),
            ("table", 255, "bfloat16", table_path), ("hand", 63, "float32", hand_table(63, "float32")),
            ("hand", 15, "float32", hand_table(15, "float32"))]
    routed = []
    routed_launches = {}
    for kind, mb, dt, path in runs:
        timed, secs, got = counted(lambda: train_at(mb, dt, path))
        release = hold_calls()  # the same training again, every kernel call held
        bst = train_at(mb, dt, path)
        held = release()
        aucs = []
        for b in (timed, bst):
            assert b._gbdt.hist_route is not None and b.num_trees() == 10, (kind, mb, dt)
            (_, _, auc_b, _), = b.eval_train()
            assert auc_b > 0.7 and np.all(np.isfinite(b.predict(X[:1000], raw_score=True))), (
                kind, mb, dt, auc_b)
            aucs.append(auc_b)
        auc_r = aucs[1]
        rec = dict(kind=kind, max_bin=mb, num_bins=widths[mb], hist_dtype=dt, seconds=secs,
                   iterations_per_s=10 / secs, auc=aucs[0], held_run_auc=auc_r, launches=got,
                   held_calls=held, route_digest=bst._gbdt.hist_route.digest)
        if dt == "float32" and mb in defaults:
            # phase 5's rule, the flipped node's gain held to the f32 error
            # bound of the sums behind it (flip_bound); the models must
            # still score alike
            agree_r, flips_r, where = same_trees(defaults[mb], bst, rtol=None)
            if where is not None:
                gap, tol, detail = flip_bound(defaults[mb], bst, *where)
                assert gap <= tol, ("flip beyond the f32 bound", kind, mb, where, gap, tol, detail)
                rec.update(flip_gap=gap, flip_bound=tol, flip=detail)
            (_, _, auc_d, _), = defaults[mb].eval_train()
            assert abs(auc_r - auc_d) <= 2e-3, (kind, mb, dt, auc_r, auc_d)
            rec.update(trees_identical=agree_r, near_tie_flips=flips_r, flip_at=where,
                       default_auc=auc_d, default_iterations_per_s=default_ips[mb])
        if got.get("hist_packed4", 0) + got.get("hist_packed4_bf16", 0):
            assert held["checked"]["hist_packed4_rows"] > 0, (kind, mb, dt, held)
        for k, v in got.items():
            routed_launches[k] = routed_launches.get(k, 0) + v
        routed.append(rec)
    for name in ("hist_onehot", "hist_bitplane", "hist_packed4"):
        assert routed_launches.get(name, 0) + routed_launches.get(name + "_bf16", 0) > 0, (
            name, routed_launches)
    tmp.cleanup()
    say("routed_training", rows=N, iterations=10, runs=routed, launches=routed_launches)

    # ---- 9. kernels line and result ---------------------------------------------
    sources = {
        "histogram": ("histogram.cu", "lightgbm_tpu/ops/hist_pallas.py:225"),
        "hist_onehot": ("hist_onehot.cu", "lightgbm_tpu/ops/hist_pallas.py:524"),
        "hist_bitplane": ("hist_bitplane.cu", "lightgbm_tpu/ops/hist_pallas.py:655"),
        "hist_packed4": ("hist_packed4.cu", "lightgbm_tpu/ops/hist_pallas.py:409"),
        "hist_v1": ("hist_v1.cu", "lightgbm_tpu/ops/hist_pallas.py:301"),
    }
    kernels = [
        dict(name="histogram", route="cuda", source="lightgbm_tpu_torch/csrc/histogram.cu",
             replaces=sources["histogram"][1], launches=main_launches.get("histogram", 0),
             max_abs_err=hist_err, **hist_root),
        dict(name="split_pair", route="cuda", source="lightgbm_tpu_torch/csrc/split_pair.cu",
             replaces="lightgbm_tpu/ops/split_pallas.py:221", launches=main_launches.get("split_pair", 0),
             max_abs_err=0.0, **split_t),
    ]
    for name, (src, rep) in sources.items():
        for dt in ("float32", "bfloat16"):
            if (name, dt) == ("histogram", "float32"):
                continue  # phase 2's entry above
            key = name + ("_bf16" if dt == "bfloat16" else "")
            r = family[(name, dt)][15 if name == "hist_packed4" else 255]
            kernels.append(dict(
                name=key, route="cuda", source="lightgbm_tpu_torch/csrc/" + src, replaces=rep,
                launches=main_launches.get(key, 0), max_abs_err=r["root_max_abs_err"],
                ms=r["root_ms"], plain_ms=r["root_plain_ms"], bound_ms=r["root_bound_ms"],
                bound_by=r["bound_by"], library_ms=r["library_ms"],
            ))
    unlaunched = [k["name"] for k in kernels if k["launches"] <= 0]
    assert not unlaunched, ("kernels the main path never launched", unlaunched, main_launches)
    print(json.dumps({"phase_seconds": phase_s, "total_s": sum(phase_s.values())}))
    print(json.dumps({"kernels": kernels}))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"results": results, "kernels": kernels, "phase_seconds": phase_s}, fh, indent=1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
