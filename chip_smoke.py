"""Drive the PyTorch port's training path on one NVIDIA GPU and check it.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--out results.json]

Phases (each prints one line; any failure exits non-zero):
 1. device and build: the card, its power limit, both kernels built from
    lightgbm_tpu_torch/csrc with nvcc at once;
 2. leaf-histogram kernel vs its plain PyTorch version at the root shape
    (1M rows x 28 features, B=255) and at a leaf segment given by ``rows``:
    exact on dyadic values, within the f32 bound of two summation orders on
    real gradients; times against the bound and one ``index_add_``;
 3. two-child split-scan kernel vs its plain version on both children of
    phase 2's histograms, with missing types none/zero/nan and a monotone
    feature: every field exact on dyadic input (NaN where both are NaN);
 4. the main path: ``lightgbm_tpu_torch.train`` on make_higgs_like(1M, 28),
    binary, max_bin=255, num_leaves=255, learning_rate=0.1, 10 iterations,
    with the kernels' launch counters set to 0 just before and read just
    after; iterations per second and the training AUC; then one more
    iteration under torch.profiler for the device busy time by kernel;
 5. the same configuration at 100k rows for 3 iterations on device="cuda"
    and device="cpu" (the plain versions): trees equal up to f32 near-tie
    flips, raw scores within rtol 1e-4 / atol 1e-4;
 6. one JSON line of every kernel's numbers, then the result line.

Exits non-zero without a result when CUDA is not available or the package
is missing. Imports no JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
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
    from lightgbm_tpu_torch.ops import cuda_build, hist_kernel, split_kernel
    from lightgbm_tpu_torch.ops.histogram import leaf_histogram, leaf_values
    from lightgbm_tpu_torch.ops.split import SplitParams, find_best_split_pair

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}

    def say(phase, **kw):
        results[phase] = kw
        print(json.dumps({"phase": phase, **kw}), flush=True)

    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2

    def time_ms(fn, reps=10):
        """Median device time of ``fn`` between two CUDA events. A spin kernel
        ahead of the start event keeps the card busy while the host enqueues
        ``fn``, so the host's launch overhead stays out of the time."""
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            flush_buf.zero_()  # inputs come from HBM, as in the grower
            torch.cuda._sleep(2_000_000)  # ~1 ms of spinning
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    # ---- 1. device and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    print(card)
    t0 = time.perf_counter()
    build_s = cuda_build.build()
    ptxas = {}
    for name in cuda_build.SOURCES:
        log_text = cuda_build.library_path(name).with_suffix(".log").read_text()
        ptxas[name] = [ln.strip() for ln in log_text.splitlines() if "registers" in ln]
    say("build", device=torch.cuda.get_device_name(0), nvidia_smi=card,
        seconds=round(time.perf_counter() - t0, 3), per_source=build_s, ptxas=ptxas)

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
        abs_sum = leaf_histogram(bins, real_vals.abs(), B, rows)
        err = (got_r - want_r).abs()
        ratio = float((err / (want_r[..., 2:] * 2.0 ** -23 * abs_sum + 1e-6)).max())
        assert ratio <= 1.0, ("histogram kernel off on real values", float(err.max()), ratio)
        return float(err.max()), ratio, want_r

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
    split_fields = 0
    for pr in ((0.0, 0.0, 0.0, 20, 1e-3, 0.0), (0.5, 1.0, 0.3, 5, 0.5, 0.1)):
        params = SplitParams(*pr)
        for two_way in (True, False):
            kf, ki = split_kernel.find_best_split_pair(hist2, sums, cons, meta, fmask, params, two_way)
            pf, pi = find_best_split_pair(hist2, sums, cons, meta, fmask, params, two_way)
            same_f = (kf == pf) | (torch.isnan(kf) & torch.isnan(pf))
            assert bool(same_f.all()) and torch.equal(ki, pi), (
                "split kernel != plain", pr, two_way, kf, pf, ki, pi)
            split_fields += kf.numel() + ki.numel()
    params = SplitParams(0.0, 0.0, 0.0, 20, 1e-3, 0.0)
    split_bound, split_by = bound(hist2.numel() * 4 + 2 * 21 * 4 + F * 17, 2 * F * B * 60)
    split_t = dict(
        ms=time_ms(lambda: split_kernel.find_best_split_pair(hist2, sums, cons, meta, fmask, params)),
        plain_ms=time_ms(lambda: find_best_split_pair(hist2, sums, cons, meta, fmask, params), reps=3),
        bound_ms=split_bound, bound_by=split_by, library_ms=None,
    )
    say("split", dyadic_exact=True, fields_compared=split_fields, feature=ki[:, 0].tolist(),
        **split_t)

    # ---- 4. the main path ----------------------------------------------------------
    hist_kernel.launches = 0
    split_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    booster = lgb.train(dict(TRAIN_PARAMS), train_set, 10)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {"histogram": hist_kernel.launches, "split_pair": split_kernel.launches}
    assert launches["histogram"] > 0 and launches["split_pair"] > 0, launches
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
    # the profiler's host-side tracing slows the profiled iteration many
    # times over, so the idle share is taken against phase 4's unprofiled
    # iteration time
    iter_ms = train_s / 10 * 1e3
    say("profile", profiled_iteration_wall_ms=wall_ms, unprofiled_iteration_ms=iter_ms,
        device_busy_ms=busy_ms,
        device_idle_share=(1 - busy_ms / iter_ms) if busy_ms else "not measured",
        top_device_ms_and_calls=top)

    # ---- 5. cross-check: CUDA vs the plain versions on the CPU ------------------
    Xs, ys = X[:100_000], y[:100_000]
    on_gpu = lgb.train(dict(TRAIN_PARAMS), lgb.Dataset(Xs, label=ys), 3, device="cuda")
    on_cpu = lgb.train(dict(TRAIN_PARAMS), lgb.Dataset(Xs, label=ys), 3, device="cpu")
    flips = 0
    agree = 0
    for a, b in zip(on_cpu._gbdt.trees(), on_gpu._gbdt.trees()):
        diff = np.nonzero(
            (a.split_feature != b.split_feature) | (a.threshold_bin != b.threshold_bin)
        )[0] if a.num_leaves == b.num_leaves else np.array([0])
        if len(diff):
            k = int(diff[0])
            np.testing.assert_allclose(b.split_gain[k], a.split_gain[k], rtol=1e-5)
            flips += 1
            break
        agree += 1
    worst = 0.0
    if agree:
        ra = on_cpu.predict(Xs, num_iteration=agree, raw_score=True)
        rb = on_gpu.predict(Xs, num_iteration=agree, raw_score=True)
        np.testing.assert_allclose(rb, ra, rtol=1e-4, atol=1e-4)
        worst = float(np.abs(ra - rb).max())
    assert agree >= 1 or flips == 1, "the trees differ beyond a near-tie"
    say("cross_check", rows=100_000, iterations=3, trees_identical=agree,
        near_tie_flips=flips, worst_raw_score_diff=worst)

    # ---- 6. kernels line and result ---------------------------------------------
    kernels = [
        dict(name="histogram", route="cuda", source="lightgbm_tpu_torch/csrc/histogram.cu",
             replaces="lightgbm_tpu/ops/hist_pallas.py:225", launches=launches["histogram"],
             max_abs_err=hist_err, **hist_root),
        dict(name="split_pair", route="cuda", source="lightgbm_tpu_torch/csrc/split_pair.cu",
             replaces="lightgbm_tpu/ops/split_pallas.py:221", launches=launches["split_pair"],
             max_abs_err=0.0, **split_t),
    ]
    print(json.dumps({"kernels": kernels}))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"results": results, "kernels": kernels}, fh, indent=1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
