"""Paired timing of one kernel of csrc/ against an older source of it, in
one process on one card.

On a machine with a CUDA card, from the repository root::

    git show <commit>:lightgbm_tpu_torch/csrc/<kernel>.cu > build/old_<kernel>.cu
    python -m lightgbm_tpu_torch.obs.pair --kernel {histogram,split_pair,packed4,v1} \\
        --old build/old_<kernel>.cu [--out results.json]

The old source is built with the package's nvcc flags into ``build/pair/``,
beside an empty kernel that the tool writes there; the new kernel runs
through its own wrapper. Prints both libraries' ptxas registers and spills
and their SASS opcode counts (``cuobjdump -sass``; with ``--out`` the whole
SASS of each lands beside the JSON as ``<out>.old.sass`` / ``.new.sass``),
checks both versions against the plain version, then times them in turns
(old, new, new, old) with the empty kernel's launch as the floor of one
call. A time is the mean of the two turns' CUDA-event medians
(``tune.CudaTimer``: L2 flushed, launch overhead hidden). Inputs of
``histogram``, ``v1`` and ``split_pair`` come from make_higgs_like(1M, 28)
binned at max_bin=255.

``histogram`` and ``v1`` (csrc/hist_v1.cu): the old source takes the
launcher arguments of the other ``[F, N]`` kernels (no ``rows_per_block``,
no scratch: commit 9f5ccd0 or earlier for ``v1``) and a zeroed output.
Both are held to the plain version bit for bit on dyadic values (multiples
of 2^-10) in f32 and bf16 at sorted random segments of 256, 1024, 4096,
16384 and 100k rows, in the grower's layout (``bins_nf.t()``), and the
whole root, and timed there on real values, the output's memset (old) or
allocation (new) included.

``split_pair``: the old source takes a contiguous ``[C, F, B, 3]`` and no
leaf indices or ticket counter (the launcher before the one-launch
design). Inputs: both children of the root's first split, and both
children of a deep split (following the larger child until it holds at most
8000 rows), each split the plain version's best on log-loss gradients at the
average score, with the data's feature meta, in both ``two_way`` settings.
The children sit at two rows of a grower-like ``[255, F, B, 3]`` buffer:
the new kernel reads them there by leaf index; the old one is timed on a
contiguous copy made once (``old``) and with the grower's former
``hist[idx]`` copy ahead of each call (``old_copy``). Old and new are held
to the plain version field for field (NaNs matched) on dyadic and on real
histograms; the new one must equal the old one, and where the old one
differs from the plain version the fields are printed.

``packed4`` (csrc/hist_packed4.cu; ``--kernel`` names the source
``hist_packed4.cu``): the old source takes pack4's packed input
(``[F, N2]`` bins, ``[N2, 6]`` values, no rows, no grid argument: the entry
before the per-thread design). Inputs: synthetic uniform bins at B = 15,
1M x 28, as chip_smoke.py's phase 6 makes them, with normal gradients and
uniform hessians. Timed: the root on pack4 input (old kernel against new);
the root as the grower pays it (old pack4 + kernel against the new kernel
on the set-up copy of ``pack_bins``); sorted random segments of 100k, 16384,
4096, 1024 and 256 rows as the grower pays them (old gather + pack4 +
kernel against the new one by rows). Old and new are held to each other and
to the plain version bit for bit on dyadic values (multiples of 2^-10) at
every input, in f32 and bf16.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, Tuple

from ..ops import cuda_build

SIZES = (256, 1024, 4096, 16384, 100_000)
EMPTY_SRC = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int lgbt_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""
# lgbt_split_pair before the one-launch design: hist, sums, cons, 4 meta,
# fmask, feat_f, feat_i, outf, outi; C, F, B; 6 params; two_way, stream
_OLD_SPLIT_ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [ctypes.c_float] * 6 + [
    ctypes.c_int, ctypes.c_void_p,
]


def sass_text(library: Path) -> str:
    cuobjdump = Path(cuda_build.nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout


def sass_counts(text: str) -> Dict[str, Dict[str, int]]:
    """Opcode counts (memory, atomics, shuffles, barriers, branches) of
    every kernel function in ``cuobjdump -sass`` output."""
    keep = ("LDG", "LDS", "STS", "STG", "LDGSTS", "ATOMS", "REDG", "ATOMG", "SHFL", "MATCH",
            "BAR", "MEMBAR", "BRA", "F2F", "FADD")
    counts: Dict[str, collections.Counter] = {}
    func = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = m.group(1)
            counts[func] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", line)
        if m and func:
            op = m.group(1)
            base = op.split(".")[0]
            if base in keep:
                counts[func][base] += 1
            if op.startswith("ATOMS.CAS"):
                counts[func]["ATOMS.CAS*"] += 1
    return {f: dict(c) for f, c in counts.items()}


def _nvcc(src: Path, lib: Path) -> subprocess.Popen:
    return subprocess.Popen([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _same(a, b) -> bool:
    """Equal tensors, NaN equal to NaN."""
    import torch

    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all()) if a.is_floating_point() \
        else torch.equal(a, b)


def _histogram_case(old_lib: Path, dev, data) -> Tuple[Dict[str, Dict[str, Callable]], Dict]:
    """(timed calls by input, checks) of csrc/histogram.cu."""
    from ..ops import hist_kernel

    return _rows_case(old_lib, "lgbt_histogram", hist_kernel.histogram, dev, data)


def _v1_case(old_lib: Path, dev, data) -> Tuple[Dict[str, Dict[str, Callable]], Dict]:
    """(timed calls by input, checks) of csrc/hist_v1.cu."""
    from ..ops import hist_kernel

    return _rows_case(old_lib, "lgbt_hist_v1", hist_kernel.hist_v1, dev, data)


def _rows_case(old_lib: Path, symbol: str, new_fn, dev, data):
    """(timed calls by input, checks) of an ``[F, N]`` histogram kernel:
    the old library's ``symbol`` (the launcher arguments of the other
    ``[F, N]`` kernels, a zeroed output) against the wrapper ``new_fn``,
    after holding both to the plain version on dyadic values."""
    import numpy as np
    import torch

    from ..ops import hist_kernel
    from ..ops.histogram import leaf_histogram, leaf_values

    old = getattr(ctypes.CDLL(str(old_lib)), symbol)
    old.restype = ctypes.c_int
    old.argtypes = hist_kernel._ARGS_ROWS

    def run_old(bins, values, B, rows, dt):
        F = bins.shape[0]
        n = bins.shape[1] if rows is None else rows.numel()
        out = torch.zeros((F, B, 3), dtype=torch.float32, device=dev)
        code = old(bins.data_ptr(), bins.stride(0), bins.stride(1), values.data_ptr(),
                   rows.data_ptr() if rows is not None else None, n, F, B, int(dt == "bfloat16"),
                   out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check(code, "old " + symbol)
        return out

    versions = {"old": run_old, "new": new_fn}
    bins, hist_bins, B, N, real = data["bins"], data["hist_bins"], data["B"], data["N"], data["real"]
    rng = np.random.RandomState(0)
    q = 1024

    def tensor(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    dyadic = leaf_values(tensor(rng.randint(-q, q + 1, N) / q), tensor(rng.randint(1, 65, N) / q),
                         torch.ones(N, device=dev))
    segments = {str(n): torch.from_numpy(np.sort(rng.permutation(N)[:n]).astype(np.int32)).to(dev)
                for n in SIZES}
    segments["root"] = None
    for key, rows in segments.items():
        for dt in ("float32", "bfloat16"):
            want = leaf_histogram(bins, dyadic, B, rows, dt)
            for v, fn in versions.items():
                assert torch.equal(fn(hist_bins, dyadic, B, rows, dt), want), (v, key, dt)
    print("dyadic exact: old and new at every size, f32 and bf16", flush=True)
    calls = {}
    for dt in ("float32", "bfloat16"):
        for key, rows in segments.items():
            calls["%s/%s" % (dt, key)] = {
                v: (lambda fn=fn, rows=rows, dt=dt: fn(hist_bins, real, B, rows, dt))
                for v, fn in versions.items()}
    return calls, {}


def _split_case(old_lib: Path, dev, data) -> Tuple[Dict[str, Dict[str, Callable]], Dict]:
    """(timed calls by input set, checks) of the split kernels."""
    import numpy as np
    import torch

    from ..ops import split_kernel
    from ..ops.grow import _go_left
    from ..ops.histogram import leaf_histogram, leaf_values
    from ..ops.split import SplitParams, find_best_split_pair

    old = ctypes.CDLL(str(old_lib)).lgbt_split_pair
    old.restype = ctypes.c_int
    old.argtypes = _OLD_SPLIT_ARGS
    keys = ("num_bin", "missing_type", "default_bin", "monotone")
    meta, fmask = data["meta"], data["fmask"]
    params = SplitParams(0.0, 0.0, 0.0, 20, 1e-3, 0.0)  # the main path's

    def run_old(hist2, sums, cons, two_way):
        C, F, B, _ = hist2.shape
        feat_f = torch.empty((C, F, 4), dtype=torch.float32, device=dev)
        feat_i = torch.empty((C, F, 2), dtype=torch.int32, device=dev)
        outf = torch.empty((C, 9), dtype=torch.float32, device=dev)
        outi = torch.empty((C, 4), dtype=torch.int32, device=dev)
        p = params
        code = old(hist2.data_ptr(), sums.data_ptr(), cons.data_ptr(),
                   *(meta[k].data_ptr() for k in keys), fmask.data_ptr(), feat_f.data_ptr(),
                   feat_i.data_ptr(), outf.data_ptr(), outi.data_ptr(), C, F, B, p.lambda_l1,
                   p.lambda_l2, p.max_delta_step, float(p.min_data_in_leaf),
                   p.min_sum_hessian_in_leaf, p.min_gain_to_split, int(two_way),
                   torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check(code, "old split_pair")
        return outf, outi

    bins, B, N = data["bins"], data["B"], data["N"]
    F = bins.shape[0]
    rng = np.random.RandomState(0)
    q = 1024
    dyadic = leaf_values(
        torch.tensor(rng.randint(-q, q + 1, N) / q, dtype=torch.float32, device=dev),
        torch.tensor(rng.randint(1, 65, N) / q, dtype=torch.float32, device=dev),
        torch.ones(N, device=dev))
    meta_h = {k: v.cpu().tolist() for k, v in meta.items()}
    cons1 = torch.tensor([[-np.inf, np.inf]], dtype=torch.float32, device=dev)
    cons2 = cons1.repeat(2, 1)

    def children(rows, hist):
        """Rows and histograms (left, right) of the plain version's best split."""
        sums = hist[0].sum(dim=0, keepdim=True)
        _, outi = find_best_split_pair(hist[None], sums, cons1, meta, fmask, params)
        f, thr, _, dl = (int(v) for v in outi[0])
        assert f >= 0, "no split"
        col = bins[f].long() if rows is None else bins[f].long().index_select(0, rows)
        gl = _go_left(col, thr, bool(dl), meta_h["missing_type"][f], meta_h["default_bin"][f],
                      meta_h["num_bin"][f] - 1)
        idx = torch.arange(N, device=dev) if rows is None else rows
        left, right = idx[gl], idx[~gl]
        small = left if left.numel() <= right.numel() else right
        h_small = leaf_histogram(bins, data["real"], B, small)
        h_large = hist - h_small
        return (left, right), ((h_small, h_large) if small is left else (h_large, h_small))

    root_hist = leaf_histogram(bins, data["real"], B)
    (lr, hists) = children(None, root_hist)
    first = lr
    rows, hist = max(zip(lr, hists), key=lambda rh: rh[0].numel())
    depth = 1
    while rows.numel() > 8000 and depth < 64:
        lr, hists = children(rows, hist)
        rows, hist = max(zip(lr, hists), key=lambda rh: rh[0].numel())
        depth += 1
    deep, _ = children(rows, hist)
    sets = {"root_split": (first, (0, 1)), "deep_split": (deep, (37, 130))}

    buf = torch.zeros((255, F, B, 3), dtype=torch.float32, device=dev)
    calls, checks = {}, {}
    for name, ((left, right), leaves) in sets.items():
        for kind, vals in (("dyadic", dyadic), ("real", data["real"])):
            hist2 = torch.stack([leaf_histogram(bins, vals, B, r.int()) for r in (left, right)])
            sums = hist2[:, 0].sum(dim=1).contiguous()
            buf[list(leaves)] = hist2
            for two_way in (True, False):
                plain = find_best_split_pair(hist2, sums, cons2, meta, fmask, params, two_way)
                got_old = run_old(hist2, sums, cons2, two_way)
                got_new = split_kernel.find_best_split_pair(buf, sums, cons2, meta, fmask, params,
                                                            two_way, leaves)
                rec = dict(
                    rows=[int(left.numel()), int(right.numel())],
                    old_eq_plain=[_same(a, b) for a, b in zip(got_old, plain)],
                    new_eq_plain=[_same(a, b) for a, b in zip(got_new, plain)],
                    new_eq_old=[_same(a, b) for a, b in zip(got_new, got_old)],
                )
                if not all(rec["old_eq_plain"]):
                    rec["old"] = [t.tolist() for t in got_old]
                    rec["plain"] = [t.tolist() for t in plain]
                checks["%s/%s/two_way=%d" % (name, kind, two_way)] = rec
                print(name, kind, two_way, json.dumps(rec), flush=True)
                assert all(rec["new_eq_old"]), ("new != old", name, kind, two_way)
        # timed on the real histograms, the last ones placed in buf
        grower = buf.clone()
        for tw in (True, False):
            calls["%s/two_way=%d" % (name, tw)] = dict(
                old=lambda h=hist2, s=sums, tw=tw: run_old(h, s, cons2, tw),
                old_copy=lambda s=sums, lv=list(leaves), tw=tw: run_old(grower[lv], s, cons2, tw),
                new=lambda s=sums, lv=leaves, tw=tw: split_kernel.find_best_split_pair(
                    grower, s, cons2, meta, fmask, params, tw, lv),
            )
    return calls, checks


# lgbt_hist_packed4 before the per-thread design: bins, stride_f, stride_n,
# values [N2, 6], n2, F, B, bf16, out, stream
_OLD_PACKED4_ARGS = [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
]


def _packed4_case(old_lib: Path, dev, data) -> Tuple[Dict[str, Dict[str, Callable]], Dict]:
    """(timed calls by input, checks) of the nibble-packed kernels, after
    holding both to each other and to the plain version on dyadic values."""
    import numpy as np
    import torch

    from ..ops import hist_kernel
    from ..ops.histogram import leaf_histogram, leaf_values

    old = ctypes.CDLL(str(old_lib)).lgbt_hist_packed4
    old.restype = ctypes.c_int
    old.argtypes = _OLD_PACKED4_ARGS
    N, F, B = 1_000_000, 28, 15
    gen = torch.Generator(device=dev).manual_seed(B)  # chip_smoke.py phase 6's bins
    syn_nf = torch.randint(0, B, (N, F), generator=gen, device=dev, dtype=torch.uint8)
    syn = syn_nf.t()
    setup = hist_kernel.pack_bins(syn_nf).t()  # the grower's copy, made once
    rng = np.random.RandomState(0)
    q = 1024

    def tensor(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    dyadic = leaf_values(tensor(rng.randint(-q, q + 1, N) / q), tensor(rng.randint(1, 65, N) / q),
                         torch.ones(N, device=dev))
    real = leaf_values(tensor(rng.randn(N)), tensor(rng.rand(N)), torch.ones(N, device=dev))

    def run_old(bp, vp, dt):
        out = torch.zeros((F, B, 3), dtype=torch.float32, device=dev)
        code = old(bp.data_ptr(), bp.stride(0), bp.stride(1), vp.data_ptr(), bp.shape[1], F, B,
                   int(dt == "bfloat16"), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check(code, "old hist_packed4")
        return out

    def old_grower(values, rows, dt):  # gather, pack4, kernel
        b, v = (syn, values) if rows is None else (syn.index_select(1, rows.long()),
                                                   values.index_select(0, rows.long()))
        return run_old(*hist_kernel.pack4(b, v), dt)

    def new_grower(values, rows, dt):
        return hist_kernel.hist_packed4_rows(setup, values, B, rows, dt)

    segments = {str(n): torch.from_numpy(np.sort(rng.permutation(N)[:n]).astype(np.int32)).to(dev)
                for n in SIZES}
    segments["root"] = None
    packed_in = {k: hist_kernel.pack4(syn, v) for k, v in (("dyadic", dyadic), ("real", real))}
    for dt in ("float32", "bfloat16"):
        want = leaf_histogram(syn, dyadic, B, None, dt)
        got_old = run_old(*packed_in["dyadic"], dt)
        got_new = hist_kernel.hist_packed4(*packed_in["dyadic"], B, dt)
        assert torch.equal(got_old, want) and torch.equal(got_new, want), ("pack4 input", dt)
        for key, rows in segments.items():
            want = leaf_histogram(syn, dyadic, B, rows, dt)
            assert torch.equal(old_grower(dyadic, rows, dt), want), ("old", key, dt)
            assert torch.equal(new_grower(dyadic, rows, dt), want), ("new", key, dt)
    print("dyadic exact: old and new on pack4 input and as the grower calls them, f32 and bf16",
          flush=True)
    calls = {}
    for dt in ("float32", "bfloat16"):
        bp, vp = packed_in["real"]
        calls["%s/root_pack4_input" % dt] = dict(
            old=lambda dt=dt: run_old(bp, vp, dt),
            new=lambda dt=dt: hist_kernel.hist_packed4(bp, vp, B, dt))
        for key, rows in segments.items():
            calls["%s/%s" % (dt, key)] = dict(
                old=lambda rows=rows, dt=dt: old_grower(real, rows, dt),
                new=lambda rows=rows, dt=dt: new_grower(real, rows, dt))
    grids = {key: hist_kernel.packed4_grid(N if rows is None else rows.numel(), F,
                                           hist_kernel._sm_count(dev))
             for key, rows in segments.items()}
    return calls, {"grids": grids}


SOURCES = {"histogram": "histogram", "split_pair": "split_pair", "packed4": "hist_packed4",
           "v1": "hist_v1"}


def _higgs_data(dev) -> Dict:
    """The bench data binned at max_bin=255, log-loss gradients at the
    average score, and the data's feature meta."""
    import numpy as np
    import torch

    import lightgbm_tpu_torch as lgb
    from ..config import Config
    from ..ops.histogram import leaf_values
    from helpers.bench_data import make_higgs_like  # the repository root is on the path

    X, y = make_higgs_like(1_000_000, 28)
    params = {"objective": "binary", "max_bin": 255, "num_leaves": 255, "verbose": -1}
    binned = lgb.Dataset(X, label=y).get_binned(Config.from_params(params))
    N, B = binned.num_data, binned.max_num_bin
    bins = torch.from_numpy(np.ascontiguousarray(binned.bins)).to(dev)
    p0 = float(np.mean(y))
    sign = np.where(y > 0, 1.0, -1.0)
    resp = -sign / (1.0 + np.exp(sign * np.log(p0 / (1 - p0))))  # log-loss at the average
    real = leaf_values(torch.tensor(resp, dtype=torch.float32, device=dev),
                       torch.tensor(np.abs(resp) * (1 - np.abs(resp)), dtype=torch.float32,
                                    device=dev),
                       torch.ones(N, device=dev))
    meta_np = binned.feature_meta_arrays()
    return dict(
        bins=bins, hist_bins=bins.t().contiguous().t(), N=N, B=B, real=real,
        meta={k: torch.as_tensor(np.asarray(meta_np[k]).astype(np.int32), device=dev)
              for k in ("num_bin", "missing_type", "default_bin", "monotone")},
        fmask=torch.ones(bins.shape[0], dtype=torch.bool, device=dev),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", required=True, choices=tuple(SOURCES))
    ap.add_argument("--old", required=True, help="an older csrc/<source>.cu of the kernel")
    ap.add_argument("--out", default="", help="also write the results as JSON here")
    args = ap.parse_args(argv)

    import torch

    from .tune import CudaTimer

    if not torch.cuda.is_available():
        print("pair: needs a CUDA card", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    out_dir = cuda_build.BUILD_DIR.parent / "pair"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = SOURCES[args.kernel]
    old_lib, empty_lib = out_dir / ("libold_%s.so" % source), out_dir / "libempty.so"
    (out_dir / "empty.cu").write_text(EMPTY_SRC)
    procs = {"old": _nvcc(Path(args.old), old_lib), "empty": _nvcc(out_dir / "empty.cu", empty_lib)}
    cuda_build.build([source])
    logs = {}
    for name, proc in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for %s:\n%s" % (name, logs[name]))
    new_lib = cuda_build.library_path(source)
    sass = {"old": sass_text(old_lib), "new": sass_text(new_lib)}
    built = dict(
        old=dict(ptxas=cuda_build.ptxas_usage(logs["old"]), sass=sass_counts(sass["old"])),
        new=dict(ptxas=cuda_build.ptxas_usage(new_lib.with_suffix(".log").read_text()),
                 sass=sass_counts(sass["new"])),
    )
    for name, rec in built.items():
        print(name, json.dumps(rec), flush=True)
    empty = ctypes.CDLL(str(empty_lib)).lgbt_empty
    empty.restype = ctypes.c_int
    empty.argtypes = [ctypes.c_void_p]

    def launch_empty():
        cuda_build.check(empty(torch.cuda.current_stream(dev).cuda_stream), "empty kernel")

    data = None if args.kernel == "packed4" else _higgs_data(dev)
    case = {"histogram": _histogram_case, "split_pair": _split_case,
            "packed4": _packed4_case, "v1": _v1_case}[args.kernel]
    calls, checks = case(old_lib, dev, data)

    timer = CudaTimer(dev)
    times = {}
    for key, versions in calls.items():
        order = list(versions) + ["empty"]
        turns = {v: [] for v in order}
        for v in order + order[::-1]:
            fn = launch_empty if v == "empty" else versions[v]
            turns[v].append(timer(fn, reps=20))
        times[key] = {v: sum(t) / len(t) for v, t in turns.items()}
        print(key, json.dumps(times[key]), flush=True)
    sums = {v: sum(t[v] for t in times.values()) for v in next(iter(times.values()))}
    print(json.dumps({"sum_ms_over_inputs": sums}), flush=True)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        for name, text in sass.items():
            out.with_suffix(".%s.sass" % name).write_text(text)
        with open(out, "w") as fh:
            json.dump({"card": card, "kernel": args.kernel, "built": built, "checks": checks,
                       "times_ms": times, "sum_ms_over_inputs": sums}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
