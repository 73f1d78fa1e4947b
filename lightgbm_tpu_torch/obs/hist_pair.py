"""Paired timing of csrc/histogram.cu against an older source of the same
kernel, in one process on one card.

On a machine with a CUDA card, from the repository root::

    git show <commit>:lightgbm_tpu_torch/csrc/histogram.cu > build/old_histogram.cu
    python -m lightgbm_tpu_torch.obs.hist_pair --old build/old_histogram.cu \\
        [--out results.json]

The old source takes the launcher arguments of the other ``[F, N]`` kernels
(no ``rows_per_block``); it is built with the package's nvcc flags into
``build/hist_pair/``, and the new kernel runs through its own wrapper,
``hist_kernel.histogram``. Prints both libraries' ptxas registers and spills
and their SASS opcode counts (``cuobjdump -sass``), checks both against the
plain version bit for bit on dyadic values (multiples of 2^-10) in f32 and
bf16, then times them in turns (old, new, new, old) at the sizes of one
tree's calls: sorted random segments of 256, 1024, 4096, 16384 and 100k
rows of make_higgs_like(1M, 28) binned at max_bin=255, in the grower's
layout (``bins_nf.t()``), and the whole 1M-row root. A time is the mean of
the two turns' CUDA-event medians (``tune.CudaTimer``: L2 flushed, launch
overhead hidden), the output's memset included.
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
from typing import Dict

from ..ops import cuda_build

SIZES = (256, 1024, 4096, 16384, 100_000)


def sass_counts(library: Path) -> Dict[str, Dict[str, int]]:
    """Opcode counts (memory, atomics, branches) of every kernel function
    in a built library, from ``cuobjdump -sass``."""
    cuobjdump = Path(cuda_build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    keep = ("LDG", "LDS", "STS", "STG", "ATOMS", "REDG", "ATOMG", "BRA", "F2F")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, help="an older csrc/histogram.cu")
    ap.add_argument("--out", default="", help="also write the results as JSON here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import lightgbm_tpu_torch as lgb
    from ..config import Config
    from ..ops import hist_kernel
    from ..ops.histogram import leaf_histogram, leaf_values
    from .tune import CudaTimer

    if not torch.cuda.is_available():
        print("hist_pair: needs a CUDA card", file=sys.stderr)
        return 2
    from helpers.bench_data import make_higgs_like  # the repository root is on the path

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    out_dir = cuda_build.BUILD_DIR.parent / "hist_pair"
    out_dir.mkdir(parents=True, exist_ok=True)
    old_lib = out_dir / "libold.so"
    p = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(old_lib), args.old],
                       capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError("nvcc failed for %s:\n%s" % (args.old, p.stdout + p.stderr))
    cuda_build.build(["histogram"])
    new_lib = cuda_build.library_path("histogram")
    built = dict(
        old=dict(ptxas=cuda_build.ptxas_usage(p.stdout + p.stderr), sass=sass_counts(old_lib)),
        new=dict(ptxas=cuda_build.ptxas_usage(new_lib.with_suffix(".log").read_text()),
                 sass=sass_counts(new_lib)),
    )
    for name, rec in built.items():
        print(name, json.dumps(rec), flush=True)
    old = ctypes.CDLL(str(old_lib)).lgbt_histogram
    old.restype = ctypes.c_int
    old.argtypes = hist_kernel._ARGS_ROWS

    def run_old(bins, values, B, rows, dt):
        F = bins.shape[0]
        n = bins.shape[1] if rows is None else rows.numel()
        out = torch.zeros((F, B, 3), dtype=torch.float32, device=dev)
        code = old(bins.data_ptr(), bins.stride(0), bins.stride(1), values.data_ptr(),
                   rows.data_ptr() if rows is not None else None, n, F, B, int(dt == "bfloat16"),
                   out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check(code, "old histogram")
        return out

    versions = {"old": run_old, "new": hist_kernel.histogram}

    X, y = make_higgs_like(1_000_000, 28)
    params = {"objective": "binary", "max_bin": 255, "num_leaves": 255, "verbose": -1}
    binned = lgb.Dataset(X, label=y).get_binned(Config.from_params(params))
    N, B = binned.num_data, binned.max_num_bin
    bins = torch.from_numpy(np.ascontiguousarray(binned.bins)).to(dev)
    hist_bins = bins.t().contiguous().t()  # the grower's layout
    rng = np.random.RandomState(0)
    q = 1024

    def tensor(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    dyadic = leaf_values(tensor(rng.randint(-q, q + 1, N) / q), tensor(rng.randint(1, 65, N) / q),
                         torch.ones(N, device=dev))
    p0 = float(np.mean(y))
    sign = np.where(y > 0, 1.0, -1.0)
    resp = -sign / (1.0 + np.exp(sign * np.log(p0 / (1 - p0))))  # log-loss at the average
    real = leaf_values(tensor(resp), tensor(np.abs(resp) * (1 - np.abs(resp))),
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

    timer = CudaTimer(dev)
    times = {}
    for dt in ("float32", "bfloat16"):
        for key, rows in segments.items():
            turns = {v: [] for v in versions}
            for v in ("old", "new", "new", "old"):
                fn = versions[v]
                turns[v].append(timer(lambda: fn(hist_bins, real, B, rows, dt), reps=20))
            times["%s/%s" % (dt, key)] = {v: sum(t) / len(t) for v, t in turns.items()}
            print(dt, key, json.dumps(times["%s/%s" % (dt, key)]), flush=True)
    sums = {dt: {v: sum(times["%s/%s" % (dt, k)][v] for k in segments) for v in versions}
            for dt in ("float32", "bfloat16")}
    print(json.dumps({"sum_ms_over_sizes": sums}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": card, "built": built, "times_ms": times,
                       "sum_ms_over_sizes": sums}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
