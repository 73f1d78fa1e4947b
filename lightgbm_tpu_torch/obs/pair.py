"""Paired timing of one kernel of csrc/ against an older source of it, in
one process on one card.

On a machine with a CUDA card, from the repository root::

    git show <commit>:lightgbm_tpu_torch/csrc/<kernel>.cu > build/old_<kernel>.cu
    python -m lightgbm_tpu_torch.obs.pair --kernel {histogram,histogram_grid,split_pair,packed4,v1} \\
        --old build/old_<kernel>.cu [--out results.json]
    python -m lightgbm_tpu_torch.obs.pair --kernel histogram_grid \\
        --old build/a.cu build/b.cu ... [--out results.json]
    python -m lightgbm_tpu_torch.obs.pair --kernel pick_partition \\
        --old build/old_partition.cu build/old_grow_step.cu [--out results.json]
    python -m lightgbm_tpu_torch.obs.pair --kernel split_step \\
        --old build/old_split_pair.cu build/old_grow_step.cu [--out results.json]
    python -m lightgbm_tpu_torch.obs.pair --kernel split_fold \\
        --old build/old_split_pair.cu [--out results.json]
    python -m lightgbm_tpu_torch.obs.pair --kernel instantiations \\
        --old build/old_partition.cu build/old_predict_bins.cu [--out results.json]

``instantiations`` times nothing: each ``old_<source>.cu`` is built beside
today's ``csrc/<source>.cu``, and every kernel of the old library is
matched to today's kernel of the same name whose template arguments add
trailing zeros (a template flag that is off: ``pick_partition_kernel<1>``
to ``pick_partition_kernel<1,0>``). Prints both kernels' ptxas registers
and spills and SASS opcode counts and whether they are equal; exits 1
when a pair differs or an old kernel has no match.

The old sources are built with the package's nvcc flags into ``build/pair/``,
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

``histogram_grid`` (csrc/histogram.cu): each old source takes today's
launcher, ``rows_per_block`` included, and all run with
``histogram_grid``'s chunking. Held and timed as ``histogram`` below, on
the bench data (keys ``higgs/...``) and again on a Covertype-shaped table
(``covertype/...``: ``bench.covertype_like_rows``, 581,012 x 54, 44
features of 2 bins, the first class's softmax gradients at the prior).
Where a table takes the grouped form (``hist_kernel.grouped_adds``: the
Covertype-shaped one), the new kernel runs it, and so does an old source
that has it (``lgbt_histogram_grouped``). It takes one old source or more,
each a version of its own named ``old_<file stem>`` (``old`` when one):
copies of today's source with other ``kBusyLanes`` / ``kGroupLanes`` time
the grouped form's thresholds against each other in one process.

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

``pick_partition`` (csrc/partition.cu's fused step; ``--old`` names the
partition.cu and the grow_step.cu from before the fusion, whose
``lgbt_grow_step`` picked and wired the split and whose ``lgbt_partition``
launched three passes: count, scan, scatter, commit cec1c3d or earlier):
the main path's split loop on the bench data at 1M rows, real log-loss
gradients at the average score, at three states: the root step, step 128
of the 255-leaf tree, and that state with the leaf nearest 1024 rows made
the pick (its gain raised above the others). At each, the old four
launches, the new one and the plain version (ops/grow_step.py ``pick`` and
ops/partition.py ``partition``) run on copies of the state and must leave
every state tensor equal; then old and new are timed from the state,
restored before each call, beside the nearest library calls: one
``torch.argmax`` over the leaves' gains (the pick) and one stable
``torch.sort`` of the segment's decision keys (the partition's order).
Then, with the L2 warm as in the split loop, each version's device time a
call under ``torch.profiler`` (30 calls, the state restored before each),
beside three cut copies of the new kernel that return early (``_CUTS``:
right after launch, after the pick, after the rows are read and decided),
so that the differences give the launch's, the pick's, the rows' and the
barrier and scatter's shares.

``split_step`` (a step's histogram subtraction and split scan; ``--old``
names the split_pair.cu and the grow_step.cu from before the fold, whose
``lgbt_hist_subtract`` launched the subtraction and whose
``lgbt_split_pair_dev`` took no scratch, commit 27b653b or earlier): the
main path's split loop on the bench data at 1M rows, real log-loss
gradients at the average score, with each step's pick and segment
histogram done, at four states: the root's first split, the first step
whose smaller child is the parent's slot (BEST) and the first whose
smaller child is the new leaf (NEW), and step 128. At each, the old two
launches, the folded one and the plain version (ops/grow_step.py
``split_pair_fold``) run on copies of the state and must leave every state
tensor equal (the old pair clears the step's scratch, the fold the other
one, so the old one's ``small`` is not compared); then old and new are
timed from the state, restored before each call, beside one ``torch.sub``
of the parent's and the scratch's rows (the subtraction's nearest library
call), and each version's warm-L2 device time a call under
``torch.profiler``.

``split_fold`` (the folded scan against an older split_pair.cu whose
``lgbt_split_pair_dev`` already folds the subtraction but takes no
categorical arguments, commit ae86c69): the states of ``split_step``; at
each the old and the new folded scan and the plain version must leave
every state tensor equal, then old and new are timed as there, and each
one's warm-L2 device time a call under ``torch.profiler``.
"""
from __future__ import annotations

import argparse
import collections
import functools
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

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

    return _rows_calls({"old": run_old, "new": new_fn}, dev, data), {}


def _histogram_grid_case(old_libs: List[Path], labels: List[str], dev,
                         data) -> Tuple[Dict[str, Dict[str, Callable]], Dict]:
    """(timed calls by input, checks) of csrc/histogram.cu against one or
    more older sources (``labels``) that take the same launcher
    (``rows_per_block`` included), run with
    :func:`~..ops.hist_kernel.histogram_grid`'s chunking: on the bench data
    (keys ``higgs/...``) and on a Covertype-shaped table (``covertype/...``:
    bench.covertype_like_rows at 581,012 rows, 44 of its 54 features of 2
    bins) with the first class's softmax gradients at the class prior. On a
    table that :func:`~..ops.hist_kernel.grouped_adds` sends to the grouped
    form, each version runs it where it has it."""
    import torch

    from ..ops import hist_kernel

    def old_call(lib: Path):
        cdll = ctypes.CDLL(str(lib))
        entries = {}
        for grouped, symbol in ((False, "lgbt_histogram"), (True, "lgbt_histogram_grouped")):
            fn = getattr(cdll, symbol, None) or entries[False]
            fn.restype = ctypes.c_int
            fn.argtypes = hist_kernel._ARGS_HIST
            entries[grouped] = fn

        def run(grouped, bins, values, B, rows, dt):
            F = bins.shape[0]
            n = bins.shape[1] if rows is None else rows.numel()
            out = torch.zeros((F, B, 3), dtype=torch.float32, device=dev)
            code = entries[grouped](
                bins.data_ptr(), bins.stride(0), bins.stride(1), values.data_ptr(),
                rows.data_ptr() if rows is not None else None, n, F, B, int(dt == "bfloat16"),
                hist_kernel.histogram_grid(n, F, hist_kernel._sm_count(dev))[2],
                out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
            cuda_build.check(code, "old lgbt_histogram")
            return out
        return run

    def new_call(grouped, bins, values, B, rows, dt):
        return hist_kernel.histogram(bins, values, B, rows, dt, grouped=grouped)

    runs = dict(zip(labels, map(old_call, old_libs)), new=new_call)
    calls = {}
    for name, d in (("higgs", data), ("covertype", _covertype_data(dev))):
        grouped = hist_kernel.grouped_adds(d["bins"].cpu().numpy())
        print("%s: grouped form %s" % (name, grouped), flush=True)
        versions = {v: functools.partial(run, grouped) for v, run in runs.items()}
        calls.update(_rows_calls(versions, dev, d, name + "/"))
    return calls, {}


def _rows_calls(versions, dev, data, prefix: str = "") -> Dict[str, Dict[str, Callable]]:
    """Hold each of ``versions`` (name -> a histogram call taking (bins,
    values, B, rows, hist_dtype)) to the plain version bit for bit on
    dyadic values (multiples of 2^-10), f32 and bf16, at sorted random
    segments of :data:`SIZES` rows and the root; return the timed calls
    on the data's real values by input."""
    import numpy as np
    import torch

    from ..ops.histogram import leaf_histogram, leaf_values

    bins, hist_bins, B, N, real = data["bins"], data["hist_bins"], data["B"], data["N"], data["real"]
    rng = np.random.RandomState(0)
    q = 1024

    def tensor(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    # hessians up to data["hess_max"] / q: their sum over a cell stays below
    # 2^14, exact in f32 (a 2-bin feature's cell holds most of the rows)
    dyadic = leaf_values(tensor(rng.randint(-q, q + 1, N) / q),
                         tensor(rng.randint(1, data.get("hess_max", 64) + 1, N) / q),
                         torch.ones(N, device=dev))
    segments = {str(n): torch.from_numpy(np.sort(rng.permutation(N)[:n]).astype(np.int32)).to(dev)
                for n in SIZES}
    segments["root"] = None
    for key, rows in segments.items():
        for dt in ("float32", "bfloat16"):
            want = leaf_histogram(bins, dyadic, B, rows, dt)
            for v, fn in versions.items():
                assert torch.equal(fn(hist_bins, dyadic, B, rows, dt), want), (prefix, v, key, dt)
    print("%sdyadic exact: old and new at every size, f32 and bf16" % prefix, flush=True)
    calls = {}
    for dt in ("float32", "bfloat16"):
        for key, rows in segments.items():
            calls["%s%s/%s" % (prefix, dt, key)] = {
                v: (lambda fn=fn, rows=rows, dt=dt: fn(hist_bins, real, B, rows, dt))
                for v, fn in versions.items()}
    return calls


def _split_case(old_lib: Path, dev, data) -> Tuple[Dict[str, Dict[str, Callable]], Dict]:
    """(timed calls by input set, checks) of the split kernels."""
    import numpy as np
    import torch

    from ..ops import split_kernel
    from ..ops.partition import go_left as _go_left
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
        _, outi, _ = find_best_split_pair(hist[None], sums, cons1, meta, fmask, params)
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


# lgbt_grow_step before the fusion: ctl, best_f, best_i, node_i, node_f,
# leaf_f, leaf_i, laux, mono; M; l1, l2, max_delta_step; stream
_OLD_GROW_STEP_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] + [ctypes.c_float] * 3 + [
    ctypes.c_void_p]
# lgbt_partition before the fusion: bins, stride_f, stride_n, order, scratch,
# flags, tiles, ctl, best_i, missing, default_bin, num_bin, leaf_begin,
# leaf_count; grid; stream
_OLD_PARTITION_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] + [
    ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_void_p]


# a return inserted into csrc/partition.cu at a marker (after it, or before
# it): the cut kernel does what the full one does up to there
_CUTS = {
    "launch": ("  const int M = a.M;\n", True),
    "pick": ("  // ---- 2. the chunk's rows, decided and staged ----\n", False),
    "rows": ("  left = __reduce_add_sync(kFull, left);\n", False),
}


def _cut_libraries(out_dir: Path) -> Dict[str, Path]:
    """Build the cut copies of csrc/partition.cu, all at once."""
    src = (cuda_build.CSRC / "partition.cu").read_text()
    procs, libs = {}, {}
    for name, (marker, after) in _CUTS.items():
        assert src.count(marker) == 1, ("cut marker", name)
        path = out_dir / ("cut_%s.cu" % name)
        path.write_text(src.replace(marker, marker + "  return;\n" if after
                                    else "  return;\n" + marker))
        libs[name] = out_dir / ("libcut_%s.so" % name)
        procs[name] = _nvcc(path, libs[name])
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for cut %s:\n%s" % (name, log))
    return libs


def _profiled_us(fn, setup, names, reps=30) -> float:
    """Device µs a call of the kernels whose names contain one of ``names``,
    under torch.profiler over ``reps`` calls of ``setup`` then ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    setup()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            setup()
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and any(n in ev.key for n in names):
            us = getattr(ev, "self_device_time_total", None)
            total += us if us is not None else getattr(ev, "self_cuda_time_total", 0)
    return total / reps


def _pick_partition_case(old_libs, dev, data) -> Tuple[Dict[str, Dict[str, Callable]], Dict]:
    """(timed calls by state, checks) of the split loop's pick and
    partition: the old four launches against the fused one."""
    import torch

    from ..ops import grow as grow_mod
    from ..ops import grow_state as gs
    from ..ops import grow_step as plain_step
    from ..ops import hist_kernel, partition_kernel
    from ..ops import partition as plain_partition
    from ..ops.split import SplitParams

    old_part = ctypes.CDLL(str(old_libs[0])).lgbt_partition
    old_part.restype = ctypes.c_int
    old_part.argtypes = _OLD_PARTITION_ARGS
    old_pick = ctypes.CDLL(str(old_libs[1])).lgbt_grow_step
    old_pick.restype = ctypes.c_int
    old_pick.argtypes = _OLD_GROW_STEP_ARGS
    bins, N, B, real = data["bins"], data["N"], data["B"], data["real"]
    F = bins.shape[0]
    M = 255
    params = SplitParams(0.0, 0.0, 0.0, 20, 1e-3, 0.0)  # the main path's
    flags = torch.empty(N, dtype=torch.uint8, device=dev)
    tiles = torch.empty(-(-N // 1024), dtype=torch.int32, device=dev)
    old_grid = max(min(4 * hist_kernel._sm_count(dev), tiles.numel()), 1)

    def run_old(st):
        m, p = st.feature_meta, st.params
        stream = torch.cuda.current_stream(dev).cuda_stream
        cuda_build.check(old_pick(
            st.ctl.data_ptr(), st.best_f.data_ptr(), st.best_i.data_ptr(), st.node_i.data_ptr(),
            st.node_f.data_ptr(), st.leaf_f.data_ptr(), st.leaf_i.data_ptr(), st.laux.data_ptr(),
            m["monotone"].data_ptr(), st.M, p.lambda_l1, p.lambda_l2, p.max_delta_step, stream),
            "old grow_step")
        cuda_build.check(old_part(
            st.bins.data_ptr(), st.bins.stride(0), st.bins.stride(1), st.order.data_ptr(),
            st.scratch.data_ptr(), flags.data_ptr(), tiles.data_ptr(), st.ctl.data_ptr(),
            st.best_i.data_ptr(), m["missing_type"].data_ptr(), m["default_bin"].data_ptr(),
            m["num_bin"].data_ptr(), st.leaf_begin.data_ptr(), st.leaf_count.data_ptr(),
            old_grid, stream), "old partition")

    def run_plain(st):
        plain_step.pick(st)
        plain_partition.partition(st)

    versions = {"old": run_old, "new": partition_kernel.pick_partition, "plain": run_plain}
    cuts = {}
    for name, lib in _cut_libraries(cuda_build.BUILD_DIR.parent / "pair").items():
        fn = ctypes.CDLL(str(lib)).lgbt_pick_partition
        fn.restype = ctypes.c_int
        fn.argtypes = partition_kernel.ARGTYPES
        cuts[name] = fn
    s = gs.GrowState(dev, N, F, B, M)
    args = (bins, real[:, 0].contiguous(), real[:, 1].contiguous(), data["fmask"], data["meta"],
            -1, params, True, data["hist_bins"].t())
    grow_mod.start_tree(s, *args)
    states = {"root": s.clone()}
    for _ in range(128):
        grow_mod.run_step(s)
    states["step128"] = s.clone()
    nl = int(s.ctl[gs.NUM_LEAVES])
    gains = s.best_f[:nl, 0]
    near = (s.leaf_count[:nl] - 1024).abs().float() + torch.where(gains > 0, 0.0, float("inf"))
    s.best_f[int(torch.argmin(near)), 0] = gains.max() + 1.0
    states["rows_1k"] = s

    calls, checks = {}, {}
    for key, st in states.items():
        outs = {}
        for v, fn in versions.items():
            outs[v] = st.clone()
            fn(outs[v])
        torch.cuda.synchronize()
        same = {v: all(torch.equal(getattr(outs[v], k), getattr(outs["plain"], k))
                       for k in gs.GrowState.STATE) for v in ("old", "new")}
        leaf = int(outs["plain"].ctl[gs.BEST])
        b0, cnt = int(st.leaf_begin[leaf]), int(st.leaf_count[leaf])
        checks[key] = dict(rows=cnt, equal_to_plain=same)
        print(key, json.dumps(checks[key]), flush=True)
        assert all(same.values()), ("pick_partition != plain", key, same)
        # the partition's decision keys over the segment: 0 left, 1 right
        f, thr, _, dl = (int(x) for x in st.best_i[leaf])
        col = st.bins[f].index_select(0, st.order[b0:b0 + cnt].long())
        gl = plain_partition.go_left(
            col, thr, bool(dl), int(st.feature_meta["missing_type"][f]),
            int(st.feature_meta["default_bin"][f]), int(st.feature_meta["num_bin"][f]) - 1)
        decision = (~gl).to(torch.uint8)
        work = {v: st.clone() for v in ("old", "new")}

        def restore(dst, src=st):
            for k in gs.GrowState.STATE:
                getattr(dst, k).copy_(getattr(src, k))
        calls[key] = dict(
            old=(lambda w=work["old"]: run_old(w), lambda w=work["old"]: restore(w)),
            new=(lambda w=work["new"]: partition_kernel.pick_partition(w),
                 lambda w=work["new"]: restore(w)),
            library_argmax=lambda g=st.best_f[:, 0]: torch.argmax(g),
            library_stable_sort=lambda d=decision: torch.sort(d, stable=True),
        )
        # the warm-L2 device time of each version and of the cut kernels
        w = work["new"]
        versions_warm = {
            "old": (calls[key]["old"], ("pick_kernel", "count_kernel", "scan_kernel",
                                        "scatter_kernel")),
            "new": (calls[key]["new"], ("pick_partition_kernel",)),
        }
        for name, fn in cuts.items():
            versions_warm["cut_" + name] = (
                (lambda fn=fn, w=w: cuda_build.check(fn(*partition_kernel.launch_args(w)),
                                                     "cut kernel"), lambda w=w: restore(w)),
                ("pick_partition_kernel",))
        checks[key]["profiled_us"] = {
            v: _profiled_us(call, setup, names)
            for v, ((call, setup), names) in versions_warm.items()}
        print(key, "profiled_us", json.dumps(checks[key]["profiled_us"]), flush=True)
    return calls, checks

# lgbt_hist_subtract (grow_step.cu before the fold): ctl, hist, small;
# cells; grid; stream
_OLD_SUBTRACT_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
# lgbt_split_pair_dev with the fold, before the categorical arguments:
# hist, ctl, laux, leaf_i, small, zero; max_depth; 4 meta, fmask, feat_f,
# feat_i, best_f, best_i, count; C, F, B; 6 params; two_way, stream
_OLD_SPLIT_FOLD_ARGS = (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
    + [ctypes.c_float] * 6 + [ctypes.c_int, ctypes.c_void_p]
)
# lgbt_split_pair_dev before the fold: hist, ctl, laux, leaf_i; max_depth;
# 4 meta, fmask, feat_f, feat_i, best_f, best_i, count; C, F, B; 6 params;
# two_way, stream
_OLD_SPLIT_DEV_ARGS = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
    + [ctypes.c_float] * 6 + [ctypes.c_int, ctypes.c_void_p]
)


def _step_states(dev, data) -> Dict[str, tuple]:
    """(state, parity, step) of the main path's split loop (real gradients,
    255 leaves) with each step's pick and segment histogram done and its
    scan not: the root's first split, the first step whose smaller child is
    the parent's slot and the first whose smaller child is the new leaf,
    and step 128."""
    from ..ops import grow as grow_mod
    from ..ops import grow_state as gs
    from ..ops import hist_kernel, partition_kernel, split_kernel
    from ..ops.split import SplitParams

    bins, N, B, real = data["bins"], data["N"], data["B"], data["real"]
    s = gs.GrowState(dev, N, bins.shape[0], B, 255)
    grow_mod.start_tree(s, bins, real[:, 0].contiguous(), real[:, 1].contiguous(), data["fmask"],
                        data["meta"], -1, SplitParams(0.0, 0.0, 0.0, 20, 1e-3, 0.0), True,
                        data["hist_bins"].t())
    states = {}
    for step in range(129):
        parity = step % 2
        partition_kernel.pick_partition(s)
        hist_kernel.histogram_segment(s, parity)
        alias = ("small_is_best" if int(s.ctl[gs.SMALL]) == int(s.ctl[gs.BEST])
                 else "small_is_new")
        for key, take in (("root", step == 0), (alias, alias not in states),
                          ("step128", step == 128)):
            if take and key not in states:
                states[key] = (s.clone(), parity, step)
        split_kernel.split_pair_fold(s, parity)
    return states


def _split_fold_case(old_libs, dev, data) -> Tuple[Dict[str, Dict[str, Callable]], Dict]:
    """(timed calls by state, checks) of the folded scan against an older
    folded scan of the numerical-only signature."""
    import torch

    from ..ops import grow_state as gs
    from ..ops import grow_step as plain_step
    from ..ops import split_kernel

    old = ctypes.CDLL(str(old_libs[0])).lgbt_split_pair_dev
    old.restype = ctypes.c_int
    old.argtypes = _OLD_SPLIT_FOLD_ARGS

    def run_old(st, parity):
        m, p = st.feature_meta, st.params
        cuda_build.check(old(
            st.hist.data_ptr(), st.ctl.data_ptr(), st.laux.data_ptr(), st.leaf_i.data_ptr(),
            st.small[parity].data_ptr(), st.small[1 - parity].data_ptr(), st.max_depth,
            *(m[k].data_ptr() for k in ("num_bin", "missing_type", "default_bin", "monotone")),
            st.feature_mask.data_ptr(), st.feat_f.data_ptr(), st.feat_i.data_ptr(),
            st.best_f.data_ptr(), st.best_i.data_ptr(),
            split_kernel._ticket_counter(dev).data_ptr(), 2, st.F, st.B, p.lambda_l1,
            p.lambda_l2, p.max_delta_step, float(p.min_data_in_leaf), p.min_sum_hessian_in_leaf,
            p.min_gain_to_split, int(st.two_way), torch.cuda.current_stream(dev).cuda_stream),
            "old split_pair_fold")

    calls, checks = {}, {}
    for key, (st, parity, step) in _step_states(dev, data).items():
        outs = {}
        for v, fn in (("old", run_old), ("new", split_kernel.split_pair_fold),
                      ("plain", plain_step.split_pair_fold)):
            outs[v] = st.clone()
            fn(outs[v], parity)
        torch.cuda.synchronize()
        same = {v: all(torch.equal(getattr(outs[v], k), getattr(outs["plain"], k))
                       for k in gs.GrowState.STATE) for v in ("old", "new")}
        checks[key] = dict(step=step, parity=parity, equal_to_plain=same)
        print(key, json.dumps(checks[key]), flush=True)
        assert all(same.values()), ("split fold != plain", key, same)
        work = {v: st.clone() for v in ("old", "new")}

        def restore(dst, src=st):
            for k in gs.GrowState.STATE:
                getattr(dst, k).copy_(getattr(src, k))
        calls[key] = dict(
            old=(lambda w=work["old"], p=parity: run_old(w, p), lambda w=work["old"]: restore(w)),
            new=(lambda w=work["new"], p=parity: split_kernel.split_pair_fold(w, p),
                 lambda w=work["new"]: restore(w)),
        )
        checks[key]["profiled_us"] = {
            v: _profiled_us(*calls[key][v], ("split_pair_kernel",)) for v in ("old", "new")}
        print(key, "profiled_us", json.dumps(checks[key]["profiled_us"]), flush=True)
    return calls, checks


def _split_step_case(old_libs, dev, data) -> Tuple[Dict[str, Dict[str, Callable]], Dict]:
    """(timed calls by state, checks) of a step's subtraction and split
    scan: the old two launches (hist_subtract, then the scan's device entry)
    against the folded scan."""
    import torch

    from ..ops import grow_state as gs
    from ..ops import grow_step as plain_step
    from ..ops import split_kernel

    old_scan = ctypes.CDLL(str(old_libs[0])).lgbt_split_pair_dev
    old_scan.restype = ctypes.c_int
    old_scan.argtypes = _OLD_SPLIT_DEV_ARGS
    old_sub = ctypes.CDLL(str(old_libs[1])).lgbt_hist_subtract
    old_sub.restype = ctypes.c_int
    old_sub.argtypes = _OLD_SUBTRACT_ARGS
    cells = data["bins"].shape[0] * data["B"] * 3

    def run_old(st, parity):
        m, p = st.feature_meta, st.params
        stream = torch.cuda.current_stream(dev).cuda_stream
        cuda_build.check(old_sub(st.ctl.data_ptr(), st.hist.data_ptr(),
                                 st.small[parity].data_ptr(), cells, -(-cells // 256), stream),
                         "old hist_subtract")
        cuda_build.check(old_scan(
            st.hist.data_ptr(), st.ctl.data_ptr(), st.laux.data_ptr(), st.leaf_i.data_ptr(),
            st.max_depth, *(m[k].data_ptr() for k in ("num_bin", "missing_type", "default_bin",
                                                        "monotone")),
            st.feature_mask.data_ptr(), st.feat_f.data_ptr(), st.feat_i.data_ptr(),
            st.best_f.data_ptr(), st.best_i.data_ptr(),
            split_kernel._ticket_counter(dev).data_ptr(), 2, st.F, st.B, p.lambda_l1,
            p.lambda_l2, p.max_delta_step, float(p.min_data_in_leaf), p.min_sum_hessian_in_leaf,
            p.min_gain_to_split, int(st.two_way), stream), "old split_pair_dev")

    states = _step_states(dev, data)
    calls, checks = {}, {}
    for key, (st, parity, step) in states.items():
        outs = {}
        for v, fn in (("old", run_old), ("new", split_kernel.split_pair_fold),
                      ("plain", plain_step.split_pair_fold)):
            outs[v] = st.clone()
            fn(outs[v], parity)
        torch.cuda.synchronize()
        # the old pair zeroes this step's scratch, the fold the other one
        same = {v: all(torch.equal(getattr(outs[v], k), getattr(outs["plain"], k))
                       for k in gs.GrowState.STATE if v == "new" or k != "small")
                for v in ("old", "new")}
        leaf = int(st.ctl[gs.SMALL])
        checks[key] = dict(step=step, parity=parity, small_child=leaf,
                           small_rows=int(st.leaf_count[leaf]), equal_to_plain=same)
        print(key, json.dumps(checks[key]), flush=True)
        assert all(same.values()), ("split step != plain", key, same)
        work = {v: st.clone() for v in ("old", "new")}

        def restore(dst, src=st):
            for k in gs.GrowState.STATE:
                getattr(dst, k).copy_(getattr(src, k))
        sub_a, sub_b = st.hist[int(st.ctl[gs.BEST])].clone(), st.small[parity].clone()
        sub_out = torch.empty_like(sub_a)
        calls[key] = dict(
            old=(lambda w=work["old"], p=parity: run_old(w, p), lambda w=work["old"]: restore(w)),
            new=(lambda w=work["new"], p=parity: split_kernel.split_pair_fold(w, p),
                 lambda w=work["new"]: restore(w)),
            library_sub=lambda a=sub_a, b=sub_b, o=sub_out: torch.sub(a, b, out=o),
        )
        checks[key]["profiled_us"] = {
            v: _profiled_us(*calls[key][v], names)
            for v, names in (("old", ("subtract_kernel", "split_pair_kernel")),
                             ("new", ("split_pair_kernel",)))}
        print(key, "profiled_us", json.dumps(checks[key]["profiled_us"]), flush=True)
    return calls, checks


SOURCES = {"histogram": ("histogram",), "histogram_grid": ("histogram",),
           "split_pair": ("split_pair",),
           "packed4": ("hist_packed4",), "v1": ("hist_v1",),
           "pick_partition": ("partition", "grow_step"),
           "split_step": ("split_pair", "grow_step"), "split_fold": ("split_pair",)}


def _covertype_data(dev) -> Dict:
    """bench.covertype_like_rows(581_012) binned with its cell's params (max_bin
    255, EFB off) in the grower's layout, and the first class's softmax
    gradients and hessians at the class prior."""
    import numpy as np
    import torch

    import lightgbm_tpu_torch as lgb
    from .. import bench
    from ..config import Config
    from ..ops.histogram import leaf_values

    X, y = bench.covertype_like_rows(bench.COVER_ROWS, seed=31)
    binned = lgb.Dataset(X, label=y).get_binned(Config.from_params(dict(bench.COVER_PARAMS)))
    bins = torch.from_numpy(np.ascontiguousarray(binned.bins)).to(dev)
    prior = np.bincount(y.astype(np.int64), minlength=7)[0] / len(y)
    grad = prior - (y == 0)
    hess = np.full(len(y), 2.0 * prior * (1.0 - prior))
    real = leaf_values(torch.tensor(grad, dtype=torch.float32, device=dev),
                       torch.tensor(hess, dtype=torch.float32, device=dev),
                       torch.ones(len(y), device=dev))
    return dict(bins=bins, hist_bins=bins.t().contiguous().t(), N=binned.num_data,
                B=binned.max_num_bin, real=real, hess_max=16)


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


def _flag_off(kernel: str, names) -> Optional[str]:
    """The kernel of ``names`` that is ``kernel`` with trailing template
    arguments of 0 added (``f<1>`` -> ``f<1,0>``), or None."""
    def split(k):
        base, _, t = k.partition("<")
        return base, t.rstrip(">").split(",") if t else []

    base, args = split(kernel)
    for k in names:
        b, a = split(k)
        if b == base and a[:len(args)] == args and set(a[len(args):]) <= {"0"}:
            return k
    return None


def _instantiations(old_sources: List[str], out: str) -> int:
    """Build each old source beside today's and compare their kernels'
    ptxas usage and SASS opcode counts (``--kernel instantiations``)."""
    out_dir = cuda_build.BUILD_DIR.parent / "pair"
    out_dir.mkdir(parents=True, exist_ok=True)
    names = [Path(o).stem[len("old_"):] if Path(o).stem.startswith("old_") else Path(o).stem
             for o in old_sources]
    libs = [out_dir / ("libold_%s.so" % n) for n in names]
    procs = [_nvcc(Path(o), lib) for o, lib in zip(old_sources, libs)]
    cuda_build.build(names)
    report, same = {}, True
    for name, proc, lib in zip(names, procs, libs):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for old %s:\n%s" % (name, log))
        new_lib = cuda_build.library_path(name)
        sides = {}
        for side, path, text in (("old", lib, log),
                                 ("new", new_lib, new_lib.with_suffix(".log").read_text())):
            sass = {cuda_build.kernel_name(k): v for k, v in sass_counts(sass_text(path)).items()}
            sides[side] = {k: dict(ptxas=v, sass=sass.get(k, {}))
                           for k, v in cuda_build.ptxas_usage(text).items()}
        rows = {}
        for kernel, old in sides["old"].items():
            match = _flag_off(kernel, sides["new"])
            new = sides["new"].get(match)
            ok = new is not None and new == old
            same &= ok
            rows[kernel] = dict(new_kernel=match, equal=ok, old=old, new=new)
        report[name] = rows
        print(name, json.dumps(rows), flush=True)
    print(json.dumps({"instantiations_equal": same}), flush=True)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        with open(out, "w") as fh:
            json.dump({"instantiations": report, "equal": same}, fh, indent=1)
    return 0 if same else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", required=True, choices=tuple(SOURCES) + ("instantiations",))
    ap.add_argument("--old", required=True, nargs="+",
                    help="older csrc/<source>.cu of the kernel (pick_partition: partition.cu "
                         "and grow_step.cu; split_step: split_pair.cu and grow_step.cu)")
    ap.add_argument("--out", default="", help="also write the results as JSON here")
    args = ap.parse_args(argv)

    import torch

    from .tune import CudaTimer

    if not torch.cuda.is_available():
        print("pair: needs a CUDA card", file=sys.stderr)
        return 2
    if args.kernel == "instantiations":
        return _instantiations(args.old, args.out)
    sources = SOURCES[args.kernel]
    if args.kernel == "histogram_grid":  # one older histogram.cu or more, each a version
        labels = ["old"] if len(args.old) == 1 else ["old_" + Path(o).stem for o in args.old]
    else:
        labels = ["old"] if len(sources) == 1 else ["old_" + name for name in sources]
    if len(set(labels)) != len(labels):
        print("pair: the old sources need distinct file names", file=sys.stderr)
        return 2
    if args.kernel != "histogram_grid" and len(args.old) != len(sources):
        print("pair: --kernel %s takes %d old sources (%s)"
              % (args.kernel, len(sources), ", ".join(n + ".cu" for n in sources)), file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    out_dir = cuda_build.BUILD_DIR.parent / "pair"
    out_dir.mkdir(parents=True, exist_ok=True)
    old_libs = [out_dir / ("lib%s.so" % label) for label in labels]
    empty_lib = out_dir / "empty.so"
    (out_dir / "empty.cu").write_text(EMPTY_SRC)
    procs = {label: _nvcc(Path(src), lib) for label, src, lib in zip(labels, args.old, old_libs)}
    procs["empty"] = _nvcc(out_dir / "empty.cu", empty_lib)
    cuda_build.build(list(sources))
    logs = {}
    for name, proc in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for %s:\n%s" % (name, logs[name]))
    sass = {}
    built = {}
    for label, lib in zip(labels, old_libs):
        sass[label] = sass_text(lib)
        built[label] = dict(ptxas=cuda_build.ptxas_usage(logs[label]), sass=sass_counts(sass[label]))
    new_lib = cuda_build.library_path(sources[0])
    sass["new"] = sass_text(new_lib)
    built["new"] = dict(ptxas=cuda_build.ptxas_usage(new_lib.with_suffix(".log").read_text()),
                        sass=sass_counts(sass["new"]))
    for name, rec in built.items():
        print(name, json.dumps(rec), flush=True)
    empty = ctypes.CDLL(str(empty_lib)).lgbt_empty
    empty.restype = ctypes.c_int
    empty.argtypes = [ctypes.c_void_p]

    def launch_empty():
        cuda_build.check(empty(torch.cuda.current_stream(dev).cuda_stream), "empty kernel")

    data = None if args.kernel == "packed4" else _higgs_data(dev)
    if args.kernel == "pick_partition":
        calls, checks = _pick_partition_case(old_libs, dev, data)
    elif args.kernel == "split_step":
        calls, checks = _split_step_case(old_libs, dev, data)
    elif args.kernel == "split_fold":
        calls, checks = _split_fold_case(old_libs, dev, data)
    elif args.kernel == "histogram_grid":
        calls, checks = _histogram_grid_case(old_libs, labels, dev, data)
    else:
        case = {"histogram": _histogram_case, "split_pair": _split_case,
                "packed4": _packed4_case, "v1": _v1_case}[args.kernel]
        calls, checks = case(old_libs[0], dev, data)

    timer = CudaTimer(dev)
    times = {}
    for key, versions in calls.items():
        order = list(versions) + ["empty"]
        turns = {v: [] for v in order}
        for v in order + order[::-1]:
            fn = launch_empty if v == "empty" else versions[v]
            fn, setup = fn if isinstance(fn, tuple) else (fn, None)  # (call, untimed restore)
            turns[v].append(timer(fn, reps=20, setup=setup))
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
