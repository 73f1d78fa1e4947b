"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card. A CUDA kernel has no interpret mode, so these skip without a
card; run them on a GPU machine with
``python -m pytest tests/test_torch_cuda.py -m cuda``.

Dyadic values (multiples of 1/64, or of 1/1024 where bf16 operands must
round) make every summation order exact, so the kernels must match the
plain versions bit for bit.
"""
import functools

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import cuda_build, cuda_graph
from lightgbm_tpu_torch.ops import grow as grow_mod
from lightgbm_tpu_torch.ops import grow_state as gs
from lightgbm_tpu_torch.ops import grow_step as grow_step_plain
from lightgbm_tpu_torch.ops import grow_step_kernel, hist_kernel, partition_kernel, split_kernel
from lightgbm_tpu_torch.ops import partition as partition_plain
from lightgbm_tpu_torch.ops.grow import TreeArrays, grow_tree, grow_tree_device
from lightgbm_tpu_torch.ops.histogram import (
    leaf_histogram, leaf_histogram_packed4_rows, leaf_values, segment_histogram,
)
from lightgbm_tpu_torch.ops.split import SplitParams, find_best_split_pair, split_pair_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the GPU")
    return torch.device("cuda")


def _dyadic(dev, F=28, N=50_001, B=255, seed=0, q=64):
    rng = np.random.RandomState(seed)
    bins = torch.tensor(rng.randint(0, B, (F, N)), dtype=torch.uint8, device=dev)
    vals = leaf_values(
        torch.tensor(rng.randint(-q, q + 1, N) / q, dtype=torch.float32, device=dev),
        torch.tensor(rng.randint(1, 65, N) / q, dtype=torch.float32, device=dev),
        torch.tensor(rng.rand(N) > 0.2, device=dev),
    )
    rows = torch.tensor(np.sort(rng.permutation(N)[: N // 7]).astype(np.int32), device=dev)
    return bins, vals, rows


@pytest.mark.parametrize("B", [15, 63, 255])
def test_histogram_kernel_matches_plain(dev, B):
    bins, vals, rows = _dyadic(dev, B=B)
    nf = bins.t().contiguous()
    assert torch.equal(hist_kernel.histogram(bins, vals, B), leaf_histogram(bins, vals, B))
    assert torch.equal(
        hist_kernel.histogram(nf.t(), vals, B, rows), leaf_histogram(bins, vals, B, rows)
    )


def _grid_edges(F, num_sms):
    """Row counts at csrc/histogram.cu's edges: one row, inside, at and across
    one 1024-row step, a ragged 4-step chunk, and one row either side of a
    chunk edge at a rows_per_block above the 1024-row floor."""
    _, chunks, rpb = hist_kernel.histogram_grid(400_000, F, num_sms)
    assert rpb > 1024
    edges = [(chunks - 1) * rpb - 1, (chunks - 1) * rpb + 1]
    for n in edges:
        assert hist_kernel.histogram_grid(n, F, num_sms)[2] == rpb, (n, rpb)
    return [1, 255, 1023, 1024, 1025, 4 * 1024 + 3] + edges


@pytest.mark.parametrize("F", [5, 8, 29])
@pytest.mark.parametrize("B", [15, 63, 255, 336])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_histogram_grid_edges(dev, F, B, dtype):
    """The default kernel at the grid's edges (:func:`_grid_edges`), whole and
    on a sorted segment, from the [F, N] and the [N, F] layouts (F = 8 takes
    the one-word bin load), against its plain version; hist_v1 equals it."""
    edges = _grid_edges(F, hist_kernel._sm_count(dev))
    bins, vals, _ = _dyadic(dev, F=F, N=max(edges) + 7, B=B, seed=F * B, q=1024)
    nf = bins.t().contiguous()
    gen = np.random.RandomState(B)
    for n in edges:
        rows = torch.tensor(np.sort(gen.permutation(bins.shape[1])[:n]).astype(np.int32), device=dev)
        for b_fn, b_nf, v, r in ((bins[:, :n], nf[:n].t(), vals[:n], None), (bins, nf.t(), vals, rows)):
            want = leaf_histogram(b_fn, v, B, r, dtype)
            got = hist_kernel.histogram(b_nf, v, B, r, dtype)
            assert torch.equal(hist_kernel.histogram(b_fn, v, B, r, dtype), want), (n, r is None)
            assert torch.equal(got, want), (n, r is None)
            assert torch.equal(hist_kernel.hist_v1(b_nf, v, B, r, dtype), got), (n, r is None)


FAMILY = {
    "histogram": (hist_kernel.histogram, (15, 63, 255)),
    "hist_v1": (hist_kernel.hist_v1, (15, 63, 255)),
    "hist_onehot": (hist_kernel.hist_onehot, (15, 63, 255)),
    "hist_bitplane": (hist_kernel.hist_bitplane, (15, 63, 255)),
    "hist_packed4": (hist_kernel.hist_packed4, (15,)),
}


@pytest.mark.parametrize("kernel,B,dtype", [
    (k, b, d) for k, (_, bs) in FAMILY.items() for b in bs for d in ("float32", "bfloat16")
])
def test_kernel_family_matches_plain(dev, kernel, B, dtype):
    """Every kernel in both operand types, whole and on a segment, against
    its plain version (F=29: not a multiple of any feature tile; odd N)."""
    bins, vals, rows = _dyadic(dev, F=29, B=B, seed=B, q=1024)
    nf = bins.t().contiguous()
    before = dict(hist_kernel.launches)
    if kernel == "hist_packed4":
        setup = hist_kernel.pack_bins(nf).t()  # the grower's copy, read by row
        for r in (None, rows):
            b, v = (bins, vals) if r is None else (bins[:, r.long()], vals[r.long()])
            bp, vp = hist_kernel.pack4(b, v)
            got = hist_kernel.hist_packed4(bp, vp, B, dtype)
            assert torch.equal(got, leaf_histogram_packed4_rows(bp, vp.view(-1, 3), B, None, dtype))
            assert torch.equal(got, leaf_histogram(bins, vals, B, r, dtype))
            assert torch.equal(hist_kernel.hist_packed4_rows(setup, vals, B, r, dtype), got)
    else:
        fn = FAMILY[kernel][0]
        assert torch.equal(fn(bins, vals, B, None, dtype), leaf_histogram(bins, vals, B, None, dtype))
        assert torch.equal(fn(nf.t(), vals, B, rows, dtype), leaf_histogram(bins, vals, B, rows, dtype))
        # v1 is the oracle of the default kernel
        assert torch.equal(
            hist_kernel.hist_v1(nf.t(), vals, B, rows, dtype),
            hist_kernel.histogram(nf.t(), vals, B, rows, dtype),
        )
    key = kernel + ("_bf16" if dtype == "bfloat16" else "")
    assert hist_kernel.launches[key] > before[key]


@pytest.mark.parametrize("n", [0, 1, 15, 17])
def test_kernels_on_tiny_segments(dev, n):
    bins, vals, _ = _dyadic(dev, F=9, N=1001, B=63)
    rows = torch.arange(3, 3 + n, dtype=torch.int32, device=dev)
    want = leaf_histogram(bins, vals, 63, rows)
    for fn in (hist_kernel.histogram, hist_kernel.hist_v1, hist_kernel.hist_onehot,
               hist_kernel.hist_bitplane):
        assert torch.equal(fn(bins, vals, 63, rows), want), fn.__name__


def _packed4_cases(bins, vals, n, gen):
    """(name, packed bins, values, rows) of one row count: the first n rows
    whole from the set-up copy (the word path when F % 4 == 0), from pack4's
    [F, N2] and from a set-up copy cut by one feature (byte path, stride_n
    != 1, not 4-byte aligned), and a segment of n rows with odd and even
    indices read by row from the full set-up copy."""
    nf = bins[:, :n].t().contiguous()
    full = hist_kernel.pack_bins(bins.t().contiguous())
    rows = torch.tensor(np.sort(gen.choice(bins.shape[1], n, replace=False)).astype(np.int32),
                        device=bins.device)
    return [
        ("setup", hist_kernel.pack_bins(nf).t(), vals[:n], None),
        ("pack4", hist_kernel.pack4(bins[:, :n], vals[:n])[0], vals[:n], None),
        ("setup_cut", hist_kernel.pack_bins(nf)[:, 1:].t(), vals[:n], None),
        ("rows", full.t(), vals, rows),
        ("rows_cut", full[:, 1:].t(), vals, rows),
    ]


PACKED4_ROWS = [1, 2, 3, 511, 512, 513, 100_000, 1_000_000]


@pytest.mark.parametrize("F", [1, 5, 28, 29])
@pytest.mark.parametrize("B", [1, 2, 15, 16])
def test_packed4_rows_matches_plain_and_histogram(dev, F, B):
    """hist_packed4_rows at every row count of PACKED4_ROWS, whole and by
    rows, in every layout of :func:`_packed4_cases`, in both operand types,
    with nibbles >= B among the bins: on dyadic values equal to its plain
    version and to histogram.cu (which skips bins >= B) bit for bit."""
    N = max(PACKED4_ROWS) + 1
    bins, vals, _ = _dyadic(dev, F=F, N=N, B=16, seed=F * 16 + B, q=1024)
    gen = np.random.RandomState(F + B)
    for n in PACKED4_ROWS:
        for name, packed, v, rows in _packed4_cases(bins, vals, n, gen):
            b = bins[:, :n] if rows is None else bins
            if name.endswith("_cut"):
                b = b[1:]
            for dtype in ("float32", "bfloat16"):
                got = hist_kernel.hist_packed4_rows(packed, v, B, rows, dtype)
                want = leaf_histogram_packed4_rows(packed, v, B, rows, dtype)
                assert torch.equal(got, want), (n, name, dtype)
                assert torch.equal(hist_kernel.histogram(b, v, B, rows, dtype), got), (n, name, dtype)


@pytest.mark.parametrize("F", [5, 28])
def test_packed4_real_values_within_two_orders(dev, F):
    """Real-valued rows sum in other orders than the plain version: each
    cell lies within the f32 bound of two orders, count * 2^-23 * sum |v|."""
    rng = np.random.RandomState(F)
    N = 1_000_001
    bins = torch.tensor(rng.randint(0, 15, (F, N)), dtype=torch.uint8, device=dev)
    vals = leaf_values(torch.tensor(rng.randn(N), dtype=torch.float32, device=dev),
                       torch.tensor(rng.rand(N), dtype=torch.float32, device=dev),
                       torch.ones(N, device=dev))
    packed = hist_kernel.pack_bins(bins.t().contiguous()).t()
    rows = torch.tensor(np.sort(rng.permutation(N)[:100_001]).astype(np.int32), device=dev)
    for r in (None, rows):
        for dtype in ("float32", "bfloat16"):
            got = hist_kernel.hist_packed4_rows(packed, vals, 15, r, dtype)
            want = leaf_histogram(bins, vals, 15, r, dtype)
            abs_sum = leaf_histogram(bins, vals.abs(), 15, r, dtype)
            err = (got - want).abs()
            assert bool((err <= want[..., 2:] * 2.0 ** -23 * abs_sum + 1e-6).all()), (r is None, dtype)


def test_packed4_back_to_back_calls(dev):
    """200 launches of changing shape, layout, width, operand type and grid
    without a sync between them, each equal to its plain version: the
    96 KB opt-in of each instantiation and the grid hold across calls."""
    gen = np.random.RandomState(9)
    sets = []
    for k, (F, n) in enumerate(((1, 3), (5, 513), (28, 100_000), (29, 70_001), (28, 1_000_000))):
        bins, vals, _ = _dyadic(dev, F=F, N=n, B=16, seed=30 + k, q=1024)
        for name, packed, v, rows in _packed4_cases(bins, vals, max(n // 3, 1), gen):
            for B, dtype in ((15, "float32"), (16, "bfloat16"), (2, "float32")):
                sets.append(((packed, v, B, rows, dtype),
                             leaf_histogram_packed4_rows(packed, v, B, rows, dtype)))
    outs = [hist_kernel.hist_packed4_rows(*sets[i % len(sets)][0]) for i in range(200)]
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        assert torch.equal(got, sets[i % len(sets)][1]), i


V1_ROWS = [1, 31, 32, 33, 511, 4096, 100_000]


def _v1_real(dev, F, N, B, seed):
    """Bins with some >= B (they add nothing) and real-valued rows, on the
    host (for the mirror) and on the card."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, min(B + 1 + B // 8, 256), (F, N)).astype(np.uint8)
    vals = leaf_values(torch.from_numpy(rng.randn(N).astype(np.float32)),
                       torch.from_numpy(rng.rand(N).astype(np.float32)),
                       torch.from_numpy(rng.rand(N) > 0.2)).numpy()
    return bins, vals, rng, torch.from_numpy(bins).to(dev), torch.from_numpy(vals).to(dev)


@pytest.mark.parametrize("F", [1, 5, 16, 17, 28, 29])
@pytest.mark.parametrize("B", [1, 2, 15, 63, 255, 336])
def test_hist_v1_equals_mirror_on_real_values(dev, F, B):
    """hist_v1 sums in a fixed order, so on real values it equals
    hist_v1_mirror bit for bit: every n of V1_ROWS (one chunk to 98), rows
    none / sorted / unsorted with repeats, f32 and bf16, from the [F, N]
    layout (byte path) and the [N, F] one (word path where F % 4 == 0)."""
    N = max(V1_ROWS) + 7
    bins_h, vals_h, rng, bins, vals = _v1_real(dev, F, N, B, F * 1000 + B)
    nf = bins.t().contiguous()
    sms = hist_kernel._sm_count(dev)
    for n in V1_ROWS:
        segments = {"all": None, "sorted": np.sort(rng.permutation(N)[:n]),
                    "unsorted": rng.randint(0, N, n)}
        for name, r in segments.items():
            if r is None:
                host = (bins_h[:, :n], vals_h[:n], None)
                card = [(bins[:, :n], vals[:n], None), (nf[:n].t(), vals[:n], None)]
            else:
                r = r.astype(np.int32)
                rt = torch.from_numpy(r).to(dev)
                host = (bins_h, vals_h, r)
                card = [(bins, vals, rt), (nf.t(), vals, rt)]
            for dtype in ("float32", "bfloat16"):
                bm, vm, rm = host
                want = torch.from_numpy(hist_kernel.hist_v1_mirror(bm, vm, B, rm, dtype, sms))
                for b, v, rt in card:
                    got = hist_kernel.hist_v1(b, v, B, rt, dtype).cpu()
                    assert torch.equal(got, want), (n, name, dtype, b.stride())


def test_hist_v1_back_to_back_calls_are_bit_equal(dev):
    """50 calls without a sync between them, alternating the 1M x 28 root
    (131 chunks through the scratch) in f32 and a 100k segment in bf16, on
    real values: every call gives the bits of the first of its kind, and the
    segment's are the mirror's."""
    N, F, B = 1_000_000, 28, 255
    bins_h, vals_h, rng, bins, vals = _v1_real(dev, F, N, B, 50)
    nf_t = bins.t().contiguous().t()
    rows_h = np.sort(rng.permutation(N)[:100_000]).astype(np.int32)
    rows = torch.from_numpy(rows_h).to(dev)
    kinds = [(None, "float32"), (rows, "bfloat16")]
    outs = [hist_kernel.hist_v1(nf_t, vals, B, *kinds[i % 2]) for i in range(50)]
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        assert torch.equal(got, outs[i % 2]), i
    want = hist_kernel.hist_v1_mirror(bins_h, vals_h, B, rows_h, "bfloat16",
                                      hist_kernel._sm_count(dev))
    assert torch.equal(outs[1].cpu(), torch.from_numpy(want))


# every template instance of each tensor-core kernel and its edges: the
# plane splits hist_bitplane's dispatch picks, and hist_onehot's 16-bin
# tile counts kMt in {1, 2, 4, 8, 16} on both sides of each boundary
TENSOR_CORE_WIDTHS = {
    "hist_bitplane": [2, 3, 4, 5, 16, 17, 64, 65, 128, 256],
    "hist_onehot": [2, 15, 16, 17, 32, 33, 63, 64, 65, 128, 129, 255, 256],
}


@pytest.mark.parametrize("kernel,B", [(k, b) for k, bs in TENSOR_CORE_WIDTHS.items() for b in bs])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tensor_core_every_instance(dev, kernel, B, dtype):
    """Each tensor-core kernel at each template instance, in both operand
    types, for 1, 8 and 29 features (one full and one ragged group of 8),
    whole and on a segment, from the [F, N] and the [N, F] bin layouts."""
    fn = getattr(hist_kernel, kernel)
    for F in (1, 8, 29):
        bins, vals, rows = _dyadic(dev, F=F, N=4099, B=B, seed=B + F, q=1024)
        nf = bins.t().contiguous()
        for r in (None, rows):
            want = leaf_histogram(bins, vals, B, r, dtype)
            assert torch.equal(fn(bins, vals, B, r, dtype), want), (F, r is None)
            assert torch.equal(fn(nf.t(), vals, B, r, dtype), want), (F, r is None)


@pytest.mark.parametrize("kernel", sorted(TENSOR_CORE_WIDTHS))
@pytest.mark.parametrize("n", [0, 1, 15, 17, 129])
def test_tensor_core_tile_edges(dev, kernel, n):
    """Segments that end inside a 16-row step and a 128-row tile."""
    fn = getattr(hist_kernel, kernel)
    for B in (5, 64, 256):
        bins, vals, _ = _dyadic(dev, F=29, N=1001, B=B, q=1024)
        rows = torch.arange(7, 7 + n, dtype=torch.int32, device=dev)
        for dtype in ("float32", "bfloat16"):
            want = leaf_histogram(bins, vals, B, rows, dtype)
            assert torch.equal(fn(bins, vals, B, rows, dtype), want), (B, dtype)
            assert torch.equal(fn(bins[:, 7:7 + n], vals[7:7 + n].contiguous(), B, None, dtype),
                               want), (B, dtype)


@pytest.mark.parametrize("two_way", [True, False])
def test_split_kernel_matches_plain(dev, two_way):
    B = 255
    bins, vals, rows = _dyadic(dev, B=B)
    small = leaf_histogram(bins, vals, B, rows)
    hist2 = torch.stack([small, leaf_histogram(bins, vals, B) - small]).contiguous()
    sums = hist2[:, 0].sum(dim=1).contiguous()
    cons = torch.tensor([[-np.inf, np.inf], [-1.0, 0.5]], dtype=torch.float32, device=dev)
    F = bins.shape[0]
    meta = {
        "num_bin": torch.full((F,), B, dtype=torch.int32, device=dev),
        "missing_type": torch.arange(F, dtype=torch.int32, device=dev) % 3,
        "default_bin": torch.arange(F, dtype=torch.int32, device=dev) % 4,
        "monotone": (torch.arange(F, dtype=torch.int32, device=dev) % 3) - 1,
    }
    fmask = torch.arange(F, device=dev) != 5
    for pr in ((0.0, 0.0, 0.0, 20, 1e-3, 0.0), (0.5, 1.0, 0.3, 5, 0.5, 0.1)):
        kf, ki, _ = split_kernel.find_best_split_pair(
            hist2, sums, cons, meta, fmask, SplitParams(*pr), two_way
        )
        pf, pi, _ = find_best_split_pair(hist2, sums, cons, meta, fmask, SplitParams(*pr), two_way)
        assert bool(((kf == pf) | (kf.isnan() & pf.isnan())).all())
        assert torch.equal(ki, pi)


def _split_inputs(dev, F=28, B=255, C=2, seed=0, real=False, tied=(), N=4000):
    """Children's histograms [C, F, B, 3] built from N rows (bins below each
    feature's num_bin), with their sums, monotone windows, meta and mask.
    Dyadic grad/hess (multiples of 1/64) keep every sum exact; ``real`` draws
    them from a normal law. The features in ``tied`` share one bin column
    and one meta entry that the gradients follow, so they tie for the best
    gain."""
    rng = np.random.RandomState(seed)
    num_bin = rng.randint(2, B + 1, F)
    num_bin[: min(F, 2)] = B
    missing = np.arange(F) % 3
    default_bin = rng.randint(0, 3, F) % num_bin
    monotone = np.zeros(F, np.int64)
    monotone[rng.randint(F)] = 1
    bins = (rng.rand(F, N) * num_bin[:, None]).astype(np.int64)
    hidden = rng.randint(0, B, N)
    if real:
        grad = rng.randn(N).astype(np.float32)
        hess = rng.rand(N).astype(np.float32) + np.float32(0.1)
    else:
        grad = rng.randint(-64, 65, N) / 64.0
        hess = rng.randint(1, 65, N) / 64.0
    if tied:
        grad = grad / 4 + np.where(hidden < B // 3, 0.5, -0.5)
        for f in tied:
            bins[f], num_bin[f], missing[f], default_bin[f], monotone[f] = hidden, B, 0, 0, 0
    child = rng.rand(N) < 0.4
    hist = np.zeros((C, F, B, 3), np.float64)
    sums = np.zeros((C, 3), np.float64)
    for c in range(C):
        rows = child if c == 0 else ~child
        vals = np.stack([grad[rows], hess[rows], np.ones(rows.sum())], 1)
        for f in range(F):
            np.add.at(hist[c, f], bins[f, rows], vals)
        sums[c] = vals.sum(0)
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt, device=dev)  # noqa: E731
    meta = {k: t(v, torch.int32) for k, v in (
        ("num_bin", num_bin), ("missing_type", missing), ("default_bin", default_bin),
        ("monotone", monotone))}
    cons = t([[-np.inf, np.inf], [-1.0, 0.5]][:C])
    fmask = torch.ones(F, dtype=torch.bool, device=dev)
    return t(hist.astype(np.float32)), t(sums.astype(np.float32)), cons, meta, fmask


SPLIT_PARAMS = [SplitParams(0.0, 0.0, 0.0, 20, 1e-3, 0.0), SplitParams(0.5, 1.0, 0.3, 5, 0.5, 0.1)]


def _same_split(got, want):
    (kf, ki, kb), (pf, pi, pb) = got, want
    assert bool(((kf == pf) | (kf.isnan() & pf.isnan())).all()), (kf, pf)
    assert torch.equal(ki, pi), (ki, pi)
    assert torch.equal(kb, pb), (kb, pb)


def _both(hist, sums, cons, meta, fmask, params, two_way=True, leaves=None):
    """(kernel, plain) on the same inputs."""
    args = (hist, sums, cons, meta, fmask, params, two_way)
    return (split_kernel.find_best_split_pair(*args, leaves=leaves),
            find_best_split_pair(*args, leaves=leaves))


@pytest.mark.parametrize("B", [2, 3, 17, 64, 255, 256, 336])
def test_split_kernel_widths(dev, B):
    hist, sums, cons, meta, fmask = _split_inputs(dev, B=B, seed=B)
    buf = torch.zeros((5,) + hist.shape[1:], device=dev)
    buf[3], buf[1] = hist[0], hist[1]
    for params in SPLIT_PARAMS:
        for two_way in (True, False):
            got, want = _both(hist, sums, cons, meta, fmask, params, two_way)
            _same_split(got, want)
            _same_split(_both(buf, sums, cons, meta, fmask, params, two_way, (3, 1))[0], want)


def test_split_kernel_refuses_more_than_1024_bins(dev):
    """Past 336 bins the rows1024 instantiations take rows up to 1024 bins
    (test_split_kernel_wide_widths); past 1024 the kernel refuses."""
    hist, sums, cons, meta, fmask = _split_inputs(dev, F=3, B=1025)
    with pytest.raises(ValueError, match="1024"):
        split_kernel.find_best_split_pair(hist, sums, cons, meta, fmask, SPLIT_PARAMS[0])


def test_split_kernel_refuses_three_leaves(dev):
    """The ticket counter serves two children a call."""
    hist, sums, cons, meta, fmask = _split_inputs(dev, F=3, B=17)
    with pytest.raises(ValueError, match="1 or 2 leaves"):
        split_kernel.find_best_split_pair(
            hist, sums[[0, 1, 1]], cons[[0, 1, 1]], meta, fmask, SPLIT_PARAMS[0],
            leaves=(0, 1, 1))


def test_split_kernel_wide_features(dev):
    """F = 300 blocks a child race for the ticket."""
    hist, sums, cons, meta, fmask = _split_inputs(dev, F=300, B=64, seed=3)
    for params in SPLIT_PARAMS:
        _same_split(*_both(hist, sums, cons, meta, fmask, params))


def test_split_kernel_tie_takes_smallest_feature(dev):
    hist, sums, cons, meta, fmask = _split_inputs(dev, F=300, B=64, seed=4, tied=(7, 270))
    assert torch.equal(hist[:, 7], hist[:, 270])
    got, want = _both(hist, sums, cons, meta, fmask, SPLIT_PARAMS[0])
    _same_split(got, want)
    assert got[1][:, 0].tolist() == [7, 7]
    fmask[7] = False  # the twin far away wins once the first is masked
    got, want = _both(hist, sums, cons, meta, fmask, SPLIT_PARAMS[0])
    _same_split(got, want)
    assert got[1][:, 0].tolist() == [270, 270]


def test_split_kernel_no_valid_candidate(dev):
    hist, sums, cons, meta, fmask = _split_inputs(dev, F=40, B=64, seed=5)
    params = SplitParams(0.0, 0.0, 0.0, 1_000_000, 1e-3, 0.0)
    got, want = _both(hist, sums, cons, meta, fmask, params)
    _same_split(got, want)
    assert bool(torch.isneginf(got[0][:, 0]).all()) and got[1][:, 0].tolist() == [-1, -1]


def test_split_kernel_mask_drops_best_feature(dev):
    hist, sums, cons, meta, fmask = _split_inputs(dev, F=28, B=255, seed=6)
    (_, ki, _), _ = _both(hist, sums, cons, meta, fmask, SPLIT_PARAMS[0])
    best = ki[:, 0].tolist()
    fmask[best] = False
    got, want = _both(hist, sums, cons, meta, fmask, SPLIT_PARAMS[0])
    _same_split(got, want)
    assert not set(got[1][:, 0].tolist()) & set(best)


def test_split_kernel_back_to_back_calls(dev):
    """500 launches without a sync between them, F and C changing: each
    equals the plain version, so every launch left the tickets at 0."""
    sets = []
    for k, (F, C) in enumerate(((1, 1), (5, 2), (28, 2), (28, 1), (300, 2), (64, 1))):
        inputs = _split_inputs(dev, F=F, B=64, C=C, seed=10 + k)
        sets.append((inputs, find_best_split_pair(*inputs, SPLIT_PARAMS[1])))
    outs = [split_kernel.find_best_split_pair(*sets[i % len(sets)][0], SPLIT_PARAMS[1])
            for i in range(500)]
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        _same_split(got, sets[i % len(sets)][1])


def test_split_kernel_real_values_bitwise(dev):
    """Real-valued histograms: the same fold order, the same rounded ops
    (--fmad=false), so every field equals the plain version bit for bit."""
    hist, sums, cons, meta, fmask = _split_inputs(dev, F=28, B=255, seed=7, real=True)
    for params in SPLIT_PARAMS:
        for two_way in (True, False):
            _same_split(*_both(hist, sums, cons, meta, fmask, params, two_way))


# ---- the device-resident split loop (ops/grow.py grow_tree_device) ----------

LOOP_PARAMS = SplitParams(0.0, 0.0, 0.0, 20, 1e-3, 0.0)


def _loop_inputs(dev, N, F=28, B=255, seed=0, q=1024, real=False, mono=False):
    """[F, N] bins (feature f below its num_bin), the [N, F] copy, gradients
    and hessians (multiples of 1/q, or real), meta with missing types 0/1/2
    (and with ``mono`` a +1 and a -1 monotone feature, whose windows can stop
    a tree early), and the feature mask. Multiples of 2^-10 keep every
    histogram cell exact at 1M rows, bf16 included."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    num_bin = torch.full((F,), B, dtype=torch.int32, device=dev)
    num_bin[3::4] = max(B // 3, 2)
    bins = (torch.rand((F, N), generator=gen, device=dev) * num_bin[:, None]).to(torch.uint8)
    if real:
        grad = torch.randn(N, generator=gen, device=dev)
        hess = torch.rand(N, generator=gen, device=dev) + 0.1
    else:
        grad = torch.randint(-q, q + 1, (N,), generator=gen, device=dev).float() / q
        hess = torch.randint(1, 65, (N,), generator=gen, device=dev).float() / q
    meta = {
        "num_bin": num_bin,
        "missing_type": torch.arange(F, dtype=torch.int32, device=dev) % 3,
        "default_bin": torch.arange(F, dtype=torch.int32, device=dev) % 3,
        "monotone": torch.zeros(F, dtype=torch.int32, device=dev),
    }
    if mono:
        meta["monotone"][1], meta["monotone"][2] = 1, -1
    return bins, bins.t().contiguous(), grad, hess, meta, torch.ones(F, dtype=torch.bool, device=dev)


def _same_state(a, b, what):
    """Every tensor of the state equal, NaN where both are NaN."""
    for k in gs.GrowState.STATE:
        x, y = getattr(a, k), getattr(b, k)
        same = x == y
        if x.is_floating_point():
            same |= x.isnan() & y.isnan()
        bad = (~same).nonzero()[:8].tolist()
        assert not bad, (what, k, bad, [(x[tuple(i)].item(), y[tuple(i)].item()) for i in bad])


@pytest.mark.parametrize("N", [100_000, 1_000_000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_loop_equals_host_loop(dev, N, dtype):
    """Dyadic gradients: the device loop grows the host loop's tree and leaf
    index bit for bit: 255 leaves, and at 100k rows also with max_depth 7 and
    with monotone features."""
    cases = ((False, -1), (False, 7), (True, -1)) if N < 1_000_000 else ((False, -1),)
    for mono, max_depth in cases:
        bins, nf, grad, hess, meta, mask = _loop_inputs(dev, N, seed=N % 97, mono=mono)
        args = (bins, grad, hess, mask, meta, 255, max_depth, 255, LOOP_PARAMS, True)
        want, want_leaf = grow_tree(*args, bins_nf=nf, hist_dtype=dtype)
        got, got_leaf, _ = grow_tree_device(*args, bins_nf=nf, hist_dtype=dtype)
        for name in TreeArrays._fields:
            assert torch.equal(getattr(got, name), getattr(want, name)), (name, mono, max_depth)
        assert torch.equal(got_leaf, want_leaf)
        nl = int(got.num_leaves)
        if max_depth > 0:
            assert nl <= 2 ** max_depth, nl
        elif not mono:
            assert nl == 255, nl


@pytest.mark.parametrize("N", [100_000])
def test_loop_kernels_match_plain_at_every_step(dev, N):
    """A 255-leaf tree on dyadic gradients, one step at a time: after each
    kernel of a step (pick_partition, the histogram's segment entry into the
    step's scratch, the split scan's folded entry) the whole state equals
    that of its plain version run on a copy of the state, with the smaller
    child in the parent's slot and in the new one."""
    bins, nf, grad, hess, meta, mask = _loop_inputs(dev, N, seed=5)
    s = gs.GrowState(dev, N, 28, 255, 255)
    grow_mod.start_tree(s, bins, grad, hess, mask, meta, -1, LOOP_PARAMS, True, nf)
    aliases = set()
    for step in range(254):
        p = step % 2
        pairs = (
            (partition_kernel.pick_partition, _plain_pick_partition),
            (lambda st: hist_kernel.histogram_segment(st, p), lambda st: segment_histogram(st, p)),
            (lambda st: split_kernel.split_pair_fold(st, p),
             lambda st: grow_step_plain.split_pair_fold(st, p)),
        )
        for k, (kernel, plain) in enumerate(pairs):
            other = s.clone()
            kernel(s)
            plain(other)
            _same_state(s, other, (step, k))
        aliases.add(int(s.ctl[gs.SMALL]) == int(s.ctl[gs.BEST]))
    assert int(s.ctl[gs.NUM_LEAVES]) == 255 and int(s.ctl[gs.STEP]) == 254
    assert aliases == {True, False}


def test_split_pair_fold_matches_plain_at_1m(dev):
    """The folded scan against the plain subtraction and split scan on a copy
    of the state, at 1M rows on real gradients (the same inputs, so bit for
    bit), at every step from the root's first split to step 128: every hist
    row, both scratch buffers, the records; the smaller child is the
    parent's slot (BEST) at some steps and the new leaf (NEW) at others."""
    N = 1_000_000
    bins, nf, grad, hess, meta, mask = _loop_inputs(dev, N, seed=21, real=True)
    s = gs.GrowState(dev, N, 28, 255, 255)
    grow_mod.start_tree(s, bins, grad, hess, mask, meta, -1, LOOP_PARAMS, True, nf)
    aliases = set()
    for step in range(129):
        p = step % 2
        partition_kernel.pick_partition(s)
        hist_kernel.histogram_segment(s, p)
        assert int(s.ctl[gs.ACTIVE]) == 1 and int(s.ctl[gs.STEP]) == step + 1
        other = s.clone()
        split_kernel.split_pair_fold(s, p)
        grow_step_plain.split_pair_fold(other, p)
        _same_state(s, other, step)
        assert not s.small[1 - p].any()
        small, large = int(s.ctl[gs.SMALL]), int(s.ctl[gs.LARGE])
        assert torch.equal(s.hist[small], s.small[p])
        assert torch.equal(s.hist[large], other.hist[large])
        aliases.add(small == int(s.ctl[gs.BEST]))
    assert aliases == {True, False}


def _plain_pick_partition(s):
    grow_step_plain.pick(s)
    partition_plain.partition(s)


# (N, begin, count, feature, threshold, default_left): feature 0 (bins 1-8)
# has no missing type, 1 the zero bin (default bin 1), 2 the nan bin (bin 8)
CARD_PARTITION_CASES = {
    "whole_1m": (1_000_000, 0, 1_000_000, 0, 4, 0),
    "whole_1.1m": (1_100_000, 0, 1_100_000, 0, 4, 0),
    "whole_1.5m": (1_500_000, 0, 1_500_000, 0, 4, 0),  # above the shared capacity
    "mid_tile_1m": (1_000_000, 1000, 600_001, 0, 3, 0),
    "tile_edges": (100_000, 1024, 1024, 0, 5, 0),
    "across_edges": (100_000, 1023, 1026, 0, 5, 0),
    "rows_33": (100_000, 4321, 33, 0, 5, 0),
    "rows_1025": (100_000, 4321, 1025, 0, 5, 0),
    "one_row": (100_000, 77_777, 1, 0, 4, 0),
    "empty": (100_000, 500, 0, 0, 4, 0),
    "empty_left": (100_000, 10, 50_000, 0, 0, 0),
    "empty_right": (100_000, 10, 50_000, 0, 8, 0),
    "zero_left": (1_000_000, 3, 999_990, 1, 3, 1),
    "zero_right": (1_000_000, 3, 999_990, 1, 0, 0),
    "nan_left": (100_000, 999, 70_001, 2, 2, 1),
    "nan_right": (100_000, 999, 70_001, 2, 6, 0),
}


def _picking_leaf_2(dev, N, begin, count, f, thr, dl, seed):
    """A state of 4 leaves whose pick is leaf 2 (its gain the one > 0): its
    segment ``count`` ascending rows at ``begin`` of a random order, its
    split (f, thr, dl) on 3 features of missing types none / zero / nan."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, 9, (3, N), generator=gen, device=dev, dtype=torch.uint8)
    bins[0] = torch.randint(1, 9, (N,), generator=gen, device=dev, dtype=torch.uint8)
    meta = {k: torch.tensor(v, dtype=torch.int32, device=dev) for k, v in (
        ("num_bin", [9, 9, 9]), ("missing_type", [0, 1, 2]), ("default_bin", [0, 1, 1]),
        ("monotone", [0, 1, -1]))}
    s = gs.GrowState(dev, N, 3, 9, 4)
    s.bind(bins, bins, torch.zeros((N, 3), device=dev), meta,
           torch.ones(3, dtype=torch.bool, device=dev), LOOP_PARAMS, True, -1, "float32")
    s.reset()
    order = torch.randperm(N, generator=gen, device=dev).int()
    order[begin:begin + count] = order[begin:begin + count].sort().values  # a leaf's rows ascend
    s.order.copy_(order)
    s.ctl[gs.NUM_LEAVES], s.ctl[gs.STEP] = 3, 1
    s.leaf_begin[2], s.leaf_count[2] = begin, count
    s.best_i[2] = torch.tensor([f, thr, 0, dl], dtype=torch.int32, device=dev)
    s.best_f[2] = torch.tensor([2.5, -1.0, 3.0, 40.0, 1.0, 5.0, 60.0, 0.25, -0.125], device=dev)
    s.leaf_i[2] = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    s.laux[2] = torch.tensor([0.0, 8.0, 100.0, -1.0, 1.0], device=dev)
    s.node_i[0] = torch.tensor([0, 3, -1, -3, 0], dtype=torch.int32, device=dev)
    return s, order


@pytest.mark.parametrize("case", sorted(CARD_PARTITION_CASES))
def test_partition_kernel_matches_plain(dev, case):
    """pick_partition picks leaf 2 and partitions its segment: every state
    tensor equal to the plain pick and partition on a copy of the state,
    rows outside the segment untouched."""
    N, begin, count, f, thr, dl = CARD_PARTITION_CASES[case]
    s, order = _picking_leaf_2(dev, N, begin, count, f, thr, dl, len(case))
    other = s.clone()
    partition_kernel.pick_partition(s)
    _plain_pick_partition(other)
    _same_state(s, other, case)
    assert int(s.ctl[gs.BEST]) == 2 and int(s.ctl[gs.NEW]) == 3
    left = int(s.leaf_count[2])
    assert int(s.leaf_begin[3]) == begin + left and int(s.leaf_count[3]) == count - left
    assert left == {"empty_left": 0, "empty_right": count}.get(case, left)
    outside = torch.ones(N, dtype=torch.bool, device=dev)
    outside[begin:begin + count] = False
    assert torch.equal(s.order[outside], order[outside])


def _launch_with_grid(s, grid):
    """pick_partition's kernel on ``grid`` blocks, fewer than the wrapper's."""
    cuda_build.check(partition_kernel.entry()(*partition_kernel.launch_args(s, grid)),
                     "pick_partition kernel")


@pytest.mark.parametrize("grid", [1, 2, 7, 64])
@pytest.mark.parametrize("count", [0, 1, 33, 1025, 100_000])
def test_pick_partition_kernel_matches_plain_at_any_grid(dev, grid, count):
    """Grids below the card's: one block (no other to wait for), and chunks
    above the shared capacity (100k rows over 2 or 7 blocks), staged in
    scratch."""
    s, _ = _picking_leaf_2(dev, 150_000, 777, count, 2, 5, 1, count + grid)
    other = s.clone()
    _launch_with_grid(s, grid)
    _plain_pick_partition(other)
    _same_state(s, other, (grid, count))
    # the launch's epoch 1, published by every block of the grid with its left count
    assert int(s.bar[0]) == 1
    words = s.block_left[:grid].cpu()
    assert bool(((words >> 32) == 1).all()) and int((words & 0xFFFFFFFF).sum()) == int(s.ctl[gs.LEFT])


@pytest.mark.parametrize("why", ["gain_zero", "gain_negative", "last_step"])
def test_pick_partition_kernel_stops(dev, why):
    """A best gain not > 0, or M - 1 splits done: ACTIVE cleared, nothing
    else changed; a later step changes nothing."""
    s, _ = _picking_leaf_2(dev, 100_000, 10, 50_000, 1, 3, 1, 3)
    if why == "last_step":
        s.ctl[gs.STEP] = s.M - 1
    else:
        s.best_f[2, 0] = 0.0 if why == "gain_zero" else -1.0
    before = s.clone()
    partition_kernel.pick_partition(s)
    before.ctl[gs.ACTIVE] = 0
    _same_state(s, before, why)
    partition_kernel.pick_partition(s)
    _same_state(s, before, why)


@pytest.mark.parametrize("feature", [5, 1051, 1052])
def test_pick_partition_kernel_reads_meta_beyond_the_shared_copy(dev, feature):
    """1100 features: a block keeps the meta of the first 1024 in shared
    memory and reads a later feature's from device memory (missing types
    none, zero, nan by feature % 3)."""
    N, F = 20_000, 1100
    gen = torch.Generator(device=dev).manual_seed(feature)
    bins = torch.randint(0, 9, (F, N), generator=gen, device=dev, dtype=torch.uint8)
    meta = {"num_bin": torch.full((F,), 9, dtype=torch.int32, device=dev),
            "missing_type": (torch.arange(F, device=dev) % 3).int(),
            "default_bin": torch.ones(F, dtype=torch.int32, device=dev),
            "monotone": torch.zeros(F, dtype=torch.int32, device=dev)}
    s = gs.GrowState(dev, N, F, 9, 4)
    s.bind(bins, bins, torch.zeros((N, 3), device=dev), meta,
           torch.ones(F, dtype=torch.bool, device=dev), LOOP_PARAMS, True, -1, "float32")
    s.reset()
    s.best_f[0, 0] = 1.0
    s.best_i[0] = torch.tensor([feature, 4, 0, 1], dtype=torch.int32, device=dev)
    other = s.clone()
    partition_kernel.pick_partition(s)
    _plain_pick_partition(other)
    _same_state(s, other, feature)
    assert 0 < int(s.ctl[gs.LEFT]) < N


def test_pick_partition_refuses_a_grid_that_does_not_fit(dev):
    s, _ = _picking_leaf_2(dev, 1000, 0, 1000, 0, 4, 0, 1)
    with pytest.raises(ValueError):
        _launch_with_grid(s, partition_kernel.co_resident_grid(dev) + 1)


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_histogram_segment_matches_histogram(dev, dtype, grouped):
    """The segment entry, its rows and leaf read from device memory, against
    ``histogram`` given the same rows from the host: exact on dyadic values,
    within the two-order bound of the plain version on real ones; in both
    forms (``grouped``)."""
    N = 1_000_000
    bins, nf, grad, hess, meta, mask = _loop_inputs(dev, N, seed=3)
    dy = leaf_values(grad, hess, torch.ones(N, device=dev))
    gen = torch.Generator(device=dev).manual_seed(9)
    real = leaf_values(torch.randn(N, generator=gen, device=dev),
                       torch.rand(N, generator=gen, device=dev), torch.ones(N, device=dev))
    order = torch.randperm(N, generator=gen, device=dev).int()
    for vals, exact in ((dy, True), (real, False)):
        s = gs.GrowState(dev, N, 28, 255, 4)
        s.bind(bins, nf.t(), vals, meta, mask, LOOP_PARAMS, True, -1, dtype, grouped)
        s.reset()
        s.order.copy_(order)
        s.ctl[gs.SMALL] = 1
        for begin, count in ((0, 0), (5, 1), (100, 1023), (100, 1025), (7, 5000),
                             (1000, 100_000), (0, N // 2), (0, N)):
            s.leaf_begin[1], s.leaf_count[1] = begin, count
            hist_kernel.histogram_segment(s)
            rows = order[begin:begin + count].contiguous()
            if exact:
                want = hist_kernel.histogram(nf.t(), vals, 255, rows, dtype, grouped=grouped)
                assert torch.equal(s.small[0], want), (begin, count)
            else:
                want = leaf_histogram(bins, vals, 255, rows, dtype)
                bound = want[..., 2:] * 2.0 ** -23 * leaf_histogram(bins, vals.abs(), 255, rows, dtype)
                assert bool(((s.small[0] - want).abs() <= bound + 1e-6).all()), (begin, count)
            s.small[0].zero_()


def test_split_pair_step_matches_find_best_split_pair(dev):
    """The device-indexed entry (leaves, sums, windows and depth read from
    the loop's state) against the entry that takes them from the host:
    every field exact; the depth gate sets the gain alone to -inf; a stopped
    loop changes nothing and leaves the tickets at 0."""
    hist, sums, cons, meta, fmask = _split_inputs(dev, F=28, B=255, seed=8)
    s = gs.GrowState(dev, 64, 28, 255, 8)
    dummy = torch.zeros((28, 64), dtype=torch.uint8, device=dev)

    def bind(params, two_way, max_depth):
        s.bind(dummy, dummy, torch.zeros((64, 3), device=dev), meta, fmask, params, two_way,
               max_depth, "float32")

    bind(SPLIT_PARAMS[0], True, -1)
    s.reset()
    s.hist[5], s.hist[2] = hist[0], hist[1]
    s.laux[[5, 2]] = torch.cat([sums, cons], 1)
    s.ctl[gs.BEST], s.ctl[gs.NEW] = 5, 2
    for params in SPLIT_PARAMS:
        for two_way in (True, False):
            bind(params, two_way, -1)
            for C, leaves in ((2, (5, 2)), (1, (5,))):
                split_kernel.split_pair_step(s, C)
                want = split_kernel.find_best_split_pair(
                    s.hist, sums[:C].contiguous(), cons[:C].contiguous(), meta, fmask, params,
                    two_way, leaves)
                _same_split((s.best_f[list(leaves)], s.best_i[list(leaves)],
                             s.best_b[list(leaves)]), want)
    bind(SPLIT_PARAMS[0], True, 3)
    s.leaf_i[[5, 2], 1] = 3
    split_kernel.split_pair_step(s, 2)
    wf, wi, _ = split_kernel.find_best_split_pair(s.hist, sums, cons, meta, fmask,
                                                  SPLIT_PARAMS[0], True, (5, 2))
    assert bool(torch.isneginf(s.best_f[[5, 2], 0]).all())
    assert torch.equal(s.best_f[[5, 2], 1:], wf[:, 1:]) and torch.equal(s.best_i[[5, 2]], wi)
    s.ctl[gs.ACTIVE] = 0
    s.best_f.zero_()
    before = s.clone()
    split_kernel.split_pair_step(s, 2)
    torch.cuda.synchronize()
    _same_state(s, before, "stopped")
    assert not bool(split_kernel._ticket_counter(dev).any())


def test_split_loop_makes_no_sync(dev):
    """From the root to the readback the loop queues its kernels and reads
    nothing back: no synchronizing call under sync debug mode "error"."""
    N = 200_000
    bins, nf, grad, hess, meta, mask = _loop_inputs(dev, N, seed=6, real=True)
    s = gs.GrowState(dev, N, 28, 255, 255)
    args = (bins, grad, hess, mask, meta, -1, LOOP_PARAMS, True, nf)
    grow_mod.launch_tree(s, *args)  # builds and loads the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grow_mod.launch_tree(s, *args)
        leaf_id = grow_mod.leaf_ids(s)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    tree = grow_mod.read_tree(s)
    assert int(tree.num_leaves) == 255
    assert torch.equal(torch.bincount(leaf_id, minlength=255).cpu().float(), tree.leaf_count)


# ---- the captured iteration and chunked boosting (ops/cuda_graph.py, models/gbdt.py)


def test_leaf_ids_kernel_matches_plain(dev):
    """csrc/grow_step.cu's leaf_ids against its plain version: a 255-leaf
    tree at 100k rows, a tree stopped at the root, and a tile-crossing
    layout of many small leaves."""
    N = 100_000
    bins, nf, grad, hess, meta, mask = _loop_inputs(dev, N, seed=12)
    s = gs.GrowState(dev, N, 28, 255, 255)
    args = (bins, grad, hess, mask, meta, -1, LOOP_PARAMS, True, nf)
    grow_mod.launch_tree(s, *args)
    assert torch.equal(grow_step_kernel.leaf_ids(s), grow_step_plain.leaf_ids(s))
    stopped = LOOP_PARAMS._replace(min_data_in_leaf=N)
    grow_mod.launch_tree(s, *args[:6], stopped, *args[7:])
    assert int(s.ctl[gs.NUM_LEAVES]) == 1
    assert not grow_step_kernel.leaf_ids(s).any()
    counts = torch.tensor([4095, 1, 4097, 0, 3, 70_000] + [0] * 249, dtype=torch.int32, device=dev)
    counts[-1] = N - int(counts.sum())
    s.leaf_count.copy_(counts)
    s.leaf_begin.copy_(torch.cumsum(counts.flip(0), 0).flip(0) - counts)  # reversed layout
    s.order.copy_(torch.randperm(N, device=dev).int())
    s.ctl[gs.NUM_LEAVES] = 255
    got = grow_step_kernel.leaf_ids(s)
    assert torch.equal(got, grow_step_plain.leaf_ids(s))
    assert torch.equal(torch.bincount(got, minlength=255).int(), counts)


def test_leaf_ids_and_score_update_match_plain_at_1m(dev):
    """At 1M rows: leaf_ids equals its plain version, and the fused score
    update equals ``score.add_(value[leaf_ids])`` bit for bit on real
    values, on a 255-leaf tree grown on real gradients and on a layout of
    many small and empty leaves, the segments in reverse order."""
    N = 1_000_000
    bins, nf, grad, hess, meta, mask = _loop_inputs(dev, N, seed=15, real=True)
    s = gs.GrowState(dev, N, 28, 255, 255)
    grow_mod.launch_tree(s, bins, grad, hess, mask, meta, -1, LOOP_PARAMS, True, nf)
    assert int(s.ctl[gs.NUM_LEAVES]) == 255
    gen = torch.Generator(device=dev).manual_seed(16)
    for layout in ("grown", "small_leaves"):
        if layout == "small_leaves":
            counts = torch.randint(0, 5, (255,), generator=gen, device=dev, dtype=torch.int32)
            counts[::7] = 0
            counts[-1] = N - int(counts[:-1].sum())
            s.leaf_count.copy_(counts)
            s.leaf_begin.copy_(torch.cumsum(counts.flip(0), 0).flip(0) - counts)
        want_leaf = grow_step_plain.leaf_ids(s)
        assert torch.equal(grow_step_kernel.leaf_ids(s), want_leaf), layout
        value = torch.randn(255, generator=gen, device=dev)
        score = torch.randn(N, generator=gen, device=dev) * 3
        want = score.clone().add_(value[want_leaf])
        grow_step_kernel.score_update(s, value, score)
        assert torch.equal(score, want), layout


def test_score_update_over_256_leaves(dev):
    """More than 256 leaves: the score update keeps each row's leaf as an
    int32 between its two launches; the scores equal the plain version's
    bit for bit on real values."""
    N, M = 100_003, 300
    gen = torch.Generator(device=dev).manual_seed(18)
    s = gs.GrowState(dev, N, 1, 4, M)
    assert s.leaf_scratch.dtype == torch.int32
    counts = torch.randint(0, 600, (M,), generator=gen, device=dev, dtype=torch.int32)
    counts[-1] = N - int(counts[:-1].sum())
    s.leaf_count.copy_(counts)
    s.leaf_begin.copy_(torch.cumsum(counts, 0) - counts)
    s.order.copy_(torch.randperm(N, generator=gen, device=dev).int())
    s.ctl[gs.NUM_LEAVES] = M
    value = torch.randn(M, generator=gen, device=dev)
    score = torch.randn(N, generator=gen, device=dev)
    want = score.clone().add_(value[grow_step_plain.leaf_ids(s)])
    grow_step_kernel.score_update(s, value, score)
    assert torch.equal(score, want)
    assert torch.equal(grow_step_kernel.leaf_ids(s), grow_step_plain.leaf_ids(s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_captured_tree_equals_eager_launch_tree(dev, dtype):
    """Dyadic gradients: one replay of the captured tree (root, 254 steps,
    leaf ids) grows the eager launch_tree's tree and leaf index bit for
    bit, and the wrappers' launch counts move as much as in the eager
    run."""
    N = 100_000
    bins, nf, grad, hess, meta, mask = _loop_inputs(dev, N, seed=13)
    args = (bins, grad, hess, mask, meta, -1, LOOP_PARAMS, True, nf, dtype)
    s = gs.GrowState(dev, N, 28, 255, 255)

    def tree():
        grow_mod.launch_tree(s, *args)
        return grow_mod.leaf_ids(s)

    before = cuda_graph.launch_counts()
    want_leaf = tree()
    want = grow_mod.read_tree(s)
    mid = cuda_graph.launch_counts()
    graph = cuda_graph.Graph(tree, dev)
    assert cuda_graph.launch_counts() == mid  # a capture launches nothing
    s.packed.zero_()
    graph.out.zero_()
    graph.replay()
    got = grow_mod.read_tree(s)
    after = cuda_graph.launch_counts()
    for name in TreeArrays._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(graph.out, want_leaf)
    assert int(got.num_leaves) == 255
    eager = {k: v - before[k] for k, v in mid.items() if v != before[k]}
    replay = {k: v - mid[k] for k, v in after.items() if v != mid[k]}
    assert eager == replay == graph.launches, (eager, replay)
    segment = "histogram_segment_bf16" if dtype == "bfloat16" else "histogram_segment"
    assert replay["pick_partition"] == replay[segment] == replay["split_pair_fold"] == 254, replay
    assert "grow_step" not in replay and "partition" not in replay, replay
    assert replay["split_pair_step"] == 1 and replay["leaf_ids"] == 1, replay


def test_captured_tree_at_1m_equals_eager_and_host_loop(dev):
    """Dyadic gradients at 1M rows: one replay of the captured tree (three
    launches a step) grows the eager launch_tree's tree and leaf index, and
    the host loop's, bit for bit."""
    N = 1_000_000
    bins, nf, grad, hess, meta, mask = _loop_inputs(dev, N, seed=14)
    s = gs.GrowState(dev, N, 28, 255, 255)
    args = (bins, grad, hess, mask, meta, -1, LOOP_PARAMS, True, nf)

    def tree():
        grow_mod.launch_tree(s, *args)
        return grow_mod.leaf_ids(s)

    want_leaf = tree()
    want = grow_mod.read_tree(s)
    graph = cuda_graph.Graph(tree, dev)
    s.packed.zero_()
    graph.out.zero_()
    graph.replay()
    got = grow_mod.read_tree(s)
    host, host_leaf = grow_tree(bins, grad, hess, mask, meta, 255, -1, 255, LOOP_PARAMS, True,
                                bins_nf=nf)
    for name in TreeArrays._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert torch.equal(getattr(host, name), getattr(want, name)), name
    assert torch.equal(graph.out, want_leaf) and torch.equal(host_leaf, want_leaf)
    assert int(got.num_leaves) == 255
    assert graph.launches["split_pair_fold"] == 254 and "hist_subtract" not in graph.launches


def test_capture_on_a_stream_that_cannot_capture_raises(dev):
    """The legacy default stream cannot capture: the capture raises, and the
    launch counts are left as they were."""
    before = cuda_graph.launch_counts()
    with pytest.raises(RuntimeError):
        cuda_graph.Graph(lambda: torch.ones(4, device=dev) * 2, dev, stream=torch.cuda.default_stream(dev))
    assert cuda_graph.launch_counts() == before


def _dyadic_boosters(monkeypatch, dev, **extra):
    """A binary booster factory on make_higgs_like rows whose gradients and
    hessians are rounded to multiples of 2^-7 (hessians at least 2^-7), so
    that every histogram sum at 100k rows is exact and training is the same
    bit for bit whatever the kernels' summation order; ``extra`` params
    join the booster's."""
    from helpers.bench_data import make_higgs_like

    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch import objective as obj_mod

    get = obj_mod.BinaryLogloss.get_gradients
    q = 128.0

    def dyadic(self, score):
        g, h = get(self, score)
        return torch.round(g * q) / q, torch.clamp(torch.round(h * q), min=1.0) / q

    monkeypatch.setattr(obj_mod.BinaryLogloss, "get_gradients", dyadic)
    X, y = make_higgs_like(100_000, 28, seed=4)
    ds = tlgb.Dataset(X, label=y)
    params = {"objective": "binary", "num_leaves": 63, "max_bin": 255, "learning_rate": 0.1,
              "verbose": -1, **extra}

    def booster(chunk=1, graph=True):
        b = tlgb.Booster(dict(params, device_chunk_size=chunk), ds, device="cuda")
        b._gbdt.iteration_graph = graph
        return b
    return booster, X


def _trees_text(b):
    return b.model_to_string().split("parameters:")[0]


def test_chunk_4_equals_chunk_1_and_eager(monkeypatch, dev):
    """Dyadic-gradient training: chunk 4 (replays), chunk 1 (a replay an
    iteration) and the eager device loop give the same model text and the
    same train scores bit for bit, through ``train``'s chunk stepping."""
    from lightgbm_tpu_torch.engine import train

    booster, X = _dyadic_boosters(monkeypatch, dev)
    runs = {}
    for name, chunk, graph in (("eager", 1, False), ("graph", 1, True), ("chunk", 4, True)):
        b = booster(chunk, graph)
        steps = 0
        while steps < 9:  # train()'s loop: 1, then 4 and 4 (chunk), or 1 at a time
            ran, _ = b.update_chunk(b._gbdt.device_chunk() if steps else 1)
            steps += ran
        runs[name] = b
    assert runs["chunk"]._gbdt.device_chunk_fallback_reason() is None
    ref = runs["eager"]
    for name, b in runs.items():
        assert b.num_trees() == 9, name
        assert _trees_text(b) == _trees_text(ref), name
        assert b._gbdt.train_score().tobytes() == ref._gbdt.train_score().tobytes(), name
    np.testing.assert_allclose(ref.predict(X, raw_score=True), ref._gbdt.train_score(),
                               rtol=1e-5, atol=1e-5)
    assert train({"objective": "binary", "verbose": -1, "device_chunk_size": 4},
                 ref.train_set, 5, device="cuda").num_trees() == 5


def test_chunk_makes_no_sync_and_one_readback(monkeypatch, dev):
    """A whole train_chunk(4), the capture already made, runs under sync
    debug mode "error": n replays and one copy into pinned memory, waited
    for on an event."""
    booster, _ = _dyadic_boosters(monkeypatch, dev)
    b = booster(4)
    b.update()
    b.update_chunk(4)  # captures the iteration
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ran, stopped = b.update_chunk(4)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (ran, stopped) == (4, False) and b.num_trees() == 9


BOOSTING_MODES = {
    "goss": {"boosting": "goss", "learning_rate": 0.25},  # sampled from iteration 4 on
    "dart": {"boosting": "dart", "skip_drop": 0.0, "drop_rate": 0.3},
    "rf": {"boosting": "rf", "bagging_fraction": 0.8, "bagging_freq": 1},
}


@pytest.mark.parametrize("mode", sorted(BOOSTING_MODES))
def test_boosting_mode_replay_equals_eager(monkeypatch, dev, mode):
    """GOSS (its sample inside the captured iteration: amplification 8 at
    100k rows keeps every sum exact), DART (drops and rescales between
    replays) and random forest (constant gradients, leaves plus the init
    score): a replay an iteration gives the eager launches' model text and
    train scores bit for bit on dyadic gradients."""
    booster, X = _dyadic_boosters(monkeypatch, dev, **BOOSTING_MODES[mode])
    runs = {}
    for graph in (False, True):
        b = booster(1, graph)
        for _ in range(8):
            assert not b.update()
        runs[graph] = b
    assert runs[True]._gbdt.captures == (2 if mode == "goss" else 1)
    assert _trees_text(runs[True]) == _trees_text(runs[False])
    assert runs[True]._gbdt.train_score().tobytes() == runs[False]._gbdt.train_score().tobytes()
    np.testing.assert_allclose(runs[True].predict(X, raw_score=True), runs[True]._gbdt.train_score(),
                               rtol=1e-5, atol=1e-5)


# ---- the bin-space predict kernel, the bag, validation sets (models/gbdt.py)


@pytest.mark.parametrize("Nv", [1, 255, 500_001])
def test_predict_bins_kernel_matches_plain(dev, Nv):
    """csrc/predict_bins.cu against its plain version on a 255-leaf tree of
    the split loop (missing types none / zero / nan by feature): the same
    leaf for every row and the same f32 score bit for bit, on other rows
    and on the training rows, where the leaf is the loop's own leaf_ids; a
    stump adds its one value to every row."""
    from lightgbm_tpu_torch.ops import predict as predict_plain
    from lightgbm_tpu_torch.ops import predict_kernel

    N = 100_000
    bins, nf, grad, hess, meta, mask = _loop_inputs(dev, N, seed=21)
    s = gs.GrowState(dev, N, 28, 255, 255)
    grow_mod.launch_tree(s, bins, grad, hess, mask, meta, -1, LOOP_PARAMS, True, nf)
    nodes, nl = s.node_i[:254], s.ctl[gs.NUM_LEAVES:gs.NUM_LEAVES + 1]
    assert int(nl) == 255
    value = torch.randn(255, device=dev)
    gen = torch.Generator(device=dev).manual_seed(Nv)
    other = (torch.rand((Nv, 28), generator=gen, device=dev) * meta["num_bin"]).to(torch.uint8)
    for rows in (other, nf):
        n = rows.shape[0]
        start = torch.randn(n, generator=gen, device=dev)
        got, want = start.clone(), start.clone()
        got_leaf = torch.empty(n, dtype=torch.int32, device=dev)
        want_leaf = torch.empty(n, dtype=torch.int32, device=dev)
        before = predict_kernel.launches["predict_bins"]
        predict_kernel.add_tree_value(rows, nodes, nl, meta, value, got, got_leaf)
        assert predict_kernel.launches["predict_bins"] == before + 1
        predict_plain.add_tree_value(rows, nodes, nl, meta, value, want, want_leaf)
        assert torch.equal(got_leaf, want_leaf) and torch.equal(got, want)
        assert torch.equal(got, start + value[want_leaf.long()])
    assert torch.equal(got_leaf.long(), grow_step_kernel.leaf_ids(s))
    stump = torch.zeros(1, dtype=torch.int32, device=dev) + 1
    score = torch.zeros(Nv, device=dev)
    predict_kernel.add_tree_value(other, nodes, stump, meta, value, score)
    assert torch.equal(score, value[0].expand(Nv))


def test_predict_bins_refuses_what_it_does_not_take(dev):
    from lightgbm_tpu_torch.ops import predict_kernel

    rows = torch.zeros((10, 28), dtype=torch.uint8, device=dev)
    meta = {k: torch.zeros(28, dtype=torch.int32, device=dev)
            for k in ("num_bin", "missing_type", "default_bin")}
    nl = torch.ones(1, dtype=torch.int32, device=dev)
    ok = (torch.zeros((3, 5), dtype=torch.int32, device=dev), nl, meta,
          torch.zeros(4, device=dev), torch.zeros(10, device=dev))
    predict_kernel.add_tree_value(rows, *ok)
    with pytest.raises(ValueError, match="bins"):
        predict_kernel.add_tree_value(rows.t(), *ok)
    with pytest.raises(ValueError, match="value"):
        predict_kernel.add_tree_value(rows, ok[0], nl, meta, torch.zeros(3, device=dev), ok[4])
    with pytest.raises(ValueError, match="score"):
        predict_kernel.add_tree_value(rows, *ok[:4], torch.zeros(10, device=dev, dtype=torch.float64))


def test_bag_on_the_card_equals_the_cpu(dev):
    from lightgbm_tpu_torch.models.gbdt import draw_bag

    for seed, it, n, frac in ((3, 0, 1_000_000, 0.8), (7, 12345, 100_003, 0.37), (0, 2 ** 31, 17, 0.5)):
        cnt = int(frac * n)
        got = draw_bag(seed, it, n, cnt, dev)
        assert torch.equal(got.cpu(), draw_bag(seed, it, n, cnt, "cpu")), (seed, it, n)
        assert int(got.sum()) == cnt


def test_graph_with_valid_bag_and_feature_mask_equals_eager(monkeypatch, dev):
    """Dyadic-gradient training with bagging, feature_fraction and a
    validation set: the eager launches, a replay an iteration and chunks of
    4 give the same model text, train scores and validation scores bit for
    bit; the validation score equals the plain per-tree adds."""
    from lightgbm_tpu_torch.ops import predict as predict_plain

    booster, X = _dyadic_boosters(monkeypatch, dev, bagging_fraction=0.8, bagging_freq=1,
                                  feature_fraction=0.8)
    import lightgbm_tpu_torch as tlgb

    Xv = X[:20_000] * 1.5
    runs = {}
    for name, chunk, graph in (("eager", 1, False), ("graph", 1, True), ("chunk", 4, True)):
        b = booster(chunk, graph)
        b.add_valid(tlgb.Dataset(Xv), "v")
        steps = 0
        while steps < 9:
            ran, _ = b.update_chunk(b._gbdt.device_chunk() if steps else 1)
            steps += ran
        runs[name] = b
    ref = runs["eager"]
    g = ref._gbdt
    for name, b in runs.items():
        assert _trees_text(b) == _trees_text(ref), name
        assert b._gbdt.train_score().tobytes() == g.train_score().tobytes(), name
        assert b._gbdt._valid_score_np(0).tobytes() == g._valid_score_np(0).tobytes(), name
    assert runs["graph"]._gbdt.captures == runs["chunk"]._gbdt.captures == 1
    want = torch.zeros(len(Xv), device=dev) + np.float32(g._init_fold[0])
    for ta in g._tree_arrays:
        ptree = predict_plain.make_predict_tree(ta, g.feature_meta)
        want += ptree.leaf_value.to(dev)[predict_plain.tree_predict_leaf(g._valid_bins[0], ptree)]
    assert want.double().cpu().numpy().tobytes() == g._valid_score_np(0).tobytes()


def test_learning_rate_schedule_replays_one_graph(monkeypatch, dev):
    booster, _ = _dyadic_boosters(monkeypatch, dev)
    runs = []
    for graph in (True, False):
        b = booster(1, graph)
        for rate in (0.1, 0.2, 0.05, 0.3):
            b.reset_parameter({"learning_rate": rate})
            b.update()
        runs.append(b)
    assert runs[0]._gbdt.captures == 1
    assert _trees_text(runs[0]) == _trees_text(runs[1])
    assert runs[0]._gbdt.train_score().tobytes() == runs[1]._gbdt.train_score().tobytes()


# ---- K trees an iteration (multiclass) ------------------------------------------


def test_score_update_into_a_class_row(dev):
    """score_update into row k of [K, N] scores (the multiclass iteration's
    ``scores[k]``) equals the plain version bit for bit on real values and
    leaves the other rows untouched."""
    N, K = 100_000, 7
    bins, nf, grad, hess, meta, mask = _loop_inputs(dev, N, seed=31, real=True)
    s = gs.GrowState(dev, N, 28, 255, 255)
    gen = torch.Generator(device=dev).manual_seed(32)
    scores = torch.randn((K, N), generator=gen, device=dev)
    want = scores.clone()
    for k in range(K):
        grow_mod.launch_tree(s, bins, grad * (k + 1), hess, mask, meta, -1, LOOP_PARAMS, True, nf)
        value = torch.randn(255, generator=gen, device=dev)
        before = scores.clone()
        grow_step_kernel.score_update(s, value, scores[k])
        grow_step_plain.score_update(s, value, want[k])
        assert torch.equal(scores, want), k
        others = [j for j in range(K) if j != k]
        assert torch.equal(scores[others], before[others]), k


def test_predict_bins_per_class(dev):
    """predict_bins adds each class's tree into its row of a [K, Nv]
    validation score: equal to the plain version, the other rows untouched."""
    from lightgbm_tpu_torch.ops import predict as predict_plain
    from lightgbm_tpu_torch.ops import predict_kernel

    N, Nv, K = 100_000, 50_001, 7
    bins, nf, grad, hess, meta, mask = _loop_inputs(dev, N, seed=33)
    s = gs.GrowState(dev, N, 28, 255, 255)
    gen = torch.Generator(device=dev).manual_seed(34)
    rows = (torch.rand((Nv, 28), generator=gen, device=dev) * meta["num_bin"]).to(torch.uint8)
    got = torch.randn((K, Nv), generator=gen, device=dev)
    want = got.clone()
    for k in range(K):
        grow_mod.launch_tree(s, bins, grad * (k + 1), hess, mask, meta, -1, LOOP_PARAMS, True, nf)
        nodes, nl = s.node_i[:254], s.ctl[gs.NUM_LEAVES:gs.NUM_LEAVES + 1]
        value = torch.randn(255, generator=gen, device=dev)
        before = got.clone()
        predict_kernel.add_tree_value(rows, nodes, nl, meta, value, got[k])
        predict_plain.add_tree_value(rows, nodes, nl, meta, value, want[k])
        assert torch.equal(got, want), k
        others = [j for j in range(K) if j != k]
        assert torch.equal(got[others], before[others]), k


def test_multiclass_graph_chunk_and_eager_equal(monkeypatch, dev):
    """Multiclass (K = 4) training with gradients and hessians rounded to
    multiples of 2^-10 at 16,000 rows (every |g| < 1 and h <= 1/2, so every
    histogram sum is exact whatever the kernels' order), with bagging,
    feature_fraction and a validation set: the eager launches, a replay an
    iteration (K trees a replay) and chunks of 4 give the same model text,
    train scores and validation scores bit for bit; each class's
    validation score equals the plain per-tree adds."""
    from helpers.bench_data import make_higgs_like

    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch import objective as obj_mod
    from lightgbm_tpu_torch.ops import predict as predict_plain

    get = obj_mod.MulticlassSoftmax.get_gradients
    q = 1024.0

    def dyadic(self, score):
        g, h = get(self, score)
        return torch.round(g * q) / q, torch.clamp(torch.round(h * q), min=1.0) / q

    monkeypatch.setattr(obj_mod.MulticlassSoftmax, "get_gradients", dyadic)
    K = 4
    X, _ = make_higgs_like(20_000, 28, seed=5)
    y = (np.digitize(X[:, 0] + X[:, 3], [-1.0, 0.0, 1.0])).astype(float)
    ds = tlgb.Dataset(X[:16_000], label=y[:16_000])
    params = {"objective": "multiclass", "num_class": K, "num_leaves": 31, "learning_rate": 0.2,
              "verbose": -1, "bagging_fraction": 0.8, "bagging_freq": 1, "feature_fraction": 0.8}
    runs = {}
    for name, chunk, graph in (("eager", 1, False), ("graph", 1, True), ("chunk", 4, True)):
        b = tlgb.Booster(dict(params, device_chunk_size=chunk), ds, device="cuda")
        b._gbdt.iteration_graph = graph
        b.add_valid(tlgb.Dataset(X[16_000:], label=y[16_000:]), "v")
        steps = 0
        while steps < 9:
            ran, _ = b.update_chunk(b._gbdt.device_chunk() if steps else 1)
            steps += ran
        runs[name] = b
    ref = runs["eager"]
    g = ref._gbdt
    assert g.grow_loop == "device" and ref.num_trees() == 9 * K
    for name, b in runs.items():
        assert _trees_text(b) == _trees_text(ref), name
        assert b._gbdt.train_score().tobytes() == g.train_score().tobytes(), name
        assert b._gbdt._valid_score_np(0).tobytes() == g._valid_score_np(0).tobytes(), name
    assert runs["graph"]._gbdt.captures == runs["chunk"]._gbdt.captures == 1
    want = torch.zeros((K, 4000), device=dev)
    for k in range(K):
        want[k] += np.float32(g._init_fold[k])
    for i, ta in enumerate(g._tree_arrays):
        ptree = predict_plain.make_predict_tree(ta, g.feature_meta)
        want[i % K] += ptree.leaf_value.to(dev)[predict_plain.tree_predict_leaf(g._valid_bins[0], ptree)]
    assert want.double().cpu().numpy().tobytes() == g._valid_score_np(0).tobytes()
    assert ref.predict(X[16_000:]).shape == (4000, K)


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("F", [8, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_histogram_few_bins_matches_plain(dev, F, dtype, grouped):
    """Features of 2 and 3 bins, mostly bin 0 (one-hot columns: in the
    grouped form their adds are grouped by bin within a warp), beside
    255-bin ones, in the [N, F] copy's word layout (F = 8) and the byte
    layout (F = 6), in both forms: the root, segments given by rows and the
    segment entry's segments equal the plain version bit for bit on dyadic
    values and lie within the two-order bound on real ones. The table is
    one that ``grouped_adds`` sends to the grouped form."""
    N, B = 300_001, 255
    gen = torch.Generator(device=dev).manual_seed(F)
    u = torch.rand((F, N), generator=gen, device=dev)
    bins = (u * B).to(torch.uint8)
    bins[0] = (u[0] > 0.97).to(torch.uint8)  # a sparse one-hot column
    bins[1] = (u[1] > 0.7).to(torch.uint8)
    bins[2] = torch.bucketize(u[2], torch.tensor([0.8, 0.95], device=dev)).to(torch.uint8)
    assert hist_kernel.grouped_adds(bins.cpu().numpy())
    nf = bins.t().contiguous()
    q = 1024
    dyadic = leaf_values(
        torch.randint(-q, q + 1, (N,), generator=gen, device=dev).float() / q,
        torch.randint(1, 17, (N,), generator=gen, device=dev).float() / q,
        torch.ones(N, device=dev))
    real = leaf_values(torch.randn(N, generator=gen, device=dev),
                       torch.rand(N, generator=gen, device=dev), torch.ones(N, device=dev))
    meta = {k: torch.zeros(F, dtype=torch.int32, device=dev)
            for k in ("missing_type", "default_bin", "monotone")}
    meta["num_bin"] = torch.full((F,), B, dtype=torch.int32, device=dev)
    mask = torch.ones(F, dtype=torch.bool, device=dev)
    order = torch.randperm(N, generator=gen, device=dev).int()
    segments = ((0, N), (11, 40_000), (3, 999))
    for vals in (dyadic, real):
        s = gs.GrowState(dev, N, F, B, 4)
        s.bind(bins, nf.t(), vals, meta, mask, LOOP_PARAMS, True, -1, dtype, grouped)
        s.reset()
        s.order.copy_(order)
        s.ctl[gs.SMALL] = 1
        for begin, count in segments:
            s.leaf_begin[1], s.leaf_count[1] = begin, count
            s.small[0].zero_()
            hist_kernel.histogram_segment(s)
            rows = order[begin:begin + count]
            for got, rows_ in ((s.small[0], rows), (hist_kernel.histogram(
                    nf.t(), vals, B, rows.contiguous(), dtype, grouped=grouped), rows)):
                want = leaf_histogram(bins, vals, B, rows_, dtype)
                if vals is dyadic:
                    assert torch.equal(got, want), (begin, count)
                else:
                    bound = leaf_histogram(bins, real.abs(), B, rows_, dtype)
                    assert bool(((got - want).abs() <= bound[..., 2:] * 2.0 ** -23 * bound + 1e-6).all())
    for rows in (None, torch.sort(torch.randperm(N, generator=gen, device=dev)[:40_000]).values.int(),
                 torch.arange(0, N, 7, device=dev, dtype=torch.int32)[:999]):
        got = hist_kernel.histogram(nf.t(), dyadic, B, rows, dtype, grouped=grouped)
        assert torch.equal(got, leaf_histogram(bins, dyadic, B, rows, dtype))
        got = hist_kernel.histogram(nf.t(), real, B, rows, dtype, grouped=grouped)
        want = leaf_histogram(bins, real, B, rows, dtype)
        bound = leaf_histogram(bins, real.abs(), B, rows, dtype)
        assert bool(((got - want).abs() <= bound[..., 2:] * 2.0 ** -23 * bound + 1e-6).all())


# ---- categorical features: the kernels' categorical instantiations -----------------

CAT_PARAMS = [
    LOOP_PARAMS,  # the reference's categorical defaults
    SplitParams(0.0, 1.0, 0.0, 5, 1e-3, 0.0, max_cat_to_onehot=8, cat_smooth=2.0, cat_l2=1.0,
                max_cat_threshold=6, min_data_per_group=10),
    SplitParams(0.5, 0.0, 0.3, 10, 0.5, 0.1, max_cat_to_onehot=4, cat_smooth=20.0, cat_l2=0.0,
                max_cat_threshold=64, min_data_per_group=200),
]


def _cat_loop_inputs(dev, N, seed=0, q=64):
    """:func:`_loop_inputs` at F = 12, B = 255 with features 8-11
    categorical: 4 categories (the one-hot branch), 40, 200 (the
    max_cat_threshold cap) and 255, skewed to the low categories, the
    gradients following each row's category so that categorical splits
    win. Multiples of 1/64 keep every histogram cell exact at 200k rows
    (a cell's sum below 2^18)."""
    bins, _, grad, hess, meta, mask = _loop_inputs(dev, N, F=12, seed=seed, q=q)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    for f, nb in ((8, 4), (9, 40), (10, 200), (11, 255)):
        meta["num_bin"][f] = nb
        bins[f] = (torch.rand(N, generator=gen, device=dev) ** 2 * nb).to(torch.uint8)
        effect = torch.randint(-4, 5, (nb,), generator=gen, device=dev).float() / 8
        grad = grad + effect[bins[f].long()]
    meta["is_categorical"] = torch.arange(12, device=dev) >= 8
    return bins, bins.t().contiguous(), grad, hess, meta, mask


@pytest.mark.parametrize("params", range(len(CAT_PARAMS)))
def test_split_kernel_categorical_matches_plain(dev, params):
    """Both children's scan through the host-called entry, categorical
    features among numerical ones (missing types none / zero / nan), dyadic
    histograms: every field and the membership words equal the plain
    version's; each categorical branch wins somewhere."""
    hist, sums, cons, meta, fmask = _split_inputs(dev, F=16, B=255, seed=40 + params, N=60_000)
    meta["is_categorical"] = torch.arange(16, device=dev) % 3 == 0
    for f, nb in ((0, 4), (3, 40)):  # the one-hot branch, a CTR feature: bin b folded into b % nb
        meta["num_bin"][f] = nb
        folded = torch.zeros_like(hist[:, f])
        hist[:, f] = folded.index_add_(1, torch.arange(255, device=dev) % nb, hist[:, f])
    p = CAT_PARAMS[params]
    seen = set()
    feats = torch.arange(16, device=dev)
    for mask in (fmask, feats % 3 == 0, feats == 0, feats == 3, feats % 3 != 0):
        for two_way in (True, False):
            got, want = _both(hist, sums, cons, meta, mask.contiguous(), p, two_way)
            _same_split(got, want)
            assert got[2].shape == (2, 8)
            seen.update(int(v) for v in got[1][:, 2])
    assert {0, 1} <= seen and max(seen) > 1, seen


def test_categorical_loop_kernels_match_plain_at_every_step(dev):
    """A 255-leaf tree of categorical and numerical features, one step at a
    time: after each kernel of a step the whole state (the records' and the
    nodes' membership words included) equals that of its plain version on a
    copy; the root's scan too. The tree holds one-hot and CTR nodes."""
    N = 100_000
    bins, nf, grad, hess, meta, mask = _cat_loop_inputs(dev, N, seed=3)
    s = gs.GrowState(dev, N, 12, 255, 255, W=8)
    grow_mod.start_tree(s, bins, grad, hess, mask, meta, -1, LOOP_PARAMS, True, nf)
    check = s.clone()
    split_pair_step(check, 1)  # the root's scan again, plain
    _same_state(s, check, "root")
    for step in range(254):
        p = step % 2
        pairs = (
            (partition_kernel.pick_partition, _plain_pick_partition),
            (lambda st: hist_kernel.histogram_segment(st, p), lambda st: segment_histogram(st, p)),
            (lambda st: split_kernel.split_pair_fold(st, p),
             lambda st: grow_step_plain.split_pair_fold(st, p)),
        )
        for k, (kernel, plain) in enumerate(pairs):
            other = s.clone()
            kernel(s)
            plain(other)
            _same_state(s, other, (step, k))
    tree = grow_mod.read_tree(s)
    nl = int(tree.num_leaves)
    feats = tree.split_feature[:nl - 1]
    members = tree.cat_member[:nl - 1].sum(1)
    assert bool((feats == 8).any()) and bool(((feats >= 9) & (members > 1)).any()), (feats, members)


def test_categorical_device_loop_equals_host_loop(dev):
    """Dyadic gradients: with categorical features the device loop grows the
    host loop's tree (cat_member included) and leaf index bit for bit."""
    bins, nf, grad, hess, meta, mask = _cat_loop_inputs(dev, 200_000, seed=9)
    for max_depth in (-1, 6):
        args = (bins, grad, hess, mask, meta, 255, max_depth, 255, LOOP_PARAMS, True)
        want, want_leaf = grow_tree(*args, bins_nf=nf)
        got, got_leaf, _ = grow_tree_device(*args, bins_nf=nf)
        for name in TreeArrays._fields:
            assert torch.equal(getattr(got, name), getattr(want, name)), (name, max_depth)
        assert torch.equal(got_leaf, want_leaf)


def test_predict_bins_categorical_matches_plain(dev):
    """csrc/predict_bins.cu's categorical instantiation against its plain
    version on a 255-leaf tree with categorical nodes: the same leaf and
    the same f32 score bit for bit, on other rows and on the training rows
    (there the loop's own leaf_ids)."""
    from lightgbm_tpu_torch.ops import predict as predict_plain
    from lightgbm_tpu_torch.ops import predict_kernel

    N = 100_000
    bins, nf, grad, hess, meta, mask = _cat_loop_inputs(dev, N, seed=4)
    s = gs.GrowState(dev, N, 12, 255, 255, W=8)
    grow_mod.launch_tree(s, bins, grad, hess, mask, meta, -1, LOOP_PARAMS, True, nf)
    nodes, nl = s.node_i[:254], s.ctl[gs.NUM_LEAVES:gs.NUM_LEAVES + 1]
    assert int(nl) == 255
    cat_nodes = meta["is_categorical"][nodes[:, 0].long()]
    assert bool(cat_nodes.any()) and bool((~cat_nodes).any())
    value = torch.randn(255, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    other = (torch.rand((77_777, 12), generator=gen, device=dev) * meta["num_bin"]).to(torch.uint8)
    for rows in (other, nf):
        n = rows.shape[0]
        start = torch.randn(n, generator=gen, device=dev)
        got, want = start.clone(), start.clone()
        got_leaf = torch.empty(n, dtype=torch.int32, device=dev)
        want_leaf = torch.empty(n, dtype=torch.int32, device=dev)
        before = predict_kernel.launches["predict_bins"]
        predict_kernel.add_tree_value(rows, nodes, nl, meta, value, got, got_leaf, s.node_b)
        assert predict_kernel.launches["predict_bins"] == before + 1
        predict_plain.add_tree_value(rows, nodes, nl, meta, value, want, want_leaf, s.node_b)
        assert torch.equal(got_leaf, want_leaf) and torch.equal(got, want)
    assert torch.equal(got_leaf.long(), grow_step_kernel.leaf_ids(s))
    with pytest.raises(ValueError, match="node_b"):
        predict_kernel.add_tree_value(other, nodes, nl, meta, value, torch.zeros(77_777, device=dev))


# ---- EFB-bundled tables: the remap, and the bundled pick and predict ----------------

#: group layouts (each group a list of its members' num_bin): one group of
#: every feature (G = 1), and a mix of a 255-bin feature alone in its group,
#: a group at the 256-bin cap (255 one-hot features), a one-hot block with a
#: 20-bin feature, a 64-bin feature alone and a group of 5
EFB_LAYOUTS = {
    "one_group": [[2] * 60 + [40, 60, 90]],
    "mixed": [[255], [2] * 255, [2] * 30 + [20], [64], [2, 2, 2, 2, 5]],
    "wide": [[700], [2] * 255, [2] * 30 + [20], [64], [2, 2, 2, 2, 5]],
}


def _efb_plan(layout):
    """(gid, off, num_bin) [F] int32 numpy and the group widths of a layout."""
    gid, off, nbin, widths = [], [], [], []
    for g, members in enumerate(layout):
        o = 1
        for nb in members:
            gid.append(g), off.append(o), nbin.append(nb)
            o += nb - 1
        widths.append(o)
    return (np.asarray(gid, np.int32), np.asarray(off, np.int32), np.asarray(nbin, np.int32),
            widths)


def _efb_inputs(dev, N, layout, seed=0, categorical=False, q=1024):
    """A bundled table of ``layout``: the [G, N] group bins (each row holds
    one member of a group at a non-default sub-bin, or the all-default 0),
    their [N, G] copy, the decoded [F, N] unbundled bins, dyadic gradients
    (multiples of 1/q) that follow the one-hot members' parity and the
    20-bin feature's categories, hessians,
    the meta with its plan (missing types none, zero and nan; with
    ``categorical`` the 20-bin feature of ``mixed`` categorical) and the
    feature mask."""
    from lightgbm_tpu_torch.ops import remap

    gid, off, nbin, widths = _efb_plan(layout)
    F, G = len(gid), len(layout)
    plan_rng = np.random.RandomState(F)  # the plan's default bins: the same for every seed
    dbin = np.array([plan_rng.randint(0, nb) for nb in nbin], np.int32)
    rng = np.random.RandomState(seed)
    missing = np.zeros(F, np.int32)
    missing[nbin == 64] = 2
    dbin[nbin == 64] = 0
    missing[np.nonzero(nbin == 5)[0][:1]] = 1
    wide = max(widths) > 256  # int16 groups, as the training device holds them
    group_bins = np.zeros((G, N), np.int16 if wide else np.uint8)
    signal = np.zeros(N)
    first = 0
    for g, members in enumerate(layout):
        k = len(members)
        pick = rng.randint(0, k + 1, N)  # k: every member at its default
        for j in range(k):
            f = first + j
            rows = np.nonzero(pick == j)[0]
            sub = rng.randint(0, nbin[f], len(rows))
            keep = sub != dbin[f]
            group_bins[g, rows[keep]] = off[f] + sub[keep] - (sub[keep] > dbin[f])
            if nbin[f] == 2:
                signal[rows[keep]] += 1.0 if j % 2 else -1.0
            if nbin[f] == 20:  # the categorical candidate: every third category
                signal[rows] += np.where(sub % 3 == 0, 2.0, -1.0)
        first += k
    bins = torch.from_numpy(group_bins).to(dev)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    meta = {"num_bin": t(nbin), "missing_type": t(missing), "default_bin": t(dbin),
            "monotone": t(np.zeros(F, np.int32)), "group_id": t(gid), "bin_offset": t(off)}
    if categorical:
        is_cat = np.zeros(F, bool)
        is_cat[np.nonzero(nbin == 20)[0]] = True
        meta["is_categorical"] = t(is_cat)
    dense = torch.stack([remap.decode_col(bins[int(gid[f])], int(off[f]), int(dbin[f]),
                                          int(nbin[f])) for f in range(F)]).to(bins.dtype)
    grad = torch.from_numpy((np.round((rng.randn(N) * 0.5 + 0.25 * np.tanh(signal)) * q) / q)
                            .astype(np.float32)).to(dev)
    hess = torch.from_numpy((rng.randint(1, 65, N) / q).astype(np.float32)).to(dev)
    mask = torch.ones(F, dtype=torch.bool, device=dev)
    return bins, bins.t().contiguous(), dense, grad, hess, meta, mask, max(widths)


@pytest.mark.parametrize("values", ["dyadic", "real"])
@pytest.mark.parametrize("layout", list(EFB_LAYOUTS))
def test_efb_remap_matches_plain(dev, layout, values):
    """csrc/efb_remap.cu against ops/remap.py ``remap_hist``: equal bit for
    bit on dyadic and real values (the default row sums in one order in
    both), with G = 1, a feature alone in its group and a group at 256
    bins, and a group of 700 bins (the 1024-slot tree); its loop entries,
    and a stopped loop writes nothing."""
    from lightgbm_tpu_torch.ops import remap, remap_kernel

    gid, off, nbin, widths = _efb_plan(EFB_LAYOUTS[layout])
    F, G, Bg, B = len(gid), len(widths), max(widths), int(nbin.max())
    if layout == "mixed":
        assert Bg == 256 and widths[0] == 255
    rng = np.random.RandomState(F)
    meta = {k: torch.from_numpy(v).to(dev) for k, v in (
        ("group_id", gid), ("bin_offset", off), ("num_bin", nbin),
        ("default_bin", np.array([rng.randint(0, nb) for nb in nbin], np.int32)))}
    gh = rng.randn(G, Bg, 3)
    totals = rng.randn(3) * 50
    if values == "dyadic":
        gh, totals = np.round(gh * 64) / 64, np.round(totals * 64) / 64
    gh = torch.tensor(gh, dtype=torch.float32, device=dev)
    totals = torch.tensor(totals, dtype=torch.float32, device=dev)
    key = "efb_remap_wide" if B > 256 else "efb_remap"
    before = remap_kernel.launches[key]
    got = remap_kernel.efb_remap(gh, totals, meta, B)
    assert remap_kernel.launches[key] == before + 1
    want = remap.remap_hist(gh.cpu(), totals.cpu(), {k: v.cpu() for k, v in meta.items()}, B)
    assert got.cpu().numpy().tobytes() == want.numpy().tobytes()
    # the loop entries on a state: the step's totals from laux[ctl[SMALL]]
    s = gs.GrowState(dev, 1000, F, B, 7, 0, G, Bg)
    s.feature_meta = dict(meta)
    s.stream = torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None
    s.small_g[1].copy_(gh)
    s.laux[3, :3] = totals
    s.ctl[gs.ACTIVE], s.ctl[gs.SMALL] = 1, 3
    s.small_g[0].fill_(7.0)
    remap_kernel.remap_step(s, 1)
    assert torch.equal(s.small[1], got) and not bool(s.small_g[0].any())
    s.laux[0, :3] = totals
    s.small_g[0].fill_(7.0)
    remap_kernel.remap_root(s)
    assert torch.equal(s.hist[0], got) and not bool(s.small_g[0].any())
    s.ctl[gs.ACTIVE] = 0  # a stopped loop: nothing written
    s.small_g[0].fill_(7.0)
    s.small[1].zero_()
    remap_kernel.remap_step(s, 1)
    assert not bool(s.small[1].any()) and bool((s.small_g[0] == 7.0).all())


@pytest.mark.parametrize("categorical", [False, True])
def test_bundled_loop_kernels_match_plain_at_every_step(dev, categorical):
    """A 255-leaf tree of a bundled table (layout ``mixed``), one step at a
    time: after each kernel of a step (the bundled pick_partition, the
    segment histogram over the groups, the remap, the folded scan) the whole
    state equals that of its plain version on a copy; the root too. With
    ``categorical`` a bundled feature is categorical (the categorical and
    bundled instantiation)."""
    from lightgbm_tpu_torch.ops import remap, remap_kernel
    from lightgbm_tpu_torch.ops.split import num_words

    N = 100_000
    bins, nf, _, grad, hess, meta, mask, Bg = _efb_inputs(dev, N, EFB_LAYOUTS["mixed"], 3,
                                                          categorical)
    F, G = meta["num_bin"].numel(), bins.shape[0]
    W = num_words(255, categorical)
    s = gs.GrowState(dev, N, F, 255, 255, W, G, Bg)
    grow_mod.start_tree(s, bins, grad, hess, mask, meta, -1, LOOP_PARAMS, True, nf)
    check = s.clone()
    remap.remap_root(check)
    split_pair_step(check, 1)
    _same_state(s, check, "root")
    picked = set()
    for step in range(254):
        p = step % 2
        pairs = (
            (partition_kernel.pick_partition, _plain_pick_partition),
            (lambda st: hist_kernel.histogram_segment(st, p), lambda st: segment_histogram(st, p)),
            (lambda st: remap_kernel.remap_step(st, p), lambda st: remap.remap_step(st, p)),
            (lambda st: split_kernel.split_pair_fold(st, p),
             lambda st: grow_step_plain.split_pair_fold(st, p)),
        )
        for k, (kernel, plain) in enumerate(pairs):
            other = s.clone()
            kernel(s)
            plain(other)
            _same_state(s, other, (step, k))
        if int(s.ctl[gs.ACTIVE]):
            picked.add(int(s.node_i[step, 0]))
    gid = meta["group_id"].cpu().numpy()
    shared = {f for f in picked if (gid == gid[f]).sum() > 1}
    assert shared, picked  # splits of features that share a group
    if categorical:
        assert picked & set(np.nonzero(meta["is_categorical"].cpu().numpy())[0].tolist()), picked


def test_bundled_device_loop_equals_host_loop(dev):
    """Dyadic gradients: on a bundled table the device loop grows the host
    loop's tree and leaf index bit for bit, and both grow the tree of the
    same table unbundled (every remapped cell exact)."""
    bins, nf, dense, grad, hess, meta, mask, Bg = _efb_inputs(dev, 200_000,
                                                              EFB_LAYOUTS["mixed"], 9)
    plain_meta = {k: v for k, v in meta.items() if k not in ("group_id", "bin_offset")}
    for max_depth in (-1, 6):
        args = (grad, hess, mask, meta, 255, max_depth, 255, LOOP_PARAMS, True)
        want, want_leaf = grow_tree(bins, *args, bins_nf=nf, num_group_bins=Bg)
        got, got_leaf, _ = grow_tree_device(bins, *args, bins_nf=nf, num_group_bins=Bg)
        flat, flat_leaf = grow_tree(dense, grad, hess, mask, plain_meta, 255, max_depth, 255,
                                    LOOP_PARAMS, True, bins_nf=dense.t().contiguous())
        for name in TreeArrays._fields:
            assert torch.equal(getattr(got, name), getattr(want, name)), (name, max_depth)
            assert torch.equal(getattr(flat, name), getattr(want, name)), (name, max_depth)
        assert torch.equal(got_leaf, want_leaf) and torch.equal(flat_leaf, want_leaf)


@pytest.mark.parametrize("categorical", [False, True])
def test_predict_bins_bundled_matches_plain(dev, categorical):
    """csrc/predict_bins.cu's bundled instantiations against the plain
    traversal on a 255-leaf bundled tree: the same leaf and f32 score bit
    for bit on other rows ([N, G]) and on the training rows (there the
    loop's own leaf_ids), and the unbundled instantiation on the decoded
    [N, F] rows takes the same leaves."""
    from lightgbm_tpu_torch.ops import predict as predict_plain
    from lightgbm_tpu_torch.ops import predict_kernel
    from lightgbm_tpu_torch.ops.split import num_words

    N = 100_000
    layout = EFB_LAYOUTS["mixed"]
    bins, nf, dense, grad, hess, meta, mask, Bg = _efb_inputs(dev, N, layout, 4, categorical)
    F, G = meta["num_bin"].numel(), bins.shape[0]
    s = gs.GrowState(dev, N, F, 255, 255, num_words(255, categorical), G, Bg)
    grow_mod.launch_tree(s, bins, grad, hess, mask, meta, -1, LOOP_PARAMS, True, nf)
    nodes, nl = s.node_i[:254], s.ctl[gs.NUM_LEAVES:gs.NUM_LEAVES + 1]
    assert int(nl) == 255
    node_b = s.node_b if categorical else None
    value = torch.randn(255, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    o_bins, o_nf, o_dense = _efb_inputs(dev, 77_777, layout, 6, categorical)[:3]
    plain_meta = {k: v for k, v in meta.items() if k not in ("group_id", "bin_offset")}
    for rows, flat in ((o_nf, o_dense.t().contiguous()), (nf, dense.t().contiguous())):
        n = rows.shape[0]
        start = torch.randn(n, generator=gen, device=dev)
        got, want, flat_score = start.clone(), start.clone(), start.clone()
        got_leaf, want_leaf, flat_leaf = (torch.empty(n, dtype=torch.int32, device=dev)
                                          for _ in range(3))
        before = predict_kernel.launches["predict_bins"]
        predict_kernel.add_tree_value(rows, nodes, nl, meta, value, got, got_leaf, node_b)
        assert predict_kernel.launches["predict_bins"] == before + 1
        predict_plain.add_tree_value(rows, nodes, nl, meta, value, want, want_leaf, node_b)
        assert torch.equal(got_leaf, want_leaf) and torch.equal(got, want)
        predict_kernel.add_tree_value(flat, nodes, nl, plain_meta, value, flat_score, flat_leaf,
                                      node_b)
        assert torch.equal(flat_leaf, got_leaf) and torch.equal(flat_score, got)
    assert torch.equal(got_leaf.long(), grow_step_kernel.leaf_ids(s))


# ---- LambdaRank's lambda kernel and leaf renewal (objective.py, ops/rank_kernel.py)


def _rank_case(dev, sizes, seed=0, weighted=False):
    """A RankPlan over queries of ``sizes`` on ``dev`` (labels 0-4, about
    half 0; query 3 of one label; query 2's scores all equal) and f32
    scores."""
    from lightgbm_tpu_torch.objective import default_label_gain
    from lightgbm_tpu_torch.ops import rank as rank_plain

    rng = np.random.RandomState(seed)
    qb = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    n = int(qb[-1])
    label = rng.randint(0, 5, n) * (rng.rand(n) < 0.5)
    label[qb[3]:qb[4]] = 2
    inv = rng.uniform(0.01, 0.2, len(sizes))
    w = rng.uniform(0.5, 2.0, n).astype(np.float32) if weighted else None
    score = rng.randn(n).astype(np.float32)
    score[qb[2]:qb[3]] = 0.75
    plan = rank_plain.RankPlan(qb, label, default_label_gain(), inv, w, dev)
    return plan, torch.tensor(score, device=dev)


def _lambdas_blocked(score, plan, sigmoid, q):
    """Query ``q``'s lambdas and hessians by the plain version's f32 formula
    (ops/rank.py ``bucket_lambdas``: the same ranks, discounts and pair
    terms) in row blocks of 512 against the whole query, its sums in f64: a
    query too long for the plain version's [S, S] pair tensors."""
    lo, hi = int(plan.qb[q]), int(plan.qb[q + 1])
    s = score[lo:hi]
    lab, gain = plan.label[lo:hi], plan.gain[lo:hi]
    order = torch.argsort(-s, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(hi - lo, device=s.device)
    disc = torch.reciprocal(torch.log2(2.0 + rank.to(torch.float32)))
    spread = bool(s.max() != s.min())
    f64 = torch.float64
    g, h = torch.zeros(hi - lo, dtype=f64, device=s.device), torch.zeros(hi - lo, dtype=f64,
                                                                         device=s.device)
    for a in range(0, hi - lo, 512):
        b = min(a + 512, hi - lo)
        for side in ("ij", "ji"):  # pairs (i, j) with i high, then (j, i) with j high
            rows = slice(a, b)
            if side == "ij":
                dl = lab[rows, None] > lab[None, :]
                ds = s[rows, None] - s[None, :]
                gap = gain[rows, None] - gain[None, :]
                pd = torch.abs(disc[rows, None] - disc[None, :])
            else:
                dl = lab[None, :] > lab[rows, None]
                ds = s[None, :] - s[rows, None]
                gap = gain[None, :] - gain[rows, None]
                pd = torch.abs(disc[None, :] - disc[rows, None])
            delta = gap * pd * plan.invq[q]
            if spread:
                delta = delta / (0.01 + torch.abs(ds))
            p = 2.0 * torch.reciprocal(1.0 + torch.exp(2.0 * ds * sigmoid))
            lam = torch.where(dl, -p * delta, 0.0).sum(1, dtype=f64)
            hes = torch.where(dl, p * (2.0 - p) * 2.0 * delta, 0.0).sum(1, dtype=f64)
            g[a:b] += lam if side == "ij" else -lam
            h[a:b] += hes
    g, h = g.to(torch.float32), h.to(torch.float32)
    if plan.weight is not None:
        g, h = g * plan.weight[lo:hi], h * plan.weight[lo:hi]
    return g, h


@pytest.mark.parametrize("weighted", [False, True])
def test_lambdarank_kernel_matches_plain(dev, weighted):
    """csrc/lambdarank.cu on queries of 1 to 2,561 rows (both sides of the
    shared-memory limit) against its plain version within rtol 2e-4 / atol
    2e-6, equal bits on a relaunch, one launch counted a call; a 20,000-row
    query (global memory and the scratch) against the plain version's
    formula taken in row blocks; at equal scores (iteration 0) too."""
    from lightgbm_tpu_torch.ops import rank as rank_plain
    from lightgbm_tpu_torch.ops import rank_kernel

    sizes = [1, 2, 7, 8, 9, 20, 33, 64, 130, 1251, 2560, 2561, 5, 1]
    plan, score = _rank_case(dev, sizes, weighted=weighted)
    for s in (score, torch.zeros_like(score)):
        before = rank_kernel.launches["lambdarank"]
        g, h = rank_kernel.lambdarank(s, plan, 1.3)
        g2, h2 = rank_kernel.lambdarank(s, plan, 1.3)
        assert rank_kernel.launches["lambdarank"] == before + 2
        assert torch.equal(g, g2) and torch.equal(h, h2)
        pg, ph = rank_plain.lambdas(s, plan, 1.3)
        torch.cuda.synchronize()
        torch.testing.assert_close(g, pg, rtol=2e-4, atol=2e-6)
        torch.testing.assert_close(h, ph, rtol=2e-4, atol=2e-6)
        assert g[0] == 0 and h[-1] == 0 and (g[plan._qb_np[3]:plan._qb_np[4]] == 0).all()
    big, score = _rank_case(dev, [3, 20_000, 17, 1, 5], seed=1, weighted=weighted)
    g, h = rank_kernel.lambdarank(score, big, 0.7)
    g2, h2 = rank_kernel.lambdarank(score, big, 0.7)
    assert torch.equal(g, g2) and torch.equal(h, h2)
    for q in range(big.num_queries):
        lo, hi = big._qb_np[q], big._qb_np[q + 1]
        wg, wh = _lambdas_blocked(score, big, 0.7, q)
        torch.testing.assert_close(g[lo:hi], wg, rtol=2e-4, atol=2e-6)
        torch.testing.assert_close(h[lo:hi], wh, rtol=2e-4, atol=2e-6)


def test_lambdarank_kernel_refuses_what_it_does_not_take(dev):
    from lightgbm_tpu_torch.ops import rank_kernel

    plan, score = _rank_case(dev, [3, 4, 5, 6])
    with pytest.raises(ValueError, match="contiguous float32"):
        rank_kernel.lambdarank(score.double(), plan, 1.0)
    with pytest.raises(ValueError, match="lies on"):
        rank_kernel.lambdarank(score.cpu(), plan, 1.0)


def _grown_regression_state(dev, n=50_000, M=63, seed=0):
    """A device-loop state after one tree on ``dev`` (L1's sign gradients
    on a regression table), its rows' leaves and labels."""
    import lightgbm_tpu_torch as tlgb

    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8)
    y = 3.0 * X[:, 0] + X[:, 1] ** 2 + rng.randn(n) + 5.0
    ds = tlgb.Dataset(X, label=y).construct()._binned
    bins = torch.tensor(np.ascontiguousarray(ds.bins, dtype=np.uint8), device=dev)
    meta = ds.feature_meta_arrays()
    fm = {k: torch.as_tensor(meta[k].astype(np.int32), device=dev)
          for k in ("num_bin", "missing_type", "default_bin", "monotone")}
    g = torch.tensor(np.sign(5.0 - y), dtype=torch.float32, device=dev)
    _, leaf_id, s = grow_tree_device(
        bins, g, torch.ones(n, device=dev), torch.ones(ds.num_features, dtype=torch.bool, device=dev),
        fm, num_leaves=M, max_depth=-1, num_bins=int(ds.max_num_bin),
        params=SplitParams(0.0, 0.0, 0.0, 20, 1e-3, 0.0), two_way=False,
        bins_nf=bins.t().contiguous())
    return s, leaf_id, y


@pytest.mark.parametrize("name", ["regression_l1", "quantile", "mape"])
def test_renewal_on_the_card_equals_the_cpu(dev, name):
    """The renewal as the device loop calls it on the card (the rows'
    leaves from the leaf_ids kernel over the loop's state) equals the
    renewal from the rows' leaves on the CPU: bit for bit unweighted (L1, quantile),
    within 1e-5 where MAPE's weights go through an f32 cumsum (the card's
    scan and the CPU's double accumulator differ), with a bag."""
    from lightgbm_tpu_torch import objective as tobj
    from lightgbm_tpu_torch.config import Config as TConfig
    from lightgbm_tpu_torch.dataset import Metadata as TMetadata

    s, leaf_id, y = _grown_regression_state(dev)
    n = len(y)
    rng = np.random.RandomState(1)
    score = torch.tensor(rng.randn(n) + 5.0, dtype=torch.float32)
    bag = torch.tensor(rng.rand(n) < 0.8, dtype=torch.float32)
    params = {"objective": name, "alpha": 0.9, "verbose": -1}
    objs = {}
    for d in (dev, torch.device("cpu")):
        objs[d.type] = tobj.create_objective(TConfig.from_params(dict(params)))
        objs[d.type].init(TMetadata(n, label=y), n, d)
    old = s.leaf_f[:, 0].clone()
    card_leaf = grow_step_kernel.leaf_ids(s)
    assert torch.equal(card_leaf, leaf_id)
    got = objs["cuda"].renew_leaf_outputs(score.to(dev), card_leaf, bag.to(dev), s.M, old).cpu()
    want = objs["cpu"].renew_leaf_outputs(score, leaf_id.cpu(), bag, s.M, old.cpu())
    if name == "mape":
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    else:
        assert torch.equal(got, want)


def _rank_boosters(monkeypatch, dev, params):
    """A booster factory on 100k rows of 8 features in queries of 1 to 250
    rows (LambdaRank; else the objective of ``params`` on a regression
    label), the lambdas rounded to multiples of 2^-7 after the kernel
    (hessians at least 2^-7): every histogram sum is exact, so training is
    the same bit for bit whatever the kernels' summation order."""
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch import objective as obj_mod

    get = obj_mod.LambdarankNDCG.get_gradients
    q = 128.0

    def dyadic(self, score):
        g, h = get(self, score)
        return torch.round(g * q) / q, torch.clamp(torch.round(h * q), min=1.0) / q

    monkeypatch.setattr(obj_mod.LambdarankNDCG, "get_gradients", dyadic)
    rng = np.random.RandomState(3)
    sizes = rng.randint(1, 251, 900)
    n = int(sizes.sum())
    X = rng.randn(n, 8)
    y = 3.0 * X[:, 0] + X[:, 1] ** 2 + rng.randn(n)
    rank = params["objective"] == "lambdarank"
    label = np.clip(np.round(y - 1.0), 0, 4) if rank else y + 5.0
    ds = tlgb.Dataset(X, label=label, group=sizes if rank else None)
    base = {"num_leaves": 63, "max_bin": 255, "learning_rate": 0.1, "verbose": -1, **params}

    def booster(chunk=1, graph=True):
        b = tlgb.Booster(dict(base, device_chunk_size=chunk), ds, device="cuda")
        b._gbdt.iteration_graph = graph
        return b
    return booster


@pytest.mark.parametrize("params", [
    {"objective": "lambdarank"},
    {"objective": "regression_l1", "bagging_fraction": 0.8, "bagging_freq": 1},
])
def test_captured_rank_and_renewal_iterations_equal_eager(monkeypatch, dev, params):
    """A captured LambdaRank iteration (the lambda kernel inside the graph)
    and a captured L1 iteration (the renewal inside the graph, with a bag):
    replays, chunks of 4 and the eager launches give the same model text and
    train scores bit for bit; the replays count the lambda kernel."""
    from lightgbm_tpu_torch.ops import rank_kernel

    booster = _rank_boosters(monkeypatch, dev, params)
    runs = {}
    for kind, (chunk, graph) in {"eager": (1, False), "graph": (1, True), "chunk": (4, True)}.items():
        b = booster(chunk, graph)
        before = rank_kernel.launches["lambdarank"]
        assert not b.update()
        while b.current_iteration < 9:
            assert not b.update_chunk(chunk)[1]
        if params["objective"] == "lambdarank":
            assert rank_kernel.launches["lambdarank"] - before == 9, kind
        runs[kind] = b
    assert runs["graph"]._gbdt.captures == 1 and runs["chunk"]._gbdt.captures == 1
    for kind in ("graph", "chunk"):
        assert _trees_text(runs[kind]) == _trees_text(runs["eager"]), kind
        assert runs[kind]._gbdt.train_score().tobytes() == runs["eager"]._gbdt.train_score().tobytes()


# ---- the training API's host code over the captured loop: a custom objective,
# continued training and the boosting modes with ranking and leaf renewal


def _rounded_fobj(labels, q=128.0):
    """A numpy binary log-loss objective with its gradients and hessians
    rounded to multiples of 1/q (hessians at least 1/q)."""
    def fobj(preds, _dataset):
        p = 1.0 / (1.0 + np.exp(-preds))
        return np.round((p - labels) * q) / q, np.maximum(np.round(p * (1.0 - p) * q), 1.0) / q
    return fobj


def _api_data(n=100_000, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 12)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.5 * rng.randn(n) > 0).astype(np.float64)
    return X, y


API_PARAMS = {"num_leaves": 63, "max_bin": 255, "learning_rate": 0.3, "verbose": -1,
              "objective": "none", "bagging_fraction": 0.8, "bagging_freq": 1,
              "feature_fraction": 0.8}


def test_fobj_replay_equals_eager_and_the_cpu(dev):
    """Booster.update(fobj=): the gradients uploaded before each replay of
    the one captured iteration give the eager launches' and the CPU plain
    loop's model text and train scores bit for bit (gradients rounded to
    2^-7: every histogram sum exact); a wrong or stale upload would fork
    the trees."""
    import lightgbm_tpu_torch as tlgb

    X, y = _api_data()
    fobj = _rounded_fobj(y)
    runs = {}
    for kind, device, graph in (("graph", "cuda", True), ("eager", "cuda", False),
                                ("cpu", "cpu", False)):
        b = tlgb.Booster(dict(API_PARAMS), tlgb.Dataset(X, label=y), device=device)
        b._gbdt.iteration_graph = graph
        for _ in range(8):
            assert not b.update(fobj=fobj)
        runs[kind] = b
    g = runs["graph"]._gbdt
    assert g.captures == 1 and g._custom_grads and g.grow_loop == "device"
    for kind in ("eager", "cpu"):
        assert _trees_text(runs["graph"]) == _trees_text(runs[kind]), kind
        assert runs["graph"]._gbdt.train_score().tobytes() == runs[kind]._gbdt.train_score().tobytes()


def test_warmstart_carry_on_the_card(dev, tmp_path):
    """The per-tree f32 replay of a model trained on the card (from the
    Booster and from its text) equals its live score carry bit for bit, and
    a run continued from the file grows the one-shot run's trees (rounded
    gradients)."""
    import lightgbm_tpu_torch as tlgb

    X, y = _api_data()
    fobj = _rounded_fobj(y)

    def train(rounds, init_model=None):
        return tlgb.train(dict(API_PARAMS), tlgb.Dataset(X, label=y), rounds, fobj=fobj,
                          init_model=init_model, verbose_eval=False)

    first = train(4)
    carry = first._gbdt.scores.cpu().numpy()
    assert np.array_equal(first._gbdt.warmstart_scores(X), carry)
    path = str(tmp_path / "first.txt")
    first.save_model(path)
    loaded = tlgb.Booster(model_file=path)
    assert np.array_equal(loaded._gbdt.warmstart_scores(X), carry)
    warm, one = train(4, init_model=path), train(8)
    assert warm._gbdt.captures == 1
    assert warm.model_to_string() == one.model_to_string()


MODE_OBJECTIVES = {
    "goss_quantile": {"boosting": "goss", "learning_rate": 0.25, "objective": "quantile",
                      "alpha": 0.9},
    "dart_l1": {"boosting": "dart", "skip_drop": 0.0, "drop_rate": 0.3,
                "objective": "regression_l1"},
    "rf_mape": {"boosting": "rf", "bagging_fraction": 0.8, "bagging_freq": 1, "objective": "mape"},
    "goss_lambdarank": {"boosting": "goss", "learning_rate": 0.25, "objective": "lambdarank"},
}


@pytest.mark.parametrize("pair", sorted(MODE_OBJECTIVES))
def test_mode_objective_replay_equals_eager(monkeypatch, dev, pair):
    """GOSS with quantile and LambdaRank, DART with L1 and random forest
    with MAPE: a replay an iteration gives the eager launches' model text
    and train scores bit for bit, the lambdas, quantile's 0.1 and -0.9 and
    MAPE's weighted signs rounded to 2^-7 (L1's are exact); MAPE's weighted
    renewal sums its weights in f64, exact, whatever the scan's order."""
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch import objective as obj_mod

    for cls in (obj_mod.RegressionMAPELoss, obj_mod.RegressionQuantileLoss,
                obj_mod.LambdarankNDCG):
        def rounded(self, score, get=cls.get_gradients):
            g, h = get(self, score)
            return (torch.round(g * 128.0) / 128.0,
                    torch.clamp(torch.round(h * 128.0), min=1.0) / 128.0)

        monkeypatch.setattr(cls, "get_gradients", rounded)
    rng = np.random.RandomState(3)
    # 100,000 rows in queries of 1 to 250: GOSS's amplification is then
    # (100,000 - 20,000) / 10,000 = 8 and the amplified gradients stay dyadic
    sizes = rng.randint(1, 251, 900)
    sizes = sizes[:int(np.searchsorted(np.cumsum(sizes), 100_000))]
    sizes = np.append(sizes, 100_000 - sizes.sum())
    n = int(sizes.sum())
    X = rng.randn(n, 8)
    yv = 3.0 * X[:, 0] + X[:, 1] ** 2 + rng.randn(n)
    rank = MODE_OBJECTIVES[pair]["objective"] == "lambdarank"
    ds = tlgb.Dataset(X, label=np.clip(np.round(yv - 1.0), 0, 4) if rank else yv + 5.0,
                      group=sizes if rank else None)
    base = {"num_leaves": 63, "max_bin": 255, "verbose": -1, **MODE_OBJECTIVES[pair]}
    runs = {}
    for graph in (False, True):
        b = tlgb.Booster(dict(base), ds, device="cuda")
        b._gbdt.iteration_graph = graph
        for _ in range(8):
            assert not b.update()
        runs[graph] = b
    g = runs[True]._gbdt
    assert g.captures == (2 if pair.startswith("goss") else 1)
    assert g._renew == (not rank)
    assert _trees_text(runs[True]) == _trees_text(runs[False])
    assert runs[True]._gbdt.train_score().tobytes() == runs[False]._gbdt.train_score().tobytes()


# ---------------------------------------------------------------------------
# the serving path: csrc/packed_predict.cu and the server on the card
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _serving_model(dev, objective="binary", rounds=6, leaves=63, cat=False, seed=0):
    """A model trained on the card and its rows (one training a case)."""
    import lightgbm_tpu_torch as tlgb

    rng = np.random.RandomState(seed)
    X = rng.randn(6000, 8)
    if cat:
        X[:, 5] = rng.randint(0, 40, 6000)
    X[rng.rand(*X.shape) < 0.04] = np.nan
    sig = np.nan_to_num(X[:, 0]) + (np.nan_to_num(X[:, 5]) % 3 == 0 if cat else 0)
    if objective == "multiclass":
        y = (np.digitize(sig, [-0.5, 0.5])).astype(float)
        params = {"objective": "multiclass", "num_class": 3}
    elif objective == "rf":  # random forest: average_output
        y = (sig > 0).astype(float)
        params = {"objective": "binary", "boosting": "rf", "bagging_fraction": 0.7,
                  "bagging_freq": 1}
    else:
        y = (sig + 0.3 * rng.randn(6000) > 0.2).astype(float)
        params = {"objective": objective}
    params.update(num_leaves=leaves, verbose=-1)
    ds = tlgb.Dataset(X, label=y, categorical_feature=[5] if cat else "auto")
    return tlgb.train(params, ds, rounds, device=dev), X


@pytest.mark.parametrize("case", ["binary", "multiclass_cat", "rf"])
@pytest.mark.parametrize("n", [1, 16, 4096, 10000])
def test_packed_kernels_match_plain(dev, case, n):
    from lightgbm_tpu_torch.ops import packed_kernel
    from lightgbm_tpu_torch.ops import predict as predict_plain

    if case == "binary":
        bst, X = _serving_model(dev)
    elif case == "multiclass_cat":
        bst, X = _serving_model(dev, "multiclass", cat=True, leaves=31)
    else:
        bst, X = _serving_model(dev, "rf", rounds=5, leaves=31)
    rows = np.resize(X, (n, X.shape[1]))
    pk = bst.to_packed()
    P = pk.packed
    Xd = torch.as_tensor(rows.astype(np.float32), device=dev)
    packed_kernel.reset_launches()
    codes, isnan = packed_kernel.packed_bin_rows(Xd, pk.bounds_dev, pk.is_cat_dev)
    want_c, want_n = predict_plain.packed_bin_rows(Xd, pk.bounds_dev, pk.is_cat_dev)
    assert torch.equal(codes, want_c) and torch.equal(isnan, want_n)
    leaves = packed_kernel.packed_predict_leaves(codes, isnan, P)
    assert torch.equal(leaves, predict_plain.packed_predict_leaves(codes, isnan, P))
    K = pk.num_tree_per_iteration
    vals = packed_kernel.packed_predict_values(codes, isnan, P, K, pk.average_output)
    assert torch.equal(vals, predict_plain.packed_predict_values(codes, isnan, P, K,
                                                                 pk.average_output))
    assert packed_kernel.launches == {"packed_bin_rows": 1, "packed_predict_leaves": 1,
                                      "packed_predict_values": 1}
    # the exact path on the card equals the port's Booster.predict bit for bit
    assert np.array_equal(pk.predict(rows), bst.predict(rows))
    assert np.array_equal(pk.predict(rows, pred_leaf=True), bst.predict(rows, pred_leaf=True))


def test_packed_wrappers_raise_on_what_the_kernel_does_not_take(dev):
    from lightgbm_tpu_torch.ops import packed_kernel

    bst, X = _serving_model(dev, rounds=2, leaves=7)
    pk = bst.to_packed()
    codes, isnan = packed_kernel.packed_bin_rows(
        torch.as_tensor(X[:10].astype(np.float32), device=dev), pk.bounds_dev, pk.is_cat_dev)
    with pytest.raises(ValueError, match="codes"):
        packed_kernel.packed_predict_leaves(codes.to(torch.int64), isnan, pk.packed)
    with pytest.raises(ValueError, match="isnan"):
        packed_kernel.packed_predict_leaves(codes, isnan[:5], pk.packed)
    with pytest.raises(ValueError, match="X"):
        packed_kernel.packed_bin_rows(torch.as_tensor(X[:10], device=dev), pk.bounds_dev,
                                      pk.is_cat_dev)


def test_cuda_server_answers_exact_and_fused(dev, tmp_path):
    import http.client
    import json
    import threading

    from lightgbm_tpu_torch.ops import packed_kernel
    from lightgbm_tpu_torch.serve.server import ServeApp, make_server

    bst, X = _serving_model(dev, rounds=8)
    path = str(tmp_path / "m.txt")
    bst.save_model(path)
    app = ServeApp(max_delay_ms=1.0, min_bucket_rows=8, warmup_rows=64, device="cuda")
    srv = None
    try:
        app.registry.load("m", path)
        srv = make_server("127.0.0.1", 0, app)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        port = srv.server_address[1]
        rows = X[:37]

        def post(body):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            try:
                conn.request("POST", "/predict", json.dumps(body),
                             {"Content-Type": "application/json"})
                r = conn.getresponse()
                return r.status, json.loads(r.read())
            finally:
                conn.close()

        packed_kernel.reset_launches()
        status, body = post({"rows": np.where(np.isnan(rows), None, rows).tolist()})
        assert status == 200
        assert np.array_equal(np.asarray(body["predictions"]), bst.predict(rows))
        assert packed_kernel.launches["packed_predict_leaves"] == 1
        status, body = post({"rows": np.where(np.isnan(rows), None, rows).tolist(), "fused": True})
        assert status == 200
        assert np.allclose(np.asarray(body["predictions"]), bst.predict(rows), rtol=1e-4, atol=1e-5)
        assert packed_kernel.launches["packed_bin_rows"] == 1
        assert packed_kernel.launches["packed_predict_values"] == 1
        assert app.backend == "cuda"
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        app.close()


# ---------------------------------------------------------------------------
# SHAP contributions: csrc/tree_shap.cu
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _shap_model(dev, case):
    """(a model, its rows with NaN) of each case, trained on the card; the
    chain is a hand-written tree of 70 levels; "loaded" is the binary model
    read back from its text."""
    import chip_smoke
    import lightgbm_tpu_torch as tlgb

    F = 674 if case == "wide" else 28
    rng = np.random.RandomState(len(case))
    X = rng.randn(3000, F)
    X[rng.rand(*X.shape) < 0.03] = np.nan
    if case == "chain":
        return tlgb.Booster(model_str=chip_smoke.chain_model_text(70, F, seed=5), device=dev), X
    if case == "loaded":
        bst, X = _shap_model(dev, "binary")
        return tlgb.Booster(model_str=bst.model_to_string(), device=dev), X
    sig = np.nan_to_num(X[:, 0]) + np.nan_to_num(X[:, 1]) * np.nan_to_num(X[:, 2])
    params = {"objective": "binary", "num_leaves": 31, "verbose": -1}
    cats = "auto"
    if case == "multiclass":  # K = 7, with a categorical column
        X[:, 3] = rng.randint(0, 40, len(X))
        cats = [3]
        sig = sig + (X[:, 3] % 4 == 0)
        params.update(objective="multiclass", num_class=7)
        y = np.digitize(sig, np.quantile(sig, np.linspace(0, 1, 8)[1:-1])).astype(float)
    else:
        y = (sig > 0).astype(float)
    return tlgb.train(params, tlgb.Dataset(X, label=y, categorical_feature=cats), 3,
                      device=dev), X


@pytest.mark.parametrize("case", ["binary", "wide", "multiclass", "chain", "loaded"])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000])
def test_tree_shap_kernel_matches_plain(dev, case, n):
    """The kernel against its plain version bit for bit, on the card and on the
    CPU (whose values are the JAX package's, tests/test_torch_contrib.py):
    F = 28 and 674, K = 1 and 7 (categorical nodes), the chain, a loaded model."""
    from lightgbm_tpu_torch.ops import shap as shap_plain
    from lightgbm_tpu_torch.ops import shap_kernel

    bst, X = _shap_model(dev, case)
    trees = bst._gbdt.trees()
    K, F = bst.num_model_per_iteration(), bst.num_feature()
    if case == "multiclass":
        assert K == 7 and any(t.num_cat > 0 for t in trees)
    rows = np.ascontiguousarray(np.resize(X, (n, F)))
    Xd = torch.as_tensor(rows, device=dev)
    shap_kernel.reset_launches()
    got = shap_kernel.tree_shap(Xd, shap_kernel.shap_trees(trees, dev), K, F)
    assert shap_kernel.launches["tree_shap"] >= 1
    assert torch.equal(got, shap_plain.contrib_plain(Xd, trees, K, F))
    want_cpu = shap_plain.contrib_plain(torch.as_tensor(rows[:8]), trees, K, F)
    assert torch.equal(got[:, :8].cpu(), want_cpu)


@pytest.mark.parametrize("case", ["binary", "multiclass", "chain"])
@pytest.mark.parametrize("mode", ["few_blocks", "unstaged", "both"])
def test_tree_shap_kernel_loops_and_reads_unstaged_trees(dev, monkeypatch, case, mode):
    """The kernel against its plain version bit for bit where each block
    loops over many (128 rows, tree) tiles, re-staging a tree into shared
    memory each time and reusing one scratch slot (the scratch cut to three
    blocks' slots), and where a tree is larger than STAGE_BYTES and is read
    from global memory (the stage cut to 0 bytes)."""
    from lightgbm_tpu_torch.ops import shap as shap_plain
    from lightgbm_tpu_torch.ops import shap_kernel

    bst, X = _shap_model(dev, case)
    trees = bst._gbdt.trees()
    K, F = bst.num_model_per_iteration(), bst.num_feature()
    ens = shap_kernel.shap_trees(trees, dev)
    if mode in ("few_blocks", "both"):
        monkeypatch.setattr(shap_kernel, "PATH_BYTES",
                            3 * shap_kernel.THREADS * shap_kernel.slot_bytes(ens.max_depth))
    if mode in ("unstaged", "both"):
        monkeypatch.setattr(shap_kernel, "STAGE_BYTES", 0)
    Xd = torch.as_tensor(np.ascontiguousarray(X[:, :F]), device=dev)  # 3,000 rows
    plan = shap_kernel.launch_plan(ens, len(Xd), F, K, dev)
    assert plan.staged == (mode == "few_blocks")
    if mode != "unstaged":
        assert plan.grid == 3 and plan.tiles >= 8 * plan.grid, plan
    got = shap_kernel.tree_shap(Xd, ens, K, F)
    assert torch.equal(got, shap_plain.contrib_plain(Xd, trees, K, F))


def test_tree_shap_through_predict_and_chunks(dev, monkeypatch):
    """``Booster.predict(pred_contrib=True)`` on the card launches the kernel
    and sums to the raw score; partials cut into chunks of one tree give the
    same bits as one chunk."""
    from lightgbm_tpu_torch.ops import shap_kernel

    bst, X = _shap_model(dev, "multiclass")
    shap_kernel.reset_launches()
    contrib = bst.predict(X[:500], pred_contrib=True)
    assert shap_kernel.launches["tree_shap"] == 1
    K, F1 = 7, X.shape[1] + 1
    assert contrib.shape == (500, K * F1)
    np.testing.assert_allclose(contrib.reshape(500, K, F1).sum(2), bst.predict(X[:500], raw_score=True),
                               rtol=1e-9, atol=1e-9)
    monkeypatch.setattr(shap_kernel, "PARTIAL_BYTES", 500 * F1 * 8)
    shap_kernel.reset_launches()
    assert np.array_equal(bst.predict(X[:500], pred_contrib=True), contrib)
    assert shap_kernel.launches["tree_shap"] == bst.num_trees()


def test_tree_shap_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    from lightgbm_tpu_torch.ops import shap_kernel

    bst, X = _shap_model(dev, "binary")
    ens = shap_kernel.shap_trees(bst._gbdt.trees(), dev)
    Xd = torch.as_tensor(X[:10], device=dev)
    with pytest.raises(ValueError, match="float64"):
        shap_kernel.tree_shap(Xd.float(), ens, 1, 28)
    with pytest.raises(ValueError, match="contiguous"):
        shap_kernel.tree_shap(torch.as_tensor(X[:10].T.copy(), device=dev).t(), ens, 1, 28)
    with pytest.raises(ValueError, match="on cuda"):
        shap_kernel.tree_shap(Xd, shap_kernel.shap_trees(bst._gbdt.trees(), "cpu"), 1, 28)


# ---- wide bins (int16, up to 1024 a feature) and the histogram pool ------------------

def _wide_loop_inputs(dev, N, F=12, B=1024, seed=0, q=1024, categorical=True):
    """[F, N] int16 bins (feature f below its num_bin: B, and B // 3 for
    every fourth), the [N, F] copy, dyadic gradients and hessians (multiples
    of 1/q, exact at these sizes), meta with missing types 0/1/2, and with
    ``categorical`` feature F - 1 categorical over B - 1 categories, the
    gradients following its category, so that its splits take bins past
    word 8 of the membership bitset."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    num_bin = torch.full((F,), B, dtype=torch.int32, device=dev)
    num_bin[3::4] = max(B // 3, 2)
    bins = (torch.rand((F, N), generator=gen, device=dev) * num_bin[:, None]).to(torch.int16)
    grad = torch.randint(-q, q + 1, (N,), generator=gen, device=dev).float() / q
    hess = torch.randint(1, 65, (N,), generator=gen, device=dev).float() / q
    meta = {
        "num_bin": num_bin,
        "missing_type": torch.arange(F, dtype=torch.int32, device=dev) % 3,
        "default_bin": torch.arange(F, dtype=torch.int32, device=dev) % 3,
        "monotone": torch.zeros(F, dtype=torch.int32, device=dev),
    }
    if categorical:
        nb = B - 1
        meta["num_bin"][F - 1], meta["missing_type"][F - 1] = nb, 0
        bins[F - 1] = (torch.rand(N, generator=gen, device=dev) * nb).to(torch.int16)
        effect = torch.randint(-4, 5, (nb,), generator=gen, device=dev).float() / 8
        grad = grad + effect[bins[F - 1].long()]
        meta["is_categorical"] = torch.arange(F, device=dev) == F - 1
    return bins, bins.t().contiguous(), grad, hess, meta, torch.ones(F, dtype=torch.bool, device=dev)


@pytest.mark.parametrize("B", [300, 1024])
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_histogram_wide_matches_plain(dev, B, grouped, dtype):
    """csrc/histogram.cu's int16 instantiations (the [F, N] rows and the
    [N, F] copy's 64-bit word path, by rows) against the plain version, bit
    for bit on values exact in bf16; counted as histogram_wide."""
    bins, nf, grad, hess, meta, _ = _wide_loop_inputs(dev, 200_001, F=29, B=B, categorical=False)
    vals = leaf_values(grad, hess, torch.ones_like(grad))
    rows = torch.sort(torch.randperm(200_001, device=dev)[:60_000]).values.int()
    key = "histogram_wide" + ("_bf16" if dtype == "bfloat16" else "")
    for hb, r in ((bins, None), (nf.t(), rows), (nf[:, :28].t(), None)):
        before = hist_kernel.launches[key]
        got = hist_kernel.histogram(hb, vals, B, r, dtype, grouped=grouped)
        assert hist_kernel.launches[key] == before + 1
        assert torch.equal(got, leaf_histogram(hb, vals, B, r, dtype))


def test_histogram_refuses_wide_bytes_and_more_than_1024_bins(dev):
    vals = torch.zeros((8, 3), device=dev)
    with pytest.raises(ValueError, match="336"):
        hist_kernel.histogram(torch.zeros((2, 8), dtype=torch.uint8, device=dev), vals, 337)
    with pytest.raises(ValueError, match="1024"):
        hist_kernel.histogram(torch.zeros((2, 8), dtype=torch.int16, device=dev), vals, 1025)
    with pytest.raises(ValueError, match="uint8"):
        hist_kernel.hist_onehot(torch.zeros((2, 8), dtype=torch.int16, device=dev), vals, 255)


@pytest.mark.parametrize("B", [337, 600, 1024])
def test_split_kernel_wide_widths(dev, B):
    """The scan's rows1024 instantiations (336 < B <= 1024), numerical and
    with categorical features of up to B bins, against the plain version."""
    hist, sums, cons, meta, fmask = _split_inputs(dev, F=16, B=B, seed=B, N=60_000)
    before = split_kernel.launches["split_pair_rows1024"]
    for params in SPLIT_PARAMS:
        for two_way in (True, False):
            _same_split(*_both(hist, sums, cons, meta, fmask, params, two_way))
    meta["is_categorical"] = torch.arange(16, device=dev) % 3 == 0
    for p in CAT_PARAMS:
        got, want = _both(hist, sums, cons, meta, fmask, p)
        _same_split(got, want)
        assert got[2].shape == (2, -(-B // 32))
    assert split_kernel.launches["split_pair_rows1024"] == before + 4 + len(CAT_PARAMS)


@pytest.mark.parametrize("P", [0, 4])
def test_wide_loop_kernels_match_plain_at_every_step(dev, P):
    """A 255-leaf tree at B = 1024 with a categorical feature of 1023
    categories, one step at a time: after each kernel of a step (the int16
    pick_partition, the wide segment histogram (and with a pool of P slots
    the larger child's), the wide folded scan) the whole state equals its
    plain version's on a copy; categorical splits set bits past word 8."""
    N = 100_000
    bins, nf, grad, hess, meta, mask = _wide_loop_inputs(dev, N, seed=7)
    s = gs.GrowState(dev, N, 12, 1024, 255, W=32, P=P)
    grow_mod.start_tree(s, bins, grad, hess, mask, meta, -1, LOOP_PARAMS, True, nf)
    check = s.clone()
    split_pair_step(check, 1)
    _same_state(s, check, "root")
    for step in range(254):
        p = step % 2
        pairs = [
            (partition_kernel.pick_partition, _plain_pick_partition),
            (lambda st: hist_kernel.histogram_segment(st, p), lambda st: segment_histogram(st, p)),
            (lambda st: split_kernel.split_pair_fold(st, p),
             lambda st: grow_step_plain.split_pair_fold(st, p)),
        ]
        if P:
            pairs.insert(2, (lambda st: hist_kernel.histogram_segment(st, p, large=True),
                             lambda st: segment_histogram(st, p, large=True)))
        for k, (kernel, plain) in enumerate(pairs):
            other = s.clone()
            kernel(s)
            plain(other)
            _same_state(s, other, (step, k))
    tree = grow_mod.read_tree(s)
    nl = int(tree.num_leaves)
    cat = tree.split_feature[:nl - 1] == 11
    assert bool(cat.any()) and bool(tree.cat_member[:nl - 1][cat][:, 256:].any())
    assert bool((tree.threshold_bin[:nl - 1][~cat] > 255).any())


@pytest.mark.parametrize("P", [2, 4, 254])
def test_pooled_device_loop_equals_unpooled_and_host_loop(dev, P):
    """Dyadic gradients at 1M rows and B = 1024: the device loop with a pool
    of P slots grows the unpooled tree (a child built from its rows equals
    the parent minus its sibling on exact sums), which is the host loop's;
    use_subtract=False too."""
    bins, nf, grad, hess, meta, mask = _wide_loop_inputs(dev, 1_000_000, seed=P)
    args = (bins, grad, hess, mask, meta, 255, -1, 1024, LOOP_PARAMS, True)
    want, want_leaf = grow_tree(*args, bins_nf=nf)
    for kw in ({}, {"hist_pool_slots": P}, {"hist_pool_slots": P, "use_subtract": False}):
        got, got_leaf, st = grow_tree_device(*args, bins_nf=nf, **kw)
        assert st.P == kw.get("hist_pool_slots", 0)
        for name in TreeArrays._fields:
            assert torch.equal(getattr(got, name), getattr(want, name)), (name, kw)
        assert torch.equal(got_leaf, want_leaf), kw


def test_predict_bins_wide_matches_plain(dev):
    """csrc/predict_bins.cu's int16 instantiation against its plain version
    on a 255-leaf tree at B = 1024 with categorical nodes whose bits lie
    past word 8 (W = 32: 32 KB of words beside the nodes), on other rows and
    on the training rows (there the loop's own leaf_ids)."""
    from lightgbm_tpu_torch.ops import predict as predict_plain
    from lightgbm_tpu_torch.ops import predict_kernel

    N = 100_000
    bins, nf, grad, hess, meta, mask = _wide_loop_inputs(dev, N, seed=11)
    s = gs.GrowState(dev, N, 12, 1024, 255, W=32)
    grow_mod.launch_tree(s, bins, grad, hess, mask, meta, -1, LOOP_PARAMS, True, nf)
    nodes, nl = s.node_i[:254], s.ctl[gs.NUM_LEAVES:gs.NUM_LEAVES + 1]
    cat = nodes[:, 0] == 11
    assert int(nl) == 255 and bool((s.node_b[:254][cat][:, 8:] != 0).any())
    value = torch.randn(255, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    other = (torch.rand((77_777, 12), generator=gen, device=dev) * meta["num_bin"]).to(torch.int16)
    for rows in (other, nf):
        n = rows.shape[0]
        start = torch.randn(n, generator=gen, device=dev)
        got, want = start.clone(), start.clone()
        got_leaf = torch.empty(n, dtype=torch.int32, device=dev)
        want_leaf = torch.empty(n, dtype=torch.int32, device=dev)
        before = predict_kernel.launches["predict_bins_wide"]
        predict_kernel.add_tree_value(rows, nodes, nl, meta, value, got, got_leaf, s.node_b)
        assert predict_kernel.launches["predict_bins_wide"] == before + 1
        predict_plain.add_tree_value(rows, nodes, nl, meta, value, want, want_leaf, s.node_b)
        assert torch.equal(got_leaf, want_leaf) and torch.equal(got, want)
    assert torch.equal(got_leaf.long(), grow_step_kernel.leaf_ids(s))


@pytest.mark.parametrize("pool", [0.0, 2.0])
def test_wide_and_pooled_training_replays_equal_eager(monkeypatch, dev, pool):
    """max_bin=1024 (and a 2 MB pool: 10 slots at 16 x 1024) through the
    captured iteration: the replays' model text and scores equal the eager
    launches' on dyadic gradients; every scan and pick launched, replays
    counted, was an int16 (and a pool) instantiation."""
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch import objective as objective_mod

    get_gradients = objective_mod.BinaryLogloss.get_gradients

    def dyadic(self, score):
        g_, h_ = get_gradients(self, score)
        return torch.round(g_ * 128.0) / 128.0, torch.clamp(torch.round(h_ * 128.0), min=1.0) / 128.0

    monkeypatch.setattr(objective_mod.BinaryLogloss, "get_gradients", dyadic)
    rng = np.random.RandomState(0)
    X = rng.randn(60_000, 16)
    y = (X[:, 0] + X[:, 1] ** 2 + 0.3 * rng.randn(60_000) > 1).astype(float)
    params = {"objective": "binary", "max_bin": 1024, "min_data_in_bin": 1, "num_leaves": 63,
              "histogram_pool_size": pool, "verbose": -1}
    ds = tlgb.Dataset(X, label=y)
    runs = []
    for graph in (True, False):
        bst = tlgb.Booster(dict(params), ds)
        bst._gbdt.iteration_graph = graph
        split_kernel.reset_launches()
        partition_kernel.reset_launches()
        for _ in range(4):
            bst.update()
        g = bst._gbdt
        fold, pick = "split_pair_fold_rows1024", "pick_partition_wide"
        if pool:
            fold, pick = fold + "_pool", pick + "_pool"
        sk, pk = split_kernel.launches, partition_kernel.launches
        assert sk[fold] > 0 and sum(sk.values()) == sk[fold] + sk["split_pair_step_rows1024"]
        assert pk[pick] == sum(pk.values()) > 0
        assert g.grow_loop == "device" and g.bins_dev.dtype == torch.int16 and g.num_bins > 256
        assert (g.hist_pool_slots or 0) == (10 if pool else 0)
        assert g.captures == (1 if graph else 0)
        runs.append((bst.model_to_string(), g.train_score()))
    assert runs[0][0] == runs[1][0] and np.array_equal(runs[0][1], runs[1][1])


# ---- forced splits and CEGB (csrc/split_pair.cu's penalised,
# all-leaves and forced-record entries, csrc/partition.cu's kExt pick,
# csrc/grow_step.cu's cegb_lazy) -------------------------------------------------

def _cegb_same(a, b, what):
    _same_state(a, b, what)
    if a.cegb is not None:
        assert torch.equal(a.cegb.feature_used, b.cegb.feature_used), what
        if a.cegb.used_in_data is not None:
            assert torch.equal(a.cegb.used_in_data, b.cegb.used_in_data), what


@pytest.mark.parametrize("variant", ["numerical", "categorical", "wide", "pool", "bundled"])
def test_forced_cegb_kernels_match_plain_at_every_step(dev, variant):
    """A 63-leaf tree at 100k rows on dyadic gradients, with a forced table
    of three splits and (but under a pool) all three CEGB penalties, one
    kernel at a time: the lazy pass and the penalised scan at the root, then
    at every step the forced record (forced steps), the pick (kExt), the
    lazy pass, the segment histogram(s), the remap of a bundled table, the
    penalised folded scan and the all-leaves scan, each against its plain
    version on a copy of the state: the whole state, the paid features and
    the paid rows equal. ``bundled``: an EFB table (layout ``mixed``) whose
    three forced splits are on bundled one-hot and 64-bin features (the
    bundled kExt pick decodes them)."""
    from lightgbm_tpu_torch.ops import remap, remap_kernel
    from lightgbm_tpu_torch.ops import split as split_plain
    from lightgbm_tpu_torch.ops.split import CegbParams

    N, M = 100_000, 63
    gen = torch.Generator(device=dev).manual_seed(11)
    G = Bg = W = 0
    if variant == "bundled":
        bins, nf, _, grad, hess, meta, mask, Bg = _efb_inputs(dev, N, EFB_LAYOUTS["mixed"], 3)
        F, G, B = meta["num_bin"].numel(), bins.shape[0], 255
        # a one-hot feature of the 255-member bundle (its rare side left), one
        # of the 31-member bundle on the right child, then the 64-bin feature
        # on the second split's right child
        forced_rows = [(0, 1, 0), (1, 256, 0), (2, 287, 30)]
    else:
        F = 28
        B = 1024 if variant == "wide" else 255
        num_bin = torch.full((F,), B, dtype=torch.int32, device=dev)
        num_bin[3::4] = 7
        bins = (torch.rand((F, N), generator=gen, device=dev) * num_bin[:, None]).to(
            torch.int16 if variant == "wide" else torch.uint8)
        nf = bins.t().contiguous()
        grad = torch.randint(-1024, 1025, (N,), generator=gen, device=dev).float() / 1024
        hess = torch.randint(1, 65, (N,), generator=gen, device=dev).float() / 1024
        meta = {"num_bin": num_bin,
                "missing_type": torch.arange(F, dtype=torch.int32, device=dev) % 3,
                "default_bin": torch.arange(F, dtype=torch.int32, device=dev) % 3,
                "monotone": torch.zeros(F, dtype=torch.int32, device=dev)}
        if variant == "categorical":
            meta["is_categorical"] = torch.arange(F, device=dev) % 4 == 3
            W = (B + 31) // 32
        mask = torch.ones(F, dtype=torch.bool, device=dev)
        forced_rows = [(0, 0, B // 2), (0, 3, 2), (1, 1, B // 3)]
    bag = (torch.rand(N, generator=gen, device=dev) > 0.2).float()
    P = 8 if variant == "pool" else 0
    forced = grow_mod.forced_table(forced_rows, dev)
    cegb = None if P else gs.Cegb(CegbParams(1.0, 2e-4, True, True), F, N, np.linspace(0.5, 3, F),
                                  np.full(F, 2e-4), dev)
    s = gs.GrowState(dev, N, F, B, M, W, G, Bg, P, cegb=cegb is not None)
    ext_before = sum(v for k, v in partition_kernel.launches.items() if k.endswith("_ext"))
    grow_mod.start_tree(s, bins, grad, hess, mask, meta, -1, LOOP_PARAMS, True, nf, bag=bag,
                        forced=forced, cegb=cegb)

    def hold(kernel, plain, what):
        other = s.clone()
        kernel(s)
        plain(other)
        _cegb_same(s, other, what)

    if cegb is not None:
        hold(lambda st: grow_step_kernel.cegb_lazy(st, root=True),
             lambda st: grow_step_plain.cegb_lazy(st, root=True), "lazy root")
        hold(lambda st: split_kernel.split_pair_step(st, 1), lambda st: split_pair_step(st, 1),
             "penalised root")
    newly = 0
    K = forced.shape[0]
    for step in range(K + M - 1):
        p, k = step % 2, (step if step < K else None)
        if k is not None:
            hold(lambda st: split_kernel.forced_record(st, k),
                 lambda st: split_plain.forced_record(st, k), (step, "forced_record"))
        hold(lambda st: partition_kernel.pick_partition(st, k is not None),
             lambda st: (grow_step_plain.pick(st, k is not None), partition_plain.partition(st)),
             (step, "pick"))
        if not int(s.ctl[gs.ACTIVE]):
            break
        if cegb is not None:
            hold(grow_step_kernel.cegb_lazy, grow_step_plain.cegb_lazy, (step, "lazy"))
        hold(lambda st: hist_kernel.histogram_segment(st, p), lambda st: segment_histogram(st, p),
             (step, "segment"))
        if P:
            hold(lambda st: hist_kernel.histogram_segment(st, p, large=True),
                 lambda st: segment_histogram(st, p, large=True), (step, "large"))
        if G:
            hold(lambda st: remap_kernel.remap_step(st, p), lambda st: remap.remap_step(st, p),
                 (step, "remap"))
        hold(lambda st: split_kernel.split_pair_fold(st, p),
             lambda st: grow_step_plain.split_pair_fold(st, p), (step, "fold"))
        if cegb is not None:
            newly += int(s.ctl[gs.NEWLY]) and int(s.ctl[gs.NUM_LEAVES]) > 2
            hold(split_kernel.split_pair_all, split_plain.split_pair_all, (step, "all"))
    assert int(s.ctl[gs.NUM_LEAVES]) > 20
    if cegb is not None:
        assert newly > 0  # the all-leaves scan ran at a first payment
    assert int(s.ctl[gs.ABORT]) == 0
    assert s.node_i[:K, 0].tolist() == [f for _, f, _ in forced_rows]
    if dev.type == "cuda":
        assert sum(v for k, v in partition_kernel.launches.items()
                   if k.endswith("_ext")) > ext_before  # a kExt instantiation ran


@pytest.mark.parametrize("table", ["dense", "bundled"])
def test_forced_cegb_replays_equal_eager(monkeypatch, tmp_path, dev, table):
    """Forced splits with all three CEGB penalties through the captured
    iteration and in chunks of 4: the model text, scores and CEGB state
    equal the eager launches' on dyadic gradients. ``dense``: one forced
    split is invalid, so the preamble aborts after the root. ``bundled``:
    an EFB-bundled CSR table (two dense columns, 40 one-hot ones), the
    forced splits under the root on one-hot columns of one bundle."""
    import json

    import scipy.sparse as sp

    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch import objective as objective_mod
    from lightgbm_tpu_torch.bench import train_iterations

    get_gradients = objective_mod.BinaryLogloss.get_gradients

    def dyadic(self, score):
        g_, h_ = get_gradients(self, score)
        return torch.round(g_ * 128.0) / 128.0, torch.clamp(torch.round(h_ * 128.0), min=1.0) / 128.0

    monkeypatch.setattr(objective_mod.BinaryLogloss, "get_gradients", dyadic)
    rng = np.random.RandomState(1)
    n = 60_000
    params = {"objective": "binary", "num_leaves": 63, "verbose": -1, "bagging_fraction": 0.8,
              "bagging_freq": 1}
    fs = tmp_path / "forced.json"
    if table == "dense":
        X = rng.randn(n, 12)
        y = (X[:, 0] + X[:, 1] ** 2 + 0.3 * rng.randn(n) > 1).astype(float)
        # the left child's forced split puts every row of it on one side: invalid
        forced = {"feature": 2, "threshold": 0.0, "left": {"feature": 2, "threshold": 0.5},
                  "right": {"feature": 4, "threshold": 0.5}}
    else:
        hot = np.zeros((n, 40))
        hot[np.arange(n), rng.randint(0, 40, n)] = 1.0
        dense = rng.randn(n, 2)
        X = sp.csr_matrix(np.c_[dense, hot])
        y = (hot[:, :10].sum(1) + dense[:, 0] + 0.3 * rng.randn(n) > 0.5).astype(float)
        forced = {"feature": 0, "threshold": 0.0, "left": {"feature": 2, "threshold": 0.5},
                  "right": {"feature": 3, "threshold": 0.5}}
        params["max_conflict_rate"] = 0.0
    F = X.shape[1]
    fs.write_text(json.dumps(forced))
    params.update(forcedsplits_filename=str(fs), cegb_penalty_split=2e-4,
                  cegb_penalty_feature_coupled=[5.0] * F, cegb_penalty_feature_lazy=[2e-4] * F)
    ds = tlgb.Dataset(X, label=y)
    runs = []
    for graph, chunk in ((True, 1), (False, 1), (True, 4)):
        bst = tlgb.Booster(dict(params, device_chunk_size=chunk), ds)
        bst._gbdt.iteration_graph = graph
        assert train_iterations(bst, 8, chunk) == 8
        g = bst._gbdt
        assert g.captures == (1 if graph else 0) and g.grow_loop == "device"
        assert (g.num_groups > 0) == (table == "bundled")
        state = (g._cegb.feature_used.cpu(), g._cegb.used_in_data.cpu())
        runs.append((bst.model_to_string().split("parameters:")[0], g.train_score(), state))
    for r in runs[1:]:
        assert r[0] == runs[0][0] and np.array_equal(r[1], runs[0][1])
        assert all(torch.equal(a, b) for a, b in zip(r[2], runs[0][2]))
    for line in runs[0][0].splitlines():
        if line.startswith("split_feature="):
            feats = line.split("=")[1].split()
            if table == "dense":  # the forced root; the preamble aborted after it
                assert feats[0] == "2" and feats[1:3] != ["2", "4"], line
            else:
                assert feats[:3] == ["0", "2", "3"], line


# ---- EFB groups past 256 bins, the pool with EFB, CEGB with the pool (csrc/efb_remap.cu's
# wide and larger-child instantiations, csrc/partition.cu's int16 and pooled bundled picks,
# csrc/predict_bins.cu's int16 bundled kernel, csrc/split_pair.cu's pooled kPen all-leaves entry) ----

@pytest.mark.parametrize("layout", ["mixed", "wide"])
def test_efb_remap_large_returns_at_once_on_a_hit(dev, layout):
    """The larger child's remap of a pooled bundled step: on a miss
    (``pool_ctl[RUN]``) ``large[p]`` is the remap of ``large_g[p]`` with
    ``laux[pool_ctl[LEAF]]``'s sums, equal to the plain version bit for
    bit; on a hit it writes nothing but the cleared ``large_g[1 - p]``; a
    stopped loop writes nothing."""
    from lightgbm_tpu_torch.ops import remap, remap_kernel

    gid, off, nbin, widths = _efb_plan(EFB_LAYOUTS[layout])
    F, G, Bg, B = len(gid), len(widths), max(widths), int(nbin.max())
    rng = np.random.RandomState(3)
    meta = {k: torch.from_numpy(v).to(dev) for k, v in (
        ("group_id", gid), ("bin_offset", off), ("num_bin", nbin),
        ("default_bin", np.array([rng.randint(0, nb) for nb in nbin], np.int32)))}
    s = gs.GrowState(dev, 1000, F, B, 15, 0, G, Bg, P=4)
    s.feature_meta = dict(meta)
    s.stream = torch.cuda.current_stream(dev).cuda_stream
    s.large_g[0].copy_(torch.tensor(rng.randn(G, Bg, 3), dtype=torch.float32))
    s.laux[6, :3] = torch.tensor(rng.randn(3) * 40, dtype=torch.float32)
    s.ctl[gs.ACTIVE] = 1
    s.pool_ctl[gs.RUN], s.pool_ctl[gs.LEAF] = 1, 6
    key = "efb_remap" + ("_wide" if B > 256 else "") + "_large"
    for run in (1, 0):
        s.pool_ctl[gs.RUN] = run
        s.large_g[1].fill_(7.0)
        s.large[0].fill_(-1.0)
        other = s.clone()
        before = remap_kernel.launches[key]
        remap_kernel.remap_large(s, 0)
        assert remap_kernel.launches[key] == before + 1
        remap.remap_large(other, 0)
        _same_state(s, other, ("run", run))
        assert not bool(s.large_g[1].any())
        assert bool((s.large[0] == -1.0).all()) != bool(run)
    s.ctl[gs.ACTIVE] = 0
    s.large_g[1].fill_(7.0)
    remap_kernel.remap_large(s, 0)
    assert bool((s.large_g[1] == 7.0).all())


def _dense_cegb_inputs(dev, N, F=28, B=255, seed=11):
    """A dense [F, N] table of B bins (every fourth feature 7 bins) with
    dyadic gradients and hessians (multiples of 2^-10), its meta and mask."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    num_bin = torch.full((F,), B, dtype=torch.int32, device=dev)
    num_bin[3::4] = 7
    bins = (torch.rand((F, N), generator=gen, device=dev) * num_bin[:, None]).to(torch.uint8)
    grad = torch.randint(-1024, 1025, (N,), generator=gen, device=dev).float() / 1024
    hess = torch.randint(1, 65, (N,), generator=gen, device=dev).float() / 1024
    meta = {"num_bin": num_bin,
            "missing_type": torch.arange(F, dtype=torch.int32, device=dev) % 3,
            "default_bin": torch.arange(F, dtype=torch.int32, device=dev) % 3,
            "monotone": torch.zeros(F, dtype=torch.int32, device=dev)}
    return bins, bins.t().contiguous(), grad, hess, meta, torch.ones(F, dtype=torch.bool,
                                                                      device=dev)


#: (EFB layout or None for the dense table, pool slots, CEGB penalties:
#: None, "all" three, "split" only or "lazy" only)
BUNDLED_POOLED = {
    "wide_bundled": ("wide", 0, None),
    "pooled_bundled": ("mixed", 6, None),
    "wide_pooled_bundled": ("wide", 6, None),
    "wide_pooled_bundled_cegb": ("wide", 6, "all"),
    "pooled_cegb": (None, 8, "all"),
    "pooled_cegb_split": (None, 8, "split"),
    "pooled_cegb_lazy": (None, 8, "lazy"),
}


@pytest.mark.parametrize("variant", sorted(BUNDLED_POOLED))
def test_bundled_wide_pooled_kernels_match_plain_at_every_step(dev, variant):
    """A 63-leaf tree at 100k rows on dyadic gradients, one kernel at a
    time: at the root the lazy pass and the penalised scan (CEGB), then at
    every step the pick (int16 groups, a pooled bundled table, kExt under
    coupled CEGB), the lazy pass, both segment histograms, the remaps of
    both children (the wide instantiation past 256 bins; the larger child's
    on a pooled step, which returns at once on a hit), the folded scan (by
    slot; penalised without a pool) and the pooled all-leaves scan (the
    children every step, after a first payment the other resident leaves,
    from their slots, the evicted ones' records patched; with a split or a
    lazy penalty alone, the children only), each against its plain
    version on a copy: the whole state and the paid features and rows
    equal. The new instantiations ran."""
    from lightgbm_tpu_torch.ops import remap, remap_kernel
    from lightgbm_tpu_torch.ops import split as split_plain
    from lightgbm_tpu_torch.ops.split import CegbParams

    layout, P, penalties = BUNDLED_POOLED[variant]
    N, M = 100_000, 63
    if layout is None:
        bins, nf, grad, hess, meta, mask = _dense_cegb_inputs(dev, N)
        F, G, Bg, B = 28, 0, 0, 255
    else:
        bins, nf, _, grad, hess, meta, mask, Bg = _efb_inputs(dev, N, EFB_LAYOUTS[layout], 5)
        F, G, B = meta["num_bin"].numel(), bins.shape[0], int(meta["num_bin"].max())
    bag = (torch.rand(N, generator=torch.Generator(device=dev).manual_seed(2), device=dev)
           > 0.2).float()
    cegb = None
    if penalties is not None:
        coupled = np.full(F, 6.0) if penalties == "all" else None
        lazy = np.full(F, 2e-4) if penalties in ("all", "lazy") else None
        split = 2e-4 if penalties in ("all", "split") else 0.0
        cegb = gs.Cegb(CegbParams(1.0, split, coupled is not None, lazy is not None), F, N,
                       coupled, lazy, dev)
    s = gs.GrowState(dev, N, F, B, M, 0, G, Bg, P, cegb=cegb is not None)
    cuda_graph.reset_launches()
    grow_mod.start_tree(s, bins, grad, hess, mask, meta, -1, LOOP_PARAMS, True, nf, bag=bag,
                        cegb=cegb)

    def hold(kernel, plain, what):
        other = s.clone()
        kernel(s)
        out = plain(other)
        _cegb_same(s, other, what)
        return out

    lazy_pass = cegb is not None and cegb.used_in_data is not None
    if lazy_pass:
        hold(lambda st: grow_step_kernel.cegb_lazy(st, root=True),
             lambda st: grow_step_plain.cegb_lazy(st, root=True), "lazy root")
    if cegb is not None:
        hold(lambda st: split_kernel.split_pair_step(st, 1), lambda st: split_pair_step(st, 1),
             "penalised root")
    patched = misses = rescans = 0
    for step in range(M - 1):
        p = step % 2
        hold(partition_kernel.pick_partition, _plain_pick_partition, (step, "pick"))
        if not int(s.ctl[gs.ACTIVE]):
            break
        if lazy_pass:
            hold(grow_step_kernel.cegb_lazy, grow_step_plain.cegb_lazy, (step, "lazy"))
        hold(lambda st: hist_kernel.histogram_segment(st, p), lambda st: segment_histogram(st, p),
             (step, "segment"))
        if P:
            misses += int(s.pool_ctl[gs.RUN])
            hold(lambda st: hist_kernel.histogram_segment(st, p, large=True),
                 lambda st: segment_histogram(st, p, large=True), (step, "large"))
        if G:
            hold(lambda st: remap_kernel.remap_step(st, p), lambda st: remap.remap_step(st, p),
                 (step, "remap"))
            if P:
                hold(lambda st: remap_kernel.remap_large(st, p),
                     lambda st: remap.remap_large(st, p), (step, "remap_large"))
        hold(lambda st: split_kernel.split_pair_fold(st, p),
             lambda st: grow_step_plain.split_pair_fold(st, p), (step, "fold"))
        if s.rescans_all:
            rescans += 1
            patched += hold(split_kernel.split_pair_all, split_plain.split_pair_all, (step, "all"))
    assert int(s.ctl[gs.NUM_LEAVES]) > 20
    got = cuda_graph.launch_counts()
    wide = B > 256
    pick = ("pick_partition" + ("_wide" if wide else "") + ("_pool" if P else "")
            + ("_ext" if penalties == "all" else "") + ("_efb" if G and (wide or P) else ""))
    assert got[pick] > 0, got
    if G:
        assert got["efb_remap" + ("_wide" if wide else "")] > 0, got
        if P:
            assert misses and got["efb_remap" + ("_wide" if wide else "") + "_large"] > 0, got
    if cegb is not None and P:
        rows = "_rows1024" if B > hist_kernel.MAX_BYTE_BINS else ""
        assert got["split_pair_fold%s_pool" % rows] > 0, got
        assert got["split_pair_all%s_pool" % rows] == rescans == int(s.ctl[gs.NUM_LEAVES]) - 1, got
        if penalties == "all":
            assert patched > 0  # an evicted leaf's record on a newly paid feature
        else:
            assert patched == 0  # no coupled penalty, no payment to patch


def test_predict_bins_wide_bundled_matches_plain(dev):
    """csrc/predict_bins.cu's int16 bundled instantiation against the plain
    traversal on a 255-leaf tree of the ``wide`` layout (a group of 700
    bins): the same leaf and f32 score bit for bit on other rows ([N, G]
    int16) and on the training rows (there the loop's own leaf_ids), and
    the unbundled int16 instantiation on the decoded [N, F] rows takes the
    same leaves."""
    from lightgbm_tpu_torch.ops import predict as predict_plain
    from lightgbm_tpu_torch.ops import predict_kernel

    N = 100_000
    layout = EFB_LAYOUTS["wide"]
    bins, nf, dense, grad, hess, meta, mask, Bg = _efb_inputs(dev, N, layout, 4)
    F, G = meta["num_bin"].numel(), bins.shape[0]
    assert bins.dtype == torch.int16 and Bg == 700
    s = gs.GrowState(dev, N, F, 700, 255, 0, G, Bg)
    grow_mod.launch_tree(s, bins, grad, hess, mask, meta, -1, LOOP_PARAMS, True, nf)
    nodes, nl = s.node_i[:254], s.ctl[gs.NUM_LEAVES:gs.NUM_LEAVES + 1]
    assert int(nl) == 255 and bool((nodes[:int(nl) - 1, 0] == 0).any())  # the 700-bin feature
    value = torch.randn(255, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    o_bins, o_nf, o_dense = _efb_inputs(dev, 77_777, layout, 6)[:3]
    plain_meta = {k: v for k, v in meta.items() if k not in ("group_id", "bin_offset")}
    for rows, flat in ((o_nf, o_dense.t().contiguous()), (nf, dense.t().contiguous())):
        n = rows.shape[0]
        start = torch.randn(n, generator=gen, device=dev)
        got, want = start.clone(), start.clone()
        got_leaf = torch.empty(n, dtype=torch.int32, device=dev)
        want_leaf = torch.empty(n, dtype=torch.int32, device=dev)
        flat_leaf = torch.empty(n, dtype=torch.int32, device=dev)
        before = predict_kernel.launches["predict_bins_wide_efb"]
        predict_kernel.add_tree_value(rows, nodes, nl, meta, value, got, got_leaf)
        assert predict_kernel.launches["predict_bins_wide_efb"] == before + 1
        predict_plain.add_tree_value(rows, nodes, nl, meta, value, want, want_leaf)
        assert torch.equal(got_leaf, want_leaf) and torch.equal(got, want)
        predict_kernel.add_tree_value(flat, nodes, nl, plain_meta, value, start.clone(), flat_leaf)
        assert torch.equal(flat_leaf, got_leaf)
    assert torch.equal(got_leaf.long(), grow_step_kernel.leaf_ids(s))


@pytest.mark.parametrize("case", ["wide_bundled", "pooled_bundled", "pooled_cegb"])
def test_bundled_wide_pooled_trainings_replay_equal_eager(monkeypatch, dev, case):
    """Through the captured iteration and in chunks of 4: the model text,
    scores (and CEGB state) equal the eager launches' on dyadic gradients.
    ``wide_bundled``: a CSR table whose 1,000-value column takes a group of
    more than 256 bins at max_bin 1024 (int16 groups), with a bundled
    validation set; ``pooled_bundled``: one-hot CSR columns under a pool of
    4 slots; ``pooled_cegb``: a dense table with the three CEGB penalties
    under a pool of 6 slots. The new instantiations ran."""
    import scipy.sparse as sp

    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch import objective as objective_mod
    from lightgbm_tpu_torch.bench import train_iterations

    get_gradients = objective_mod.BinaryLogloss.get_gradients

    def dyadic(self, score):
        g_, h_ = get_gradients(self, score)
        return torch.round(g_ * 128.0) / 128.0, torch.clamp(torch.round(h_ * 128.0), min=1.0) / 128.0

    monkeypatch.setattr(objective_mod.BinaryLogloss, "get_gradients", dyadic)
    rng = np.random.RandomState(4)
    n = 60_000
    params = {"objective": "binary", "num_leaves": 63, "verbose": -1}
    hot = np.zeros((n + 10_000, 40))
    hot[np.arange(len(hot)), rng.randint(0, 40, len(hot))] = 1.0
    dense = rng.randn(len(hot), 2)
    wide_col = np.where(rng.rand(len(hot)) < 0.5, 0.0, rng.randint(0, 1000, len(hot)) + 1.0)
    if case == "pooled_cegb":
        X = rng.randn(len(hot), 12)
        y = (X[:, 0] + X[:, 1] ** 2 + 0.3 * rng.randn(len(hot)) > 1).astype(float)
        F = X.shape[1]
        params.update(cegb_penalty_split=2e-4, cegb_penalty_feature_coupled=[5.0] * F,
                      cegb_penalty_feature_lazy=[2e-4] * F,
                      histogram_pool_size=6.5 * F * 255 * 12 / 2 ** 20)
    else:
        X = sp.csr_matrix(np.c_[wide_col if case == "wide_bundled" else dense[:, 0], dense[:, 1],
                                hot])
        y = (hot[:, :10].sum(1) + dense[:, 0] + (wide_col > 500) + 0.3 * rng.randn(len(hot))
             > 1).astype(float)
        params["max_conflict_rate"] = 0.0
        if case == "wide_bundled":
            params.update(max_bin=1024, min_data_in_bin=1)
        else:
            params["histogram_pool_size"] = 4.5 * 42 * 255 * 12 / 2 ** 20
    ds = tlgb.Dataset(X[:n], label=y[:n])
    valid = tlgb.Dataset(X[n:], label=y[n:], reference=ds)
    runs = []
    for graph, chunk in ((True, 1), (False, 1), (True, 4)):
        bst = tlgb.Booster(dict(params, device_chunk_size=chunk), ds)
        bst.add_valid(valid, "valid")
        bst._gbdt.iteration_graph = graph
        cuda_graph.reset_launches()
        assert train_iterations(bst, 8, chunk) == 8
        got = cuda_graph.launch_counts()
        g = bst._gbdt
        assert g.captures == (1 if graph else 0) and g.grow_loop == "device"
        if case == "wide_bundled":
            assert g.num_groups > 0 and g.hist_width > 256 and g.bins_dev.dtype == torch.int16
            assert got["pick_partition_wide_efb"] > 0 and got["efb_remap_wide"] > 0, got
            assert got["predict_bins_wide_efb"] > 0, got
        elif case == "pooled_bundled":
            assert g.num_groups > 0 and g.hist_pool_slots == 4
            assert got["pick_partition_pool_efb"] > 0 and got["efb_remap_large"] > 0, got
        else:
            assert g.hist_pool_slots == 6
            assert got["split_pair_fold_pool"] > 0 and got["split_pair_all_pool"] > 0, got
        state = ((g._cegb.feature_used.cpu(), g._cegb.used_in_data.cpu()) if g._cegb is not None
                 else ())
        runs.append((bst.model_to_string().split("parameters:")[0], g.train_score(),
                     g.valid_scores[0].cpu(), state))
    for r in runs[1:]:
        assert r[0] == runs[0][0] and np.array_equal(r[1], runs[0][1])
        assert torch.equal(r[2], runs[0][2])
        assert all(torch.equal(a, b) for a, b in zip(r[3], runs[0][3]))
