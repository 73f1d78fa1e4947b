"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card. A CUDA kernel has no interpret mode, so these skip without a
card; run them on a GPU machine with
``python -m pytest tests/test_torch_cuda.py -m cuda``.

Dyadic values (multiples of 1/64, or of 1/1024 where bf16 operands must
round) make every summation order exact, so the kernels must match the
plain versions bit for bit.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import hist_kernel, split_kernel
from lightgbm_tpu_torch.ops.histogram import (
    leaf_histogram, leaf_histogram_packed4_rows, leaf_values,
)
from lightgbm_tpu_torch.ops.split import SplitParams, find_best_split_pair

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
        kf, ki = split_kernel.find_best_split_pair(
            hist2, sums, cons, meta, fmask, SplitParams(*pr), two_way
        )
        pf, pi = find_best_split_pair(hist2, sums, cons, meta, fmask, SplitParams(*pr), two_way)
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
    (kf, ki), (pf, pi) = got, want
    assert bool(((kf == pf) | (kf.isnan() & pf.isnan())).all()), (kf, pf)
    assert torch.equal(ki, pi), (ki, pi)


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


def test_split_kernel_refuses_more_than_336_bins(dev):
    hist, sums, cons, meta, fmask = _split_inputs(dev, F=3, B=337)
    with pytest.raises(ValueError, match="336"):
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
    (_, ki), _ = _both(hist, sums, cons, meta, fmask, SPLIT_PARAMS[0])
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
