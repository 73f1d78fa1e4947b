"""The port's plain two-child split scan (lightgbm_tpu_torch/ops/split.py)
against the JAX package's Pallas kernel (find_best_split_pair_pallas, in
interpret mode) and its vmapped XLA scan (find_best_split).

Histograms are dyadic (grad and hess multiples of 1/64, integer counts), so
every prefix order gives the same sums: the chosen feature, threshold,
direction, side sums, counts and leaf outputs must be equal bit for bit.
The gain alone is held to rtol 1e-6: XLA on the CPU contracts its
multiply-adds into fused multiply-adds, which the port (like the CUDA
kernel, built with --fmad=false) does not, and the parent-gain subtraction
magnifies those one-ulp differences (measured: up to 8 ulps, 6e-7 relative).
The wrapper's leaf-index form (``leaves``: rows of the grower's [M, F, B, 3]
buffer, as ops/grow.py calls it) is held to the same results.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.split import SplitParams as JaxSplitParams
from lightgbm_tpu.ops.split import find_best_split
from lightgbm_tpu.ops.split_pallas import find_best_split_pair_pallas
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops import split_kernel

# tests/test_split_pallas.py PARAMS
PARAMS = [
    (0.0, 0.0, 0.0, 5, 1e-3, 0.0),
    (0.5, 1.0, 0.0, 1, 1e-3, 0.1),
    (0.0, 0.0, 0.3, 10, 0.5, 0.0),
]
EXACT = (
    "feature", "threshold", "default_left", "left_sum_grad", "left_sum_hess",
    "left_count", "right_sum_grad", "right_sum_hess", "right_count", "num_cat",
    "left_output", "right_output",
)
CLOSE = ("gain",)


def _case(seed, F=9, B=64):
    rng = np.random.RandomState(seed)
    num_bin = rng.randint(3, B + 1, F).astype(np.int32)
    num_bin[rng.rand(F) < 0.2] = 2  # some binary features
    hist = np.zeros((2, F, B, 3), np.float32)
    for c in range(2):
        for f in range(F):
            nb = num_bin[f]
            cnt = rng.randint(0, 40, nb).astype(np.float32)
            hist[c, f, :nb, 0] = rng.randint(-64, 65, nb) * np.maximum(cnt, 1) / 64.0
            hist[c, f, :nb, 1] = cnt * 0.25
            hist[c, f, :nb, 2] = cnt
    meta = {
        "num_bin": num_bin,
        # missing types none / zero / nan across features
        "missing_type": (np.arange(F) % 3).astype(np.int32),
        "default_bin": rng.randint(0, 3, F).astype(np.int32),
        "monotone": np.zeros(F, np.int32),
    }
    meta["monotone"][seed % F] = 1 if seed % 2 else -1
    fmask = rng.rand(F) > 0.15
    return hist, meta, fmask


def _torch_split(hist, meta, fmask, mn, mx, p, two_way=True, leaves=None):
    """The wrapper on the CPU; with ``leaves``, ``hist`` is [M, F, B, 3] and
    the leaves are its rows ``leaves``, as the grower calls it."""
    rows = hist if leaves is None else hist[list(leaves)]
    sums = rows[:, 0].sum(axis=1)  # every row lands in one bin of feature 0
    outf, outi, outb = split_kernel.find_best_split_pair(
        torch.from_numpy(hist), torch.from_numpy(sums),
        torch.from_numpy(np.stack([mn, mx], axis=1)), convert.meta_tensors(meta),
        torch.from_numpy(fmask), tsplit.SplitParams(*p), two_way, leaves,
    )
    return tsplit.unpack(outf, outi, outb)


def _in_buffer(hist, leaves, M=6, seed=0):
    """The children [C, F, B, 3] placed at rows ``leaves`` of a grower-like
    [M, F, B, 3] buffer whose other rows hold other histograms."""
    rng = np.random.RandomState(seed)
    buf = (rng.randint(0, 64, (M,) + hist.shape[1:]) / 4.0).astype(np.float32)
    buf[list(leaves)] = hist
    return buf


def _rows(res, idx):
    """Rows ``idx`` of every field of a split result."""
    return type(res)(*(np.asarray(f)[list(idx)] for f in res))


def _assert_same(got, want, leaves=2):
    for c in range(leaves):
        w_gain = float(want.gain[c])
        if not np.isfinite(w_gain):
            assert not np.isfinite(float(got.gain[c]))
            continue
        for name in EXACT:
            a = np.asarray(getattr(want, name))[c]
            b = getattr(got, name)[c].numpy()
            assert a == b, (c, name, a, b)
        for name in CLOSE:
            np.testing.assert_allclose(
                getattr(got, name)[c].numpy(), np.asarray(getattr(want, name))[c],
                rtol=1e-6, atol=0, err_msg=name,
            )


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("pi", range(len(PARAMS)))
def test_split_pair_matches_pallas_kernel(seed, pi):
    hist, meta, fmask = _case(seed)
    mn = np.array([-np.inf, -0.5], np.float32)
    mx = np.array([np.inf, 0.5], np.float32)
    sums = hist[:, 0].sum(axis=1)
    want = find_best_split_pair_pallas(
        jnp.asarray(hist), jnp.asarray(sums[:, 0]), jnp.asarray(sums[:, 1]),
        jnp.asarray(sums[:, 2]), jnp.asarray(mn), jnp.asarray(mx),
        {k: jnp.asarray(v) for k, v in meta.items()}, jnp.asarray(fmask),
        JaxSplitParams(*PARAMS[pi]), interpret=True,
    )
    got = _torch_split(hist, meta, fmask, mn, mx, PARAMS[pi])
    _assert_same(got, want)
    # the grower's form: both children, then each alone, read by leaf index
    leaves = (4, seed % 3)
    buf = _in_buffer(hist, leaves, seed=seed)
    _assert_same(_torch_split(buf, meta, fmask, mn, mx, PARAMS[pi], leaves=leaves), want)
    for c, leaf in enumerate(leaves):
        got1 = _torch_split(buf, meta, fmask, mn[[c]], mx[[c]], PARAMS[pi], leaves=[leaf])
        _assert_same(got1, _rows(want, [c]), leaves=1)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("pi", range(len(PARAMS)))
@pytest.mark.parametrize("two_way", [True, False])
def test_split_pair_matches_xla_scan(seed, pi, two_way):
    hist, meta, fmask = _case(seed + 10)
    if not two_way:
        meta["missing_type"][:] = 0  # the single-direction guarantee
    mn = np.array([-np.inf, -0.25], np.float32)
    mx = np.array([np.inf, 0.75], np.float32)
    sums = hist[:, 0].sum(axis=1)
    jmeta = {k: jnp.asarray(v) for k, v in meta.items()}
    params = JaxSplitParams(*PARAMS[pi])
    want = jax.vmap(
        lambda h, g, s, n, lo, hi: find_best_split(
            h, g, s, n, lo, hi, jmeta, jnp.asarray(fmask), params, two_way=two_way
        )
    )(
        jnp.asarray(hist), jnp.asarray(sums[:, 0]), jnp.asarray(sums[:, 1]),
        jnp.asarray(sums[:, 2]), jnp.asarray(mn), jnp.asarray(mx),
    )
    got = _torch_split(hist, meta, fmask, mn, mx, PARAMS[pi], two_way)
    _assert_same(got, want)


@pytest.mark.parametrize("leaves", [(0,), (3,), (1, 0), (4, 2), (2, 5)])
def test_split_pair_leaf_index_matches_xla_scan(leaves):
    """The grower's form, C = 1 or 2 rows of a [6, F, B, 3] buffer in any
    order, against the JAX scan of those rows."""
    C = len(leaves)
    hist, meta, fmask = _case(30 + leaves[0])
    hist = hist[:C]
    mn = np.array([-np.inf, -0.25], np.float32)[:C]
    mx = np.array([np.inf, 0.75], np.float32)[:C]
    sums = hist[:, 0].sum(axis=1)
    jmeta = {k: jnp.asarray(v) for k, v in meta.items()}
    params = JaxSplitParams(*PARAMS[1])
    want = jax.vmap(
        lambda h, g, s, n, lo, hi: find_best_split(
            h, g, s, n, lo, hi, jmeta, jnp.asarray(fmask), params
        )
    )(
        jnp.asarray(hist), jnp.asarray(sums[:, 0]), jnp.asarray(sums[:, 1]),
        jnp.asarray(sums[:, 2]), jnp.asarray(mn), jnp.asarray(mx),
    )
    buf = _in_buffer(hist, leaves, seed=len(leaves))
    got = _torch_split(buf, meta, fmask, mn, mx, PARAMS[1], leaves=leaves)
    _assert_same(got, want, leaves=C)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("pi", range(len(PARAMS)))
def test_single_leaf_split_matches_xla_scan(seed, pi):
    """``find_best_split`` (one leaf, scalar totals) against the JAX scan."""
    hist, meta, fmask = _case(seed + 20)
    h = hist[0]
    sg, sh, n = (float(v) for v in h[0].sum(axis=0))
    params = PARAMS[pi]
    want = find_best_split(
        jnp.asarray(h), jnp.float32(sg), jnp.float32(sh), jnp.float32(n),
        jnp.float32(-np.inf), jnp.float32(0.5), {k: jnp.asarray(v) for k, v in meta.items()},
        jnp.asarray(fmask), JaxSplitParams(*params),
    )
    got = tsplit.find_best_split(
        torch.from_numpy(h), sg, sh, n, -np.inf, 0.5, convert.meta_tensors(meta),
        torch.from_numpy(fmask), tsplit.SplitParams(*params),
    )
    _assert_same(
        tsplit.SplitResult(*(f[None] for f in got)),
        type(want)(*(jnp.asarray(f)[None] for f in want)),
        leaves=1,
    )


def test_split_without_valid_candidates():
    """A leaf too small to split: gain -inf and feature -1, like the JAX scan."""
    hist, meta, fmask = _case(3)
    hist[:, :, :, 2] = np.minimum(hist[:, :, :, 2], 1.0)
    mn = np.full(2, -np.inf, np.float32)
    mx = np.full(2, np.inf, np.float32)
    got = _torch_split(hist, meta, fmask, mn, mx, (0.0, 0.0, 0.0, 10_000, 1e-3, 0.0))
    assert np.all(np.isneginf(got.gain.numpy()))
    assert np.all(got.feature.numpy() == -1)
