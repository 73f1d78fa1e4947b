"""The port's histogram kernel family on the CPU against the JAX package.

Each JAX Pallas kernel (run in interpret mode) is held against the port's
wrapper of its counterpart, which on CPU tensors runs the plain version
(lightgbm_tpu_torch/ops/histogram.py), at B in {15, 63, 255} as the caps
allow and with f32 and bf16 operands:

 * dyadic inputs are equal bit for bit: multiples of 2^-6 in f32, and of
   2^-10 in bf16, so that the bf16 rounding really happens; the sums of
   such values are exact in every order;
 * real-valued f32 inputs agree to rtol 1e-5 / atol 1e-4 (the sums are
   added in other orders); in bf16 both sides are held, within the same
   bound, to the f64 oracle of the bf16-rounded values;
 * the ``rows=`` form equals the JAX kernel on the gathered segment.

Then the unit mirrors, each equal to the JAX package's: ``pack4`` (odd N),
``bitplane_split`` for every B in 2..256, the capability table for B in
1..300 through the name map, ``rows_bucket``, ``bucket_sizes`` and
``entries_digest``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.obs import tune as jtune
from lightgbm_tpu.ops import grow as jgrow
from lightgbm_tpu.ops import hist_pallas as hp
from lightgbm_tpu.ops import histogram as jhist
from lightgbm_tpu_torch.obs import tune as ttune
from lightgbm_tpu_torch.ops import hist_kernel as hk
from lightgbm_tpu_torch.ops.histogram import histogram_reference, leaf_values

F, N, ALL = 5, 999, 1500  # F not a multiple of 8, odd N; segments of N out of ALL rows

# (JAX kernel, port wrapper, widths its caps allow)
FAMILY = {
    "fb": (hp.histogram_pallas, hk.histogram, (15, 63, 255)),
    "v1": (hp.histogram_pallas_v1, hk.hist_v1, (15, 63, 255)),
    "onehot": (hp.histogram_pallas_onehot, hk.hist_onehot, (15, 63, 255)),
    "bitplane": (hp.histogram_pallas_bitplane, hk.hist_bitplane, (15, 63, 255)),
    "packed4": (hp.histogram_pallas_packed4, hk.hist_packed4, (15,)),
}
CASES = [(k, b, d) for k, (_, _, bs) in FAMILY.items() for b in bs for d in ("float32", "bfloat16")]


def _inputs(seed, B, dyadic, dtype):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (F, ALL)).astype(np.uint8)
    if dyadic:
        q = 64 if dtype == "float32" else 1024
        g = rng.randint(-q, q + 1, ALL) / q
        h = rng.randint(1, q + 1, ALL) / q
    else:
        g = rng.randn(ALL)
        h = rng.rand(ALL)
    mask = rng.rand(ALL) > 0.3  # rows outside the leaf
    vals = leaf_values(
        torch.tensor(g, dtype=torch.float32), torch.tensor(h, dtype=torch.float32),
        torch.from_numpy(mask),
    ).numpy()
    rows = np.sort(rng.permutation(ALL)[:N]).astype(np.int32)
    return bins, vals, rows


def _jax(kernel, bins, vals, B, dtype):
    if kernel == "packed4":
        bp, vp = hp.pack4(jnp.asarray(bins), jnp.asarray(vals))
        out = hp.histogram_pallas_packed4(bp, vp, B, chunk=512, dtype_name=dtype, interpret=True)
    else:
        out = FAMILY[kernel][0](
            jnp.asarray(bins), jnp.asarray(vals), B, chunk=512, dtype_name=dtype, interpret=True
        )
    return np.asarray(out)


def _port(kernel, bins, vals, B, dtype, rows=None):
    bins_t, vals_t = torch.from_numpy(bins), torch.from_numpy(vals)
    if kernel == "packed4":
        if rows is not None:
            idx = torch.from_numpy(rows).long()
            bins_t, vals_t = bins_t[:, idx], vals_t[idx]
        return hk.hist_packed4(*hk.pack4(bins_t, vals_t), B, dtype).numpy()
    rows_t = None if rows is None else torch.from_numpy(rows)
    return FAMILY[kernel][1](bins_t, vals_t, B, rows_t, dtype).numpy()


def _bf16(vals):
    return torch.from_numpy(vals).to(torch.bfloat16).to(torch.float32).numpy()


@pytest.mark.parametrize("kernel,B,dtype", CASES)
def test_kernel_family_matches_jax(kernel, B, dtype):
    bins, vals, rows = _inputs(B + 7, B, True, dtype)
    head = slice(0, N)
    want = _jax(kernel, bins[:, head], vals[head], B, dtype)
    np.testing.assert_array_equal(_port(kernel, bins[:, head], vals[head], B, dtype), want)
    ref = histogram_reference(bins[:, head], _bf16(vals[head]) if dtype == "bfloat16" else vals[head], B)
    np.testing.assert_array_equal(want, ref)
    if dtype == "bfloat16":  # the rounding happened
        assert not np.array_equal(ref, histogram_reference(bins[:, head], vals[head], B))

    # the rows= form against the JAX kernel on the gathered segment
    seg = _jax(kernel, bins[:, rows], vals[rows], B, dtype)
    np.testing.assert_array_equal(_port(kernel, bins, vals, B, dtype, rows), seg)

    # real values: other summation orders
    bins, vals, _ = _inputs(B + 8, B, False, dtype)
    bins, vals = bins[:, head], vals[head]
    ref = histogram_reference(bins, _bf16(vals) if dtype == "bfloat16" else vals, B)
    for got in (_jax(kernel, bins, vals, B, dtype), _port(kernel, bins, vals, B, dtype)):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_routed_dispatch_reaches_each_wrapper():
    """routed_histogram with each impl forced equals the wrapper it names
    (packed4 through pack4, the segment gathered first)."""
    bins, vals, rows = _inputs(3, 15, True, "bfloat16")
    bt, vt, rt = torch.from_numpy(bins), torch.from_numpy(vals), torch.from_numpy(rows)
    want = hk.hist_v1(bt, vt, 15, rt, "bfloat16")
    for impl in ("cuda", "cuda_onehot", "cuda_bitplane", "cuda_packed4"):
        got = hk.routed_histogram(bt, vt, 15, rows=rt, impl=impl, hist_dtype="bfloat16")
        assert torch.equal(got, want), impl
    # scatter ignores hist_dtype, as the JAX scatter does
    got = hk.routed_histogram(bt, vt, 15, rows=rt, impl="scatter", hist_dtype="bfloat16")
    assert torch.equal(got, hk.hist_v1(bt, vt, 15, rt, "float32"))


@pytest.mark.parametrize("n", [1, 2, 999, 1000])
def test_pack4_matches_jax(n):
    rng = np.random.RandomState(n)
    bins = rng.randint(0, 16, (3, n)).astype(np.uint8)
    vals = rng.randn(n, 3).astype(np.float32)
    jb, jv = hp.pack4(jnp.asarray(bins), jnp.asarray(vals))
    tb, tv = hk.pack4(torch.from_numpy(bins), torch.from_numpy(vals))
    assert tb.dtype == torch.uint8 and tb.is_contiguous() and tv.is_contiguous()
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the transposed [N, F] layout packs the same
    tb2, _ = hk.pack4(torch.from_numpy(np.ascontiguousarray(bins.T)).t(), torch.from_numpy(vals))
    np.testing.assert_array_equal(tb2.numpy(), np.asarray(jb))


def test_bitplane_split_matches_jax():
    for b in range(2, 257):
        lob, hib = hk.bitplane_split(b)
        assert (lob, hib) == hp.bitplane_split(b), b
        assert lob * hib >= b


def test_caps_match_jax_through_the_name_map():
    for jname, tname in hk.JAX_NAMES.items():
        for b in range(1, 301):
            assert hk.impl_supported(tname, b, "cuda", ignore_backend=True) == jhist.impl_supported(
                jname, b, "tpu", ignore_backend=True
            ), (jname, b)
    assert set(hk.KERNEL_CAPS) == {hk.JAX_NAMES[j] for j in hp.KERNEL_CAPS}
    # kernels route only on CUDA, the plain version only on the CPU
    assert hk.impl_supported("cuda_onehot", 255, "cuda")
    assert not hk.impl_supported("cuda_onehot", 255, "cpu")
    assert hk.impl_supported("scatter", 255, "cpu")
    assert not hk.impl_supported("scatter", 255, "cuda")
    assert hk.default_impl("cuda") == "cuda" and hk.default_impl("cpu") == "scatter"


def test_rows_bucket_and_bucket_sizes_match_jax():
    for n in list(range(1, 3000)) + [2 ** 20 - 1, 2 ** 20, 2 ** 20 + 1, 10 ** 6, 3 << 18]:
        assert hk.rows_bucket(n) == jhist.rows_bucket(n), n
    for n in (1, 255, 256, 1000, 4097, 100_000, 10 ** 6):
        assert hk.bucket_sizes(n) == jgrow.bucket_sizes(n), n


def test_entries_digest_matches_jax():
    ents = [
        {"B": 255, "K": 3, "hist_dtype": "float32", "rows_bucket": 1 << 20, "impl": "cuda"},
        {"B": 15, "K": 3, "hist_dtype": "bfloat16", "rows_bucket": 384, "impl": "cuda_packed4",
         "times_ms": {"cuda": 0.1}},
        {"B": 63, "K": 3, "hist_dtype": "float32", "rows_bucket": 256, "impl": "pallas"},
    ]
    assert ttune.entries_digest(ents) == jtune.entries_digest(ents)
    assert ttune.entries_digest(ents[::-1]) == ttune.entries_digest(ents)
    route = hk.HistRoute([((e["B"], e["K"], e["hist_dtype"], e["rows_bucket"]), e["impl"]) for e in ents])
    jroute = jhist.HistRoute([((e["B"], e["K"], e["hist_dtype"], e["rows_bucket"]), e["impl"]) for e in ents])
    assert route.digest == jroute.digest
