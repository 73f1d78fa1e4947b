"""The port's plain leaf histogram (lightgbm_tpu_torch/ops/histogram.py,
reached through the kernel wrapper ops/hist_kernel.py on CPU tensors)
against the JAX package: the numpy oracle ``histogram_reference``,
``leaf_histogram(impl="scatter")`` and the Pallas kernel ``histogram_pallas``
in interpret mode.

Dyadic values (multiples of 1/64 with small exponents) sum exactly in every
order, so those results must be equal bit for bit. Real-valued f32 sums
depend on the order of the adds (each side adds in its own order, the
oracle in f64), so they are held to rtol 1e-5 / atol 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.hist_pallas import histogram_pallas
from lightgbm_tpu.ops.histogram import histogram_reference, leaf_histogram
from lightgbm_tpu_torch.ops import hist_kernel
from lightgbm_tpu_torch.ops import histogram as thist


def _inputs(seed, F, n, B, dyadic):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (F, n)).astype(np.uint8)
    if dyadic:
        g = rng.randint(-64, 65, n) / 64.0
        h = rng.randint(1, 65, n) / 64.0
    else:
        g = rng.randn(n)
        h = rng.rand(n)
    mask = (rng.rand(n) > 0.3).astype(np.float32)  # rows outside the leaf
    vals = thist.leaf_values(
        torch.tensor(g, dtype=torch.float32), torch.tensor(h, dtype=torch.float32),
        torch.from_numpy(mask),
    ).numpy()
    return bins, vals


def _port(bins, vals, B, rows=None):
    return hist_kernel.histogram(
        torch.from_numpy(bins), torch.from_numpy(vals), B,
        rows=None if rows is None else torch.from_numpy(rows),
    ).numpy()


@pytest.mark.parametrize("B", [15, 63, 255])
@pytest.mark.parametrize("dyadic", [True, False])
def test_histogram_matches_reference_and_scatter(B, dyadic):
    bins, vals = _inputs(B, 5, 1001, B, dyadic)  # odd N
    got = _port(bins, vals, B)
    ref = histogram_reference(bins, vals, B)
    scat = np.asarray(
        leaf_histogram(jnp.asarray(bins), jnp.asarray(vals), B, impl="scatter")
    )
    if dyadic:
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, scat)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got, scat, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("B", [15, 63, 255])
def test_histogram_matches_pallas_kernel(B):
    bins, vals = _inputs(B + 1, 3, 777, B, dyadic=True)
    got = _port(bins, vals, B)
    want = np.asarray(
        histogram_pallas(
            jnp.asarray(bins), jnp.asarray(vals), B,
            chunk=512, dtype_name="float32", interpret=True,
        )
    )
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B", [15, 255])
def test_histogram_rows_segment(B):
    """The ``rows=`` form equals the histogram of the gathered segment."""
    bins, vals = _inputs(B + 2, 4, 999, B, dyadic=True)
    rows = np.random.RandomState(0).permutation(999)[:311].astype(np.int32)
    got = _port(bins, vals, B, rows)
    ref = histogram_reference(bins[:, rows], vals[rows], B)
    np.testing.assert_array_equal(got, ref)
    # the [N, F] layout, passed as a transposed view, gives the same result
    nf = torch.from_numpy(np.ascontiguousarray(bins.T))
    got_nf = hist_kernel.histogram(nf.t(), torch.from_numpy(vals), B, torch.from_numpy(rows))
    np.testing.assert_array_equal(got_nf.numpy(), ref)
