"""``tpu_hist_mode=masked`` in the port, on the CPU. The JAX package's
masked mode is its in-package oracle, a full pass over masked values for
each histogram that grows the bucketed mode's trees; the port's device
loop takes the name for its one kind of histogram (models/gbdt.py). Held
against the JAX masked mode on tests/test_hist_modes.py's fixtures and its
dyadic gradients, 0.5 - y over hessians of 0.25, so every sum is exact in
any order:

 * ``grow_tree_device`` equals the JAX ``grow_tree(hist_mode="masked")``:
   every TreeArrays field and the per-row leaf, the gains within rtol 1e-6
   plus 1e-6 of the tree's largest gain (XLA's fused multiply-adds, through
   the cancellation of a gain against its parent's at lambda_l2 = 0): two
   seeds with NaN and zero features, with a bag, with monotone
   constraints, and the non-power-of-two and tiny row counts.
 * A whole training at ``tpu_hist_mode=masked`` (the device loop on the
   CPU), in chunks of 4 and one at a time, equals the bucketed training's
   model text byte for byte on the dyadic binary gradients; so do masked
   trainings under a histogram pool and on an EFB-bundled table.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
import lightgbm_tpu_torch.objective as tobj
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.dataset import construct_dataset
from lightgbm_tpu.ops.grow import grow_tree as jax_grow_tree
from lightgbm_tpu.ops.split import SplitParams as JaxSplitParams
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.ops import hist_kernel
from lightgbm_tpu_torch.ops.grow import TreeArrays, grow_tree_device
from lightgbm_tpu_torch.ops.split import SplitParams
from test_torch_widebin import _torch_dyadic

PARAMS = (0.0, 0.0, 0.0, 5, 1e-3, 0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _grow_both(X, y, bag=None, max_bin=63, leaves=31, mono=None):
    """The JAX masked tree and the port's tree."""
    ds = construct_dataset(X, JConfig.from_params({"max_bin": max_bin, "objective": "binary"}),
                           label=y)
    if mono is not None:
        ds.monotone_constraints = mono
    meta = ds.feature_meta_arrays()
    n = ds.num_data
    grad = (0.5 - y).astype(np.float32)
    hess = np.full(n, 0.25, np.float32)
    bagm = np.ones(n, np.float32) if bag is None else bag
    F = ds.num_features
    want = jax_grow_tree(
        jnp.asarray(ds.bins), jnp.asarray(grad), jnp.asarray(hess), jnp.asarray(bagm),
        jnp.ones(F, bool), {k: jnp.asarray(v) for k, v in meta.items()}, num_leaves=leaves,
        max_depth=-1, num_bins=ds.max_num_bin, params=JaxSplitParams(*PARAMS), chunk=256,
        hist_mode="masked")
    bins = torch.from_numpy(np.ascontiguousarray(ds.bins))
    args = (bins, torch.from_numpy(grad), torch.from_numpy(hess), torch.ones(F, dtype=torch.bool),
            convert.meta_tensors(meta), leaves, -1, ds.max_num_bin, SplitParams(*PARAMS), True)
    kw = dict(bins_nf=bins.t().contiguous(), bag=None if bag is None else torch.from_numpy(bag))
    return want, grow_tree_device(*args, **kw)[:2]


def _check(want, got):
    tree, leaf = got
    for name in TreeArrays._fields:
        a, b = np.asarray(getattr(want[0], name)), getattr(tree, name).numpy()
        if name == "split_gain":  # the f32 cancellation of a gain minus its parent's
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6 * float(np.abs(a).max()))
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
    np.testing.assert_array_equal(leaf.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_matches_bucketed_and_jax(seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(3000, 7)
    X[::7, 2] = np.nan
    X[::5, 3] = 0.0
    y = (np.nan_to_num(X[:, 0]) + 0.5 * X[:, 1] > 0).astype(np.float64)
    _check(*_grow_both(X, y))


def test_masked_with_bagging():
    rng = np.random.RandomState(2)
    X = rng.randn(2500, 6)
    y = (X[:, 0] > 0).astype(np.float64)
    bag = (rng.rand(2500) > 0.4).astype(np.float32)
    _check(*_grow_both(X, y, bag=bag))


def test_masked_monotone():
    rng = np.random.RandomState(4)
    X = rng.randn(2000, 5)
    y = (X[:, 0] + 0.3 * X[:, 1] > 0).astype(np.float64)
    _check(*_grow_both(X, y, mono=[1, -1, 0, 0, 0]))


@pytest.mark.parametrize("n", [777, 1025, 4097])
def test_masked_non_pow2_and_tiny(n):
    rng = np.random.RandomState(3)
    X = rng.randn(n, 4)
    y = (X[:, 0] > 0).astype(np.float64)
    _check(*_grow_both(X, y, leaves=7))


def test_masked_training_equals_bucketed_chunked(monkeypatch):
    monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")
    monkeypatch.setattr(tobj.BinaryLogloss, "get_gradients", _torch_dyadic)
    rng = np.random.RandomState(5)
    X = rng.randn(2000, 6)
    X[::9, 1] = np.nan
    y = (X[:, 0] + 0.5 * np.nan_to_num(X[:, 1]) > 0).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1, "bagging_fraction": 0.8,
              "bagging_freq": 1}
    texts = []
    for mode, chunk in (("bucketed", 1), ("masked", 1), ("masked", 4)):
        b = tlgb.train(dict(params, tpu_hist_mode=mode, device_chunk_size=chunk),
                       tlgb.Dataset(X, label=y), 6, device="cpu")
        assert b._gbdt.grow_loop == "device"
        texts.append(b.model_to_string().split("parameters:")[0])
    assert texts[0] == texts[1] == texts[2]


@pytest.mark.parametrize("table", ["pooled", "bundled"])
def test_masked_training_with_a_pool_or_bundles(monkeypatch, table):
    """The masked mode under a histogram pool and on an EFB-bundled table:
    the bucketed training's model text."""
    import scipy.sparse as sp

    monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")
    monkeypatch.setattr(tobj.BinaryLogloss, "get_gradients", _torch_dyadic)
    rng = np.random.RandomState(6)
    n = 2000
    if table == "pooled":
        X = rng.randn(n, 6)
        y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float64)
        extra = {"histogram_pool_size": 0.01}
    else:
        hot = np.zeros((n, 12))
        hot[np.arange(n), rng.randint(0, 12, n)] = 1.0
        dense = rng.randn(n, 2)
        X = sp.csr_matrix(np.c_[dense, hot])
        y = (hot[:, :4].sum(1) + dense[:, 0] > 0.5).astype(np.float64)
        extra = {"max_conflict_rate": 0.0}
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1, **extra}
    texts = []
    for mode in ("bucketed", "masked"):
        b = tlgb.train(dict(params, tpu_hist_mode=mode), tlgb.Dataset(X, label=y), 4, device="cpu")
        g = b._gbdt
        assert (g.hist_pool_slots is not None) == (table == "pooled")
        assert (g.num_groups > 0) == (table == "bundled")
        texts.append(b.model_to_string().split("parameters:")[0])
    assert texts[0] == texts[1]

