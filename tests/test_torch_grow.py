"""One tree grown by the port (lightgbm_tpu_torch/ops/grow.py, plain
versions on the CPU) and by the JAX package's ``grow_tree`` from the same
binned data (through ``convert.binned_from_numpy``) and the same dyadic
gradients and hessians (multiples of 1/64, so every histogram sum is exact).

Every TreeArrays field must be equal bit for bit, except ``split_gain``,
held to rtol 1e-6: XLA on the CPU contracts the gain's multiply-adds into
fused multiply-adds and the port does not (see tests/test_torch_split.py).
The per-row leaf index must be equal too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.grow import grow_tree as jax_grow_tree
from lightgbm_tpu.ops.split import SplitParams as JaxSplitParams
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.ops.grow import TreeArrays, grow_tree
from lightgbm_tpu_torch.ops.split import SplitParams

PARAMS = (0.0, 1.0, 0.0, 5, 1e-3, 0.0)


def _case(seed, N=2001, F=6, B=63):
    rng = np.random.RandomState(seed)
    num_bin = rng.randint(3, B + 1, F).astype(np.int32)
    num_bin[0] = B
    bins = np.stack([rng.randint(0, nb, N) for nb in num_bin]).astype(np.uint8)
    meta = {
        "num_bin": num_bin,
        "missing_type": (np.arange(F) % 3).astype(np.int32),
        "default_bin": rng.randint(0, 3, F).astype(np.int32),
        "monotone": np.zeros(F, np.int8),
    }
    meta["monotone"][1] = 1
    meta["monotone"][2] = -1
    grad = (rng.randint(-64, 65, N) / 64.0).astype(np.float32)
    hess = (rng.randint(1, 65, N) / 64.0).astype(np.float32)
    return bins, meta, grad, hess


@pytest.mark.parametrize("seed,max_depth", [(0, -1), (1, 3), (2, -1)])
def test_grown_tree_matches_jax(seed, max_depth):
    bins, meta, grad, hess = _case(seed)
    B = int(meta["num_bin"].max())
    want, want_leaf = jax_grow_tree(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.ones(len(grad), jnp.float32), jnp.ones(bins.shape[0], bool),
        {k: jnp.asarray(v) for k, v in meta.items()},
        num_leaves=15, max_depth=max_depth, num_bins=B,
        params=JaxSplitParams(*PARAMS), two_way=True,
    )
    ds = convert.binned_from_numpy(bins, meta)
    got, got_leaf = grow_tree(
        torch.from_numpy(ds.bins), torch.from_numpy(grad), torch.from_numpy(hess),
        torch.ones(ds.num_features, dtype=torch.bool),
        convert.meta_tensors(ds.feature_meta_arrays()), 15, max_depth, B,
        SplitParams(*PARAMS), True,
        bins_nf=torch.from_numpy(np.ascontiguousarray(bins.T)),
    )
    assert int(got.num_leaves) > 2
    for name in TreeArrays._fields:
        a = np.asarray(getattr(want, name))
        b = getattr(got, name).numpy()
        assert a.shape == b.shape, name
        if name == "split_gain":
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
    np.testing.assert_array_equal(got_leaf.numpy(), np.asarray(want_leaf))
    if max_depth > 0:
        assert int(got.leaf_depth.max()) <= max_depth


def test_tree_arrays_from_numpy_round_trip():
    bins, meta, grad, hess = _case(5, N=500)
    tree, _ = grow_tree(
        torch.from_numpy(bins), torch.from_numpy(grad), torch.from_numpy(hess),
        torch.ones(bins.shape[0], dtype=torch.bool), convert.meta_tensors(meta),
        7, -1, int(meta["num_bin"].max()), SplitParams(*PARAMS),
    )
    back = convert.tree_arrays_from_numpy({k: getattr(tree, k).numpy() for k in TreeArrays._fields})
    for name in TreeArrays._fields:
        assert torch.equal(getattr(back, name), getattr(tree, name)), name
