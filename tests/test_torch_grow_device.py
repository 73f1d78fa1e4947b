"""The device-resident split loop (lightgbm_tpu_torch/ops/grow.py
``grow_tree_device``), run on the CPU through its kernels' plain versions,
against the JAX package. Its comparisons with the host loop, the stable
partition and the loop's routing are in tests/test_torch_grow_device_host.py
(the file is split so that each half stays quick under ``--dist loadfile``);
both take this file's fixtures (``_case``, ``_torch_args``).

 * Against the JAX package: one tree grown by the loop and by
   ``lightgbm_tpu.ops.grow.grow_tree`` from the same binned data and the
   same dyadic gradients and hessians (multiples of 1/64, so every
   histogram sum is exact), over seeds, ``max_depth`` -1 and 3,
   ``num_leaves`` 2, 15 and 63, missing types none / zero / nan / mixed,
   monotone +1 and -1 features, and a fixture whose growth stops early
   (no split left with a gain > 0). Every TreeArrays field and the per-row
   leaf index must be equal bit for bit, except ``split_gain``, held to
   rtol 1e-6: XLA on the CPU contracts the gain's multiply-adds into fused
   multiply-adds and the port does not (tests/test_torch_split.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.grow import grow_tree as jax_grow_tree
from lightgbm_tpu.ops.split import SplitParams as JaxSplitParams
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.ops.grow import TreeArrays, grow_tree_device
from lightgbm_tpu_torch.ops.split import SplitParams

PARAMS = (0.0, 1.0, 0.0, 5, 1e-3, 0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors (the workers of a
    parallel run share the machine's cores). Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(seed, N=2001, F=6, B=63, missing=None):
    """Binned data with features of 3..B bins, missing types 0/1/2 by
    feature (or all ``missing``), a +1 and a -1 monotone feature, and dyadic
    gradients and hessians."""
    rng = np.random.RandomState(seed)
    num_bin = rng.randint(3, B + 1, F).astype(np.int32)
    num_bin[0] = B
    bins = np.stack([rng.randint(0, nb, N) for nb in num_bin]).astype(np.uint8)
    meta = {
        "num_bin": num_bin,
        "missing_type": (np.arange(F) % 3 if missing is None else np.full(F, missing)).astype(np.int32),
        "default_bin": rng.randint(0, 3, F).astype(np.int32),
        "monotone": np.zeros(F, np.int8),
    }
    meta["monotone"][1] = 1
    meta["monotone"][2] = -1
    grad = (rng.randint(-64, 65, N) / 64.0).astype(np.float32)
    hess = (rng.randint(1, 65, N) / 64.0).astype(np.float32)
    return bins, meta, grad, hess


def _torch_args(bins, meta, grad, hess, num_leaves, max_depth, params=PARAMS):
    ds = convert.binned_from_numpy(bins, meta)
    B = int(meta["num_bin"].max())
    args = (
        torch.from_numpy(ds.bins), torch.from_numpy(grad), torch.from_numpy(hess),
        torch.ones(ds.num_features, dtype=torch.bool),
        convert.meta_tensors(ds.feature_meta_arrays()), num_leaves, max_depth, B,
        SplitParams(*params), True,
    )
    return args, torch.from_numpy(np.ascontiguousarray(bins.T))


def _assert_trees_equal(got, got_leaf, want, want_leaf, gain_rtol=0.0):
    for name in TreeArrays._fields:
        a = np.asarray(want[name] if isinstance(want, dict) else getattr(want, name))
        b = getattr(got, name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, (name, a.shape, b.shape, a.dtype, b.dtype)
        if name == "split_gain" and gain_rtol:
            np.testing.assert_allclose(b, a, rtol=gain_rtol, atol=0)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
    np.testing.assert_array_equal(np.asarray(got_leaf), np.asarray(want_leaf))


# (seed, num_leaves, max_depth, missing types, rows, min_data_in_leaf)
JAX_CASES = {
    "mixed": (0, 15, -1, None, 2001, 5),
    "mixed_depth3": (1, 15, 3, None, 2001, 5),
    "leaves63": (2, 63, -1, None, 2001, 5),
    "leaves2": (3, 2, -1, None, 2001, 5),
    "missing_none": (4, 15, -1, 0, 2001, 5),
    "missing_zero": (5, 15, -1, 1, 2001, 5),
    "missing_nan": (6, 15, -1, 2, 2001, 5),
    "stops_early": (7, 63, -1, None, 300, 20),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_device_loop_matches_jax(case):
    seed, M, max_depth, missing, N, min_data = JAX_CASES[case]
    bins, meta, grad, hess = _case(seed, N=N, missing=missing)
    B = int(meta["num_bin"].max())
    params = PARAMS[:3] + (min_data,) + PARAMS[4:]
    want, want_leaf = jax_grow_tree(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.ones(len(grad), jnp.float32), jnp.ones(bins.shape[0], bool),
        {k: jnp.asarray(v) for k, v in meta.items()},
        num_leaves=M, max_depth=max_depth, num_bins=B,
        params=JaxSplitParams(*params), two_way=True,
    )
    args, nf = _torch_args(bins, meta, grad, hess, M, max_depth, params)
    got, got_leaf, _ = grow_tree_device(*args, bins_nf=nf)
    want = {k: np.asarray(v) for k, v in want._asdict().items()}
    _assert_trees_equal(got, got_leaf, want, want_leaf, gain_rtol=1e-6)
    nl = int(got.num_leaves)
    if case == "stops_early":
        assert 2 < nl < M, nl
    elif max_depth > 0:
        assert int(got.leaf_depth.max()) == max_depth and nl == 2 ** max_depth, nl
    else:
        assert nl == M, nl
    if missing is not None:
        assert set(meta["missing_type"]) == {missing}
