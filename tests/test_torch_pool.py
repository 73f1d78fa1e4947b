"""The histogram pool (``histogram_pool_size``) in the port, on the CPU,
against the JAX package.

The device loop keeps P < M histograms in LRU slots (ops/grow_state.py;
lightgbm_tpu/ops/grow.py:1479-1536): a split whose parent was evicted builds
both children from their rows (the reference's ``use_subtract=false``
branch). On the CPU the device loop runs its plain versions
(``LIGHTGBM_TPU_HIST_IMPL=cuda``). Data: 4,000 x 6 at ``max_bin=300`` with
``min_data_in_bin=1`` (int16 bins), 31 leaves.

 * The slot count is the JAX package's ``_hist_pool_slots``, formula for
   formula.
 * Trainings at 2, 4 and M - 1 slots against ``lightgbm_tpu.train`` with
   the same pool, both packages' gradients patched to one dyadic rule
   (every sum exact): trees and scores bit for bit, model text byte for
   byte but for the split gains (XLA's fused multiply-adds: each within the
   8-ulp rule of tests/test_torch_categorical.py ``_exact_gains``); and
   equal to the port's unpooled training, since on exact sums a child built
   from its rows equals the parent minus its sibling.
 * ``grow_tree_device(use_subtract=False)``: pooled (4 slots) equals
   unpooled, trees and leaves, as tests/test_hist_pool.py:61-85 holds the
   JAX ``grow_tree``; on its exact gradients both equal the default tree.
"""
import types

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu.objective as jobj
import lightgbm_tpu_torch as tlgb
import lightgbm_tpu_torch.objective as tobj
from lightgbm_tpu.models.gbdt import GBDT as JaxGBDT
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.ops import grow as tgrow
from lightgbm_tpu_torch.ops import grow_state as gs
from lightgbm_tpu_torch.ops import hist_kernel
from lightgbm_tpu_torch.ops.grow import TreeArrays
from lightgbm_tpu_torch.ops.split import SplitParams
from test_torch_categorical import _exact_gains, _gains_apart
from test_torch_widebin import _jax_dyadic, _torch_dyadic

N, F, M, ROUNDS = 4000, 6, 31, 3
TRAIN = {"objective": "binary", "metric": "binary_logloss", "num_leaves": M, "max_bin": 300,
         "min_data_in_bin": 1, "learning_rate": 0.25, "min_data_in_leaf": 20, "verbose": -1}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(seed=0, n=N):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    y = (X[:, 0] + 0.5 * X[:, 1] - 0.3 * X[:, 2] ** 2 + 0.3 * rng.randn(n) > 0).astype(np.float64)
    return X, y


def _pool_mb(slots, num_bins):
    """histogram_pool_size (MB) that gives ``slots`` slots of F·B·3·4 bytes."""
    return (slots + 0.5) * F * num_bins * 12 / (1024 * 1024)


@pytest.mark.parametrize("mb,leaves,num_bins", [
    (0.05, 31, 300), (1.0, 255, 1024), (0.001, 31, 255), (16.0, 255, 1024), (2.0, 15, 63)])
def test_slot_count_is_the_jax_formula(mb, leaves, num_bins):
    cfg = types.SimpleNamespace(histogram_pool_size=mb, num_leaves=leaves)
    jfake = types.SimpleNamespace(config=cfg, num_bins=num_bins, _forced_splits=[],
                                  feature_meta={"num_bin": np.zeros(F)})
    tfake = types.SimpleNamespace(config=cfg, num_bins=num_bins, _forced_splits=[],
                                  train_set=types.SimpleNamespace(num_features=F))
    want = JaxGBDT._hist_pool_slots(jfake)
    got = tlgb.basic._boosting_class("gbdt")._hist_pool_slots(tfake)
    assert got == want


@pytest.fixture(scope="module")
def runs():
    """The JAX package's pooled trainings at 2, 4 and M - 1 slots, and the
    port's unpooled one, on dyadic gradients, once for the module."""
    X, y = _data()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jobj.BinaryLogloss, "get_gradients", _jax_dyadic)
        mp.setattr(tobj.BinaryLogloss, "get_gradients", _torch_dyadic)
        mp.setattr(hist_kernel, "_ENV_IMPL", "cuda")
        free = _train(tlgb, dict(TRAIN), X, y, device="cpu")
        for slots in (2, 4, M - 1):
            params = dict(TRAIN, histogram_pool_size=_pool_mb(slots, free._gbdt.num_bins))
            out[slots] = (params, _train(jlgb, params, X, y))
    return X, y, free, out


def _train(pkg, params, X, y, **kw):
    return pkg.train(dict(params), pkg.Dataset(X, label=y), ROUNDS, **kw)


@pytest.mark.parametrize("slots", [2, 4, M - 1])
def test_pooled_training_equals_jax_and_unpooled(runs, monkeypatch, slots):
    X, y, free, jax_runs = runs
    params, jb = jax_runs[slots]
    monkeypatch.setattr(tobj.BinaryLogloss, "get_gradients", _torch_dyadic)
    monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")
    tb = _train(tlgb, params, X, y, device="cpu")
    g = tb._gbdt
    assert g.grow_loop == "device" and g.hist_pool_slots == slots == jb._gbdt._hist_pool_slots()
    s = g._grow_state
    assert s.P == slots and s.hist.shape[0] == slots and g.bins_dev.dtype == torch.int16
    gains = _exact_gains(tb, params)
    for i, ta in enumerate(g._tree_arrays):
        want = jb._gbdt._device_trees[i][0]
        other = free._gbdt._tree_arrays[i]
        for name in TreeArrays._fields:
            b = getattr(ta, name).numpy()
            np.testing.assert_array_equal(b, getattr(other, name).numpy(), err_msg=name)
            a = np.asarray(getattr(want, name))
            if name == "leaf_value" and i == 0:
                b = b + np.float32(g._init_fold[0])
            if name == "split_gain":
                exact, bound = gains[i]
                n = len(exact)
                for gain in (a, b):
                    assert (np.abs(gain[:n] - exact) <= bound).all(), (i, gain[:n], exact)
            else:
                np.testing.assert_array_equal(b, a, err_msg="tree %d %s" % (i, name))
    np.testing.assert_array_equal(g.scores.numpy(), np.asarray(jb._gbdt.scores))
    (jbody, _), (tbody, _) = (_gains_apart(b.model_to_string()) for b in (jb, tb))
    assert tbody == jbody
    # the last tree's pool: every resident leaf's slot names it back
    nl = int(s.ctl[gs.NUM_LEAVES])
    slot_of, slot_leaf = s.slot_of[:nl].numpy(), s.slot_leaf.numpy()
    resident = slot_of >= 0
    assert resident.sum() <= slots and (slot_leaf[slot_of[resident]] == np.flatnonzero(resident)).all()
    if slots < M - 1:
        assert not resident.all()  # a pool this small evicted leaves


def test_use_subtract_false_pooled_equals_unpooled():
    """tests/test_hist_pool.py:61-85 on the port's device loop (its plain
    versions): every split builds both children from their rows, in 4 LRU
    slots or in M slots (no cap); the trees and leaves are equal, and on
    these exact gradients (multiples of 1/4) equal to the default tree's."""
    X, y = _data(3)
    ds = tlgb.Dataset(X, label=y)
    binned = ds.get_binned(Config.from_params({"max_bin": 63, "objective": "binary"}))
    bins = torch.from_numpy(np.ascontiguousarray(binned.bins))
    meta_np = binned.feature_meta_arrays()
    meta = {k: torch.as_tensor(meta_np[k].astype(np.int32))
            for k in ("num_bin", "missing_type", "default_bin", "monotone")}
    grad = torch.from_numpy((0.5 - y).astype(np.float32))
    hess = torch.full((N,), 0.25)
    fmask = torch.ones(F, dtype=torch.bool)
    params = SplitParams(0.0, 0.0, 0.0, 5, 1e-3, 0.0)
    args = (bins, grad, hess, fmask, meta, M, -1, binned.max_num_bin, params)
    ta, la, sa = tgrow.grow_tree_device(*args, use_subtract=False)
    tb, lb, sb = tgrow.grow_tree_device(*args, use_subtract=False, hist_pool_slots=4)
    assert (sa.P, sb.P) == (M, 4) and not sb.subtract
    for name in TreeArrays._fields:
        assert torch.equal(getattr(ta, name), getattr(tb, name)), name
    assert torch.equal(la, lb) and int(ta.num_leaves) == M
    tc, lc, _ = tgrow.grow_tree_device(*args)
    for name in TreeArrays._fields:
        assert torch.equal(getattr(tc, name), getattr(tb, name)), name
    assert torch.equal(lc, lb)
    # every split of the capped no-subtract tree missed: its pool holds the
    # last split's children, stamped with its step
    assert int(sb.pool_ctl[gs.HIT]) == 0 and int(sb.slot_age.max()) == M
    # a state without slots refuses use_subtract=False
    with pytest.raises(ValueError, match="use_subtract"):
        tgrow.launch_tree(gs.GrowState(bins.device, N, F, binned.max_num_bin, M), bins, grad,
                          hess, fmask, meta, -1, params, use_subtract=False)


def test_graph_replays_carry_the_variant_counts():
    """A captured iteration's replay adds the launches of the int16 and pool
    instantiations too (ops/cuda_graph.py): every instantiation's count is
    among ``launch_counts``, under one key, and ``add_launches`` adds to the
    module that owns it."""
    from lightgbm_tpu_torch.ops import cuda_graph, partition_kernel, predict_kernel, split_kernel

    cuda_graph.reset_launches()
    counts = cuda_graph.launch_counts()
    names = split_kernel.KERNELS + partition_kernel.KERNELS + predict_kernel.KERNELS
    assert not any(counts.values()) and set(names) <= set(counts)
    assert sum(len(m.launches) for m in cuda_graph.KERNEL_MODULES) == len(counts)  # no key twice
    cuda_graph.add_launches({k: 3 for k in names})
    assert all(cuda_graph.launch_counts()[k] == 3 for k in names)
    assert split_kernel.launches["split_pair_fold_rows1024_pool"] == 3
    assert partition_kernel.launches["pick_partition_wide_pool"] == 3
    assert predict_kernel.launches["predict_bins_wide"] == 3
    cuda_graph.reset_launches()
