"""The CPU's default run of the port with forced splits, CEGB,
``tpu_hist_mode=masked`` or a histogram pool, against ``lightgbm_tpu.train``.

Without a route table or ``LIGHTGBM_TPU_HIST_IMPL`` the CPU's histograms go
to the plain ``scatter``, which the host split loop runs; the four grow
only on the device loop, so such a run takes the device loop on its
kernels' plain versions (ops/grow.py ``device_loop_routable``), as the JAX
package trains all four on the CPU. Both packages' binary gradients go
through one dyadic rule (tests/test_torch_widebin.py), so every sum is
exact: the model text is equal but for the gains, which XLA's fused
multiply-adds move (within rtol 1e-5), and the trees' arrays are equal.
A run without any of the four keeps the host loop.
"""
import json

import numpy as np
import pytest

import lightgbm_tpu.objective as jobj
import lightgbm_tpu_torch as tlgb
import lightgbm_tpu_torch.objective as tobj
from lightgbm_tpu_torch.ops import hist_kernel
from test_torch_widebin import _jax_dyadic, _torch_dyadic
from torch_forced_cegb_helpers import BASE, one_torch_thread, same_models, same_state  # noqa: F401
from torch_forced_cegb_helpers import train_both


@pytest.fixture
def dyadic(monkeypatch):
    """Both packages' gradients through one dyadic rule, and no env override."""
    monkeypatch.setattr(jobj.BinaryLogloss, "get_gradients", _jax_dyadic)
    monkeypatch.setattr(tobj.BinaryLogloss, "get_gradients", _torch_dyadic)
    monkeypatch.setattr(hist_kernel, "_ENV_IMPL", None)


def _data(n=1200, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    logit = X[:, 0] + 0.8 * X[:, 1] + 0.6 * X[:, 2] + 0.2 * rng.randn(n)
    return X, (logit > 0).astype(np.float64)


def _forced(tmp_path):
    path = tmp_path / "forced.json"
    path.write_text(json.dumps({"feature": 2, "threshold": 0.0,
                                "left": {"feature": 1, "threshold": -0.5}}))
    return {"forcedsplits_filename": str(path)}


CASES = {
    "forced": _forced,
    "cegb": lambda _: {"cegb_penalty_split": 0.01, "cegb_penalty_feature_coupled": [2.0] * 6,
                       "cegb_penalty_feature_lazy": [0.005] * 6},
    "masked": lambda _: {"tpu_hist_mode": "masked"},
    "pool": lambda _: {"histogram_pool_size": 4.5 * 6 * 63 * 12 / (1024 * 1024)},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_default_cpu_run_takes_the_device_loop(dyadic, tmp_path, case):
    assert hist_kernel.env_impl() is None
    X, y = _data(seed=len(case))
    params = dict(BASE, **CASES[case](tmp_path))
    jb, tb = train_both(params, X, y, 3)  # asserts the device loop
    g = tb._gbdt
    assert g.hist_route is None and g._grow_state is not None
    same_models(jb, tb)
    for i, ta in enumerate(g._tree_arrays):
        want = jb._gbdt._device_trees[i][0]
        for name in ("num_leaves", "split_feature", "threshold_bin", "default_left",
                     "left_child", "right_child", "leaf_count", "leaf_parent", "leaf_depth"):
            np.testing.assert_array_equal(getattr(ta, name).numpy(), np.asarray(getattr(want, name)),
                                          err_msg="tree %d %s" % (i, name))
    if case == "forced":
        assert all(ta.split_feature[:2].tolist() == [2, 1] for ta in g._tree_arrays)
    if case == "cegb":
        same_state(jb, tb)
    if case == "pool":
        assert g.hist_pool_slots == 4 == jb._gbdt._hist_pool_slots()
        assert g._grow_state.P == 4


def test_other_cpu_runs_keep_the_host_loop(monkeypatch):
    """A run with none of the four, or with a pool no smaller than the
    leaves (no cap: the JAX package's ``_hist_pool_slots`` is None), keeps
    the host loop."""
    monkeypatch.setattr(hist_kernel, "_ENV_IMPL", None)
    X, y = _data(n=400)
    for extra in ({}, {"histogram_pool_size": 64.0}):
        tb = tlgb.train(dict(BASE, **extra), tlgb.Dataset(X, label=y), 2, device="cpu")
        g = tb._gbdt
        assert g.grow_loop == "host" and g._grow_state is None and g.hist_pool_slots is None
