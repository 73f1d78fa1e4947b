"""Forced splits and CEGB in whole trainings of the port, on the CPU,
against ``lightgbm_tpu.train`` (tests/test_forced_cegb.py's serial
fixtures), both packages' binary gradients through one dyadic rule
(tests/test_torch_widebin.py), the device loop running its kernels' plain
versions (``LIGHTGBM_TPU_HIST_IMPL=cuda``).

 * Tolerance tier: the model text equal but for the gains (XLA's roundings
   move them), the gains within rtol 1e-5: the JSON forced root, its BFS
   wiring and an abort by an unknown feature; the three penalties together
   with bagging; an EFB-bundled table with CEGB (with forced splits:
   tests/test_torch_forced_efb.py, a file of its own so that each stays
   under a minute); and the CEGB state (paid features and rows) equal
   after the training.
 * Multiclass shares one CEGB state across its classes (real-valued
   gradients: the same structure, the floats within rtol 1e-5), and a
   coupled penalty's features, once paid, are the only ones used.
 * The tradeoff scaling equality: tradeoff * k with the penalties / k gives
   the same model text.
 * Chunks of 4 iterations equal single iterations byte for byte, trees,
   scores and state; a rollback leaves the state as it is; a continued
   training (``init_model``) starts a fresh one.
 * What stays out raises NotImplementedError naming it: the three
   parameters, and CEGB with a histogram pool, on the host split loop (a
   routed run).
"""
import json

import numpy as np
import pytest

import lightgbm_tpu_torch as tlgb
from torch_forced_cegb_helpers import BASE, device_loop, efb_table, one_torch_thread  # noqa: F401
from torch_forced_cegb_helpers import cegb_state, same_models, same_state, train_both
from test_torch_boundaries import routed_to_the_host_loop



def _data(n=1500, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    logit = X[:, 0] + 0.8 * X[:, 1] + 0.6 * X[:, 2] + 0.2 * rng.randn(n)
    return X, (logit > 0).astype(np.float64)


def _close_models(jb, tb, rtol=1e-5):
    """Model text with the same structure (every key and every integer
    field equal), its floats within ``rtol``: a training on real-valued
    gradients, whose sums differ in their last bits."""
    ints = ("split_feature", "threshold", "decision_type", "left_child", "right_child",
            "leaf_count", "internal_count", "num_leaves", "num_cat", "Tree")
    ja, ta = (b.model_to_string().split("parameters:")[0].splitlines() for b in (jb, tb))
    assert len(ja) == len(ta)
    for a, b in zip(ja, ta):
        if a == b or a.startswith("tree_sizes"):
            continue
        ka, va = a.split("=", 1)
        kb, vb = b.split("=", 1)
        assert ka == kb and ka not in ints, (a, b)
        np.testing.assert_allclose(np.asarray(vb.split(), float), np.asarray(va.split(), float),
                                   rtol=rtol, atol=1e-7, err_msg=ka)


def test_forced_json_root_bfs_and_unknown_feature(device_loop, tmp_path, caplog):
    X, y = _data(n=600, seed=1)
    fs = tmp_path / "forced.json"
    fs.write_text(json.dumps({
        "feature": 4, "threshold": 0.0,
        "left": {"feature": 5, "threshold": -0.5, "left": {"feature": 99, "threshold": 0.0}},
        "right": {"feature": 3, "threshold": 0.5}}))
    jb, tb = train_both(dict(BASE, forcedsplits_filename=str(fs)), X, y, 3)
    same_models(jb, tb)
    assert tb._gbdt._forced_splits == jb._gbdt._forced_splits and len(tb._gbdt._forced_splits) == 3
    for ta in tb._gbdt._tree_arrays:
        assert ta.split_feature[:3].tolist() == [4, 5, 3]
        assert ta.left_child[0] == 1 and ta.right_child[0] == 2


def test_penalties_together_with_bagging(device_loop):
    X, y = _data(seed=4)
    F = X.shape[1]
    params = dict(BASE, cegb_penalty_split=0.01, cegb_penalty_feature_coupled=[2.0] * F,
                  cegb_penalty_feature_lazy=[0.005] * F, bagging_fraction=0.7, bagging_freq=1)
    jb, tb = train_both(params, X, y, 3)
    assert sum(t.num_leaves for t in tb._gbdt.trees()) > 6
    same_models(jb, tb)
    same_state(jb, tb)


def test_tradeoff_scaling_equality(device_loop):
    """tradeoff * k with the penalties / k gives the same trees."""
    X, y = _data(seed=5)
    F = X.shape[1]
    for pen in ({"cegb_penalty_split": 0.02}, {"cegb_penalty_feature_coupled": [2.0] * F},
                {"cegb_penalty_feature_lazy": [0.01] * F}):
        scaled = {k: ([x * 8 for x in v] if isinstance(v, list) else v * 8) for k, v in pen.items()}
        a = tlgb.train(dict(BASE, cegb_tradeoff=8.0, **pen), tlgb.Dataset(X, label=y), 3,
                       device="cpu")
        b = tlgb.train(dict(BASE, cegb_tradeoff=1.0, **scaled), tlgb.Dataset(X, label=y), 3,
                       device="cpu")
        assert a.model_to_string().split("parameters:")[0] == \
            b.model_to_string().split("parameters:")[0], pen


def test_coupled_amortises_and_multiclass_shares_one_state(device_loop):
    X, y = _data(seed=7)
    y3 = np.digitize(X[:, 0] + 0.5 * X[:, 1], [-0.5, 0.5]).astype(np.float64)
    F = X.shape[1]
    params = dict(BASE, objective="multiclass", num_class=3,
                  cegb_penalty_feature_coupled=[30.0] * F, num_leaves=7)
    jb, tb = train_both(params, X, y3, 3)
    _close_models(jb, tb)
    same_state(jb, tb)
    paid = tb._gbdt._cegb.feature_used.numpy()
    used = {int(f) for t in tb._gbdt.trees() for f in t.split_feature[:t.num_leaves - 1]}
    assert used == set(np.flatnonzero(paid))  # each tree and class used only what was paid


def test_efb_with_cegb(device_loop):
    X, y = efb_table(3)
    params = dict(BASE, cegb_penalty_split=0.01, cegb_penalty_feature_lazy=[0.01] * 14,
                  cegb_penalty_feature_coupled=[1.0] * 14, max_conflict_rate=0.0)
    jb, tb = train_both(params, X, y, 3)
    assert tb._gbdt.num_groups > 0
    same_models(jb, tb)
    same_state(jb, tb)


def test_chunks_equal_single_iterations_and_rollback_keeps_state(device_loop, tmp_path):
    X, y = _data(seed=2)
    F = X.shape[1]
    fs = tmp_path / "forced.json"
    fs.write_text(json.dumps({"feature": 5, "threshold": 0.25}))
    params = dict(BASE, forcedsplits_filename=str(fs), cegb_penalty_split=0.01,
                  cegb_penalty_feature_coupled=[2.0] * F, cegb_penalty_feature_lazy=[0.01] * F,
                  bagging_fraction=0.8, bagging_freq=1)
    one = tlgb.train(dict(params), tlgb.Dataset(X, label=y), 6, device="cpu")
    four = tlgb.train(dict(params, device_chunk_size=4), tlgb.Dataset(X, label=y), 6,
                      device="cpu")
    assert four._gbdt.device_chunk() == 4
    assert four.model_to_string().split("parameters:")[0] == \
        one.model_to_string().split("parameters:")[0]
    assert np.array_equal(four._gbdt.train_score(), one._gbdt.train_score())
    for a, b in zip(cegb_state(one), cegb_state(four)):
        np.testing.assert_array_equal(a, b)
    before = [v.copy() for v in cegb_state(one)]
    one.rollback_one_iter()
    for a, b in zip(before, cegb_state(one)):
        np.testing.assert_array_equal(a, b)
    # a continued training starts a fresh state
    # (the JAX package's _setup_cegb at set-up): only the new tree's features
    # are paid, and only they have paid rows
    more = tlgb.train(dict(params), tlgb.Dataset(X, label=y), 1, init_model=one, device="cpu")
    assert more._gbdt._cegb is not one._gbdt._cegb
    new = more._gbdt.trees()[-1]
    split = np.zeros(F, bool)
    split[new.split_feature[:new.num_leaves - 1]] = True
    paid, rows = cegb_state(more)
    np.testing.assert_array_equal(paid, split)
    np.testing.assert_array_equal(rows.any(axis=1), split)
    assert rows.sum() < before[1].sum()  # the old state's rows, paid over 5 trees, are not kept


@pytest.mark.parametrize("extra,name", [
    ({"forcedsplits_filename": "forced.json"}, "forcedsplits_filename"),
    ({"cegb_penalty_split": 0.5}, "cegb_penalty_"),
    ({"tpu_hist_mode": "masked"}, "tpu_hist_mode=masked")])
def test_host_loop_refuses_by_name(tmp_path, monkeypatch, extra, name):
    """On a routed run (the host split loop); the CPU's default run trains
    them on the device loop (tests/test_torch_cpu_default.py)."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "forced.json").write_text(json.dumps({"feature": 0, "threshold": 0.0}))
    X, y = _data(n=300)
    routed_to_the_host_loop(monkeypatch, len(y))
    with pytest.raises(NotImplementedError, match=name + ".*host split loop"):
        tlgb.train(dict(BASE, **extra), tlgb.Dataset(X, label=y), 1, device="cpu")


def test_cegb_with_a_pool_refuses_by_name(monkeypatch):
    """CEGB with a pool trains on the device loop (tests/test_torch_cegb_pool.py
    holds it to the JAX package's pooled trees); a routed run refuses both
    by name."""
    X, y = _data(n=300)
    routed_to_the_host_loop(monkeypatch, len(y))
    with pytest.raises(NotImplementedError, match="cegb_penalty_.*host split loop"):
        tlgb.train(dict(BASE, cegb_penalty_split=0.5, histogram_pool_size=0.01),
                   tlgb.Dataset(X, label=y), 1, device="cpu")
    with pytest.raises(NotImplementedError, match="histogram_pool_size on the host split loop"):
        tlgb.train(dict(BASE, histogram_pool_size=0.01), tlgb.Dataset(X, label=y), 1,
                   device="cpu")
