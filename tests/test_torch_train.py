"""Five binary boosting iterations on a small ``make_higgs_like`` through
the port (device="cpu", the plain versions) and through the JAX package.

 * Bin matrices and bin bounds are identical (same host binning code).
 * Dense Gaussian data makes no EFB groups on the JAX side.
 * Trees are identical in structure unless a split is an f32 near-tie;
   leaf values and raw scores agree to rtol 1e-4 / atol 1e-5 — gradients
   differ by an ulp between XLA's and PyTorch's ``exp``, and the root sums
   are added in different orders, so exact equality is not expected on real
   data.
 * Model text written by either package loads in the other and predicts
   the same raw scores bit for bit (same trees, f64 sums in the same order).

The JAX training is shared by the module through a fixture: its compiles
dominate the file's time.
"""
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from helpers.bench_data import make_higgs_like
from lightgbm_tpu_torch import convert

PARAMS = {
    "objective": "binary", "metric": "auc", "num_leaves": 15,
    "learning_rate": 0.1, "max_bin": 255, "verbose": -1,
}
ROUNDS = 5


@pytest.fixture(scope="module")
def trained():
    X, y = make_higgs_like(3000, 28, seed=3)
    jb = jlgb.train(dict(PARAMS), jlgb.Dataset(X, label=y), num_boost_round=ROUNDS)
    tb = tlgb.train(dict(PARAMS), tlgb.Dataset(X, label=y), ROUNDS, device="cpu")
    return X, y, jb, tb


def test_binning_identical_and_unbundled(trained):
    _, _, jb, tb = trained
    jd, td = jb._gbdt.train_set, tb._gbdt.train_set
    assert not jd.is_bundled
    assert "group_id" not in jd.feature_meta_arrays()
    np.testing.assert_array_equal(td.bins, jd.bins)
    assert td.used_feature_idx == jd.used_feature_idx
    for tm, jm in zip(td.mappers, jd.mappers):
        assert tm.to_dict() == jm.to_dict()


def test_trees_and_scores_agree(trained):
    X, _, jb, tb = trained
    jt, tt = jb._gbdt.trees(), tb._gbdt.trees()
    assert len(jt) == len(tt) == ROUNDS
    for i, (a, b) in enumerate(zip(jt, tt)):
        same = (
            a.num_leaves == b.num_leaves
            and np.array_equal(a.split_feature, b.split_feature)
            and np.array_equal(a.threshold_bin, b.threshold_bin)
            and np.array_equal(a.left_child, b.left_child)
        )
        if not same:
            # a legitimate divergence is a near-tie: the first differing
            # node's gains agree to f32 rounding, and later trees may differ
            k = int(np.argmax(a.split_feature != b.split_feature))
            np.testing.assert_allclose(b.split_gain[k], a.split_gain[k], rtol=1e-5)
            return
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(b.split_gain, a.split_gain, rtol=1e-4)
    np.testing.assert_allclose(
        tb.predict(X, raw_score=True), jb.predict(X, raw_score=True), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        tb._gbdt.train_score(), np.asarray(jb._gbdt.scores)[0], rtol=1e-4, atol=1e-5
    )
    (_, name, auc, _), = tb.eval_train()
    assert name == "auc" and auc > 0.6


def test_model_text_loads_both_ways(trained):
    X, _, jb, tb = trained
    port_text = tb.model_to_string()
    in_jax = jlgb.Booster(model_str=port_text)
    np.testing.assert_array_equal(
        in_jax.predict(X, raw_score=True), tb.predict(X, raw_score=True)
    )
    jax_text = jb.model_to_string()
    in_port = convert.booster_from_model_string(jax_text, device="cpu")
    np.testing.assert_array_equal(
        in_port.predict(X, raw_score=True), jb.predict(X, raw_score=True)
    )
    np.testing.assert_array_equal(in_port.predict(X[:50]), jb.predict(X[:50]))
    # a loaded model writes its trees back unchanged
    assert in_port.model_to_string().split("end of trees")[0] == jax_text.split("end of trees")[0]
