"""The boosting modes GOSS, DART and random forest with the objectives
``lambdarank``, ``regression_l1``, ``quantile`` and ``mape`` in the port
(lightgbm_tpu_torch/models/goss.py, dart.py, rf.py over the renewal and the
lambdas of models/gbdt.py and objective.py), on the CPU, against the JAX
package, each pair through the device loop (its plain versions) with a
validation set.

 * GOSS's renewal reads GOSS's bag, its sample ranks rows by |g·h| of the
   lambdas; random forest renews at its constant scores and takes every
   iteration's gradients (the lambdas too) there; DART renews before it
   rescales the dropped trees. Both packages' gradients pass through one
   rounding to 2^-7 (the lambdas and MAPE's weighted signs are real
   values; L1's and quantile's are exact already), so both grow the same
   trees: the model text equal but its gains and leaf values, each leaf
   within 4 f32 ulps of the JAX package's (the renewal's percentile, PR
   20's bound) or 1e-5 where the renewal is weighted (MAPE), the scores and
   ``evals_result`` close (rtol 1e-5).
 * The host loop equals the device loop byte for byte for every pair.

The JAX package's GOSS with MAPE caches its renewal weights inside its
first traced step and fails at its second trace (after GOSS's warm-up);
the JAX runs here upload them once before training
(``_renew_weights_dev``), which changes no value.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu.objective as jobj
import lightgbm_tpu_torch as tlgb
import lightgbm_tpu_torch.objective as tobj
from lightgbm_tpu_torch.ops import hist_kernel
from test_torch_categorical import _gains_apart
from test_torch_renew import _leaves_apart, _ulps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N, ROUNDS = 1000, 5
TRAIN = {"num_leaves": 7, "learning_rate": 0.5, "min_data_in_leaf": 10, "alpha": 0.75,
         "verbose": -1}
# GOSS at N = 1000: top_k 250, other_k 250, amplification 3; warm-up 2 iterations
MODES = {
    "goss": {"boosting": "goss", "top_rate": 0.25, "other_rate": 0.25},
    "dart": {"boosting": "dart", "skip_drop": 0.0, "drop_rate": 0.4},
    "rf": {"boosting": "rf", "bagging_fraction": 0.5, "bagging_freq": 1},
}
OBJECTIVES = ["lambdarank", "regression_l1", "quantile", "mape"]


def _round_gradients(get):
    def get_gradients(self, score):
        g, h = get(self, score)
        return (g * 128.0).round() / 128.0, (h * 128.0).round().clip(1.0) / 128.0
    return get_gradients


def _patch(mp):
    """Both packages' LambdaRank and MAPE gradients through one rounding to 2^-7."""
    for mod in (jobj, tobj):
        for cls in (mod.LambdarankNDCG, mod.RegressionMAPELoss):
            mp.setattr(cls, "get_gradients", _round_gradients(cls.get_gradients))


def _data(objective, seed):
    rng = np.random.RandomState(seed)
    if objective == "lambdarank":
        sizes = rng.randint(2, 40, 60 if seed == 0 else 20)
        X = rng.randn(sizes.sum(), 5)
        y = np.clip(np.round(X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.randn(len(X)) + 1), 0, 4)
        return X, y, sizes
    n = N if seed == 0 else 300
    X = rng.randn(n, 5)
    y = 2.0 * X[:, 0] - X[:, 1] + 0.5 * rng.randn(n) + 4.0
    return X, y, None


def _run(pkg, mode, objective, **kw):
    params = dict(TRAIN, objective=objective, **MODES[mode])
    X, y, group = _data(objective, 0)
    Xv, yv, gv = _data(objective, 1)
    ds = pkg.Dataset(X, label=y, group=group)
    bst = pkg.Booster(params, ds, **kw)
    if pkg is jlgb and objective == "mape":
        bst._gbdt.objective._renew_weights_dev()
    bst.add_valid(pkg.Dataset(Xv, label=yv, group=gv, reference=ds), "v")
    res = []
    for _ in range(ROUNDS):
        bst.update()
        res.append(bst.eval_valid())
    return bst, res, X, Xv


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("mode", list(MODES))
def test_mode_and_objective_equal_jax(monkeypatch, mode, objective):
    _patch(monkeypatch)
    jb, jres, X, Xv = _run(jlgb, mode, objective)
    monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")
    tb, tres, _, _ = _run(tlgb, mode, objective, device="cpu")
    g = tb._gbdt
    assert g.grow_loop == "device" and type(g).__name__ == type(jb._gbdt).__name__
    assert g._renew == (objective != "lambdarank") and tb.num_trees() == jb.num_trees() == ROUNDS
    (jbody, jleaves), (tbody, tleaves) = (_leaves_apart(_gains_apart(b.model_to_string())[0])
                                          for b in (jb, tb))
    assert tbody == jbody
    if objective == "mape":
        np.testing.assert_allclose(tleaves, jleaves, rtol=1e-5, atol=1e-6)
    else:
        assert _ulps(tleaves, jleaves).max() <= 4, (tleaves, jleaves)
    np.testing.assert_allclose(g.scores.numpy(), np.asarray(jb._gbdt.scores), rtol=1e-5, atol=1e-5)
    for data in (X, Xv):
        np.testing.assert_allclose(tb.predict(data), jb.predict(data), rtol=1e-5, atol=1e-5)
    assert [[e[:2] for e in r] for r in tres] == [[e[:2] for e in r] for r in jres]
    np.testing.assert_allclose([e[2] for r in tres for e in r], [e[2] for r in jres for e in r],
                               rtol=1e-5, atol=1e-7)
    if mode == "goss":  # past the warm-up the renewal read the sample's bag
        assert g._bag is g._goss_mask and int(g._bag.sum()) == sum(g._goss_k)
    if mode == "dart":
        assert any(w != g.tree_weight[-1] for w in g.tree_weight[:-1])


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("mode", list(MODES))
def test_host_loop_equals_device_loop(monkeypatch, mode, objective):
    runs = []
    for impl in (None, "cuda"):
        monkeypatch.setattr(hist_kernel, "_ENV_IMPL", impl)
        bst, res, _, _ = _run(tlgb, mode, objective, device="cpu")
        runs.append((bst.model_to_string(), bst._gbdt.scores.numpy().tobytes(), res,
                     bst._gbdt.grow_loop))
    (ht, hs, hres, hl), (dt, ds, dres, dl) = runs
    assert (hl, dl) == ("host", "device")
    assert ht == dt and hs == ds and hres == dres
