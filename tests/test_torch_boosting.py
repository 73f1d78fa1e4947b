"""The boosting modes GOSS, DART and random forest in the port
(lightgbm_tpu_torch/models/goss.py, dart.py, rf.py and the hooks of
models/gbdt.py), on the CPU, against the JAX package.

 * GOSS's bag and amplification (``goss_mask_amp`` on the permutation
   ``draw_permutation`` draws) equal the JAX package's ``_goss_mask_amp``
   bit for bit for several seeds, iterations, row counts, class counts and
   rates: dyadic gradients with many tied scores, rows of zero score, real
   values, and the ``other_k`` and ``top_k`` clamps.
 * Whole trainings of GOSS (past its warm-up of ``1 / learning_rate``
   iterations), DART (weighted and uniform drops, ``xgboost_dart_mode``,
   ``skip_drop`` 0 so that it drops) and random forest (bagged), each with
   K = 1 and K = 3, on a dense numerical table with a validation set and
   early stopping (off under DART, as in the JAX package), through the
   device loop (its plain versions), both packages' gradients through
   tests/test_torch_categorical.py's dyadic rule: the model text equal but
   its gains, each package's gains within 8 f32 ulps of the exact f64 gain
   (XLA contracts the gain's multiply-adds: rtol 1e-6 does not hold where
   the terms cancel), the training and validation scores and
   ``evals_result`` equal, and the predictions equal. The host loop equals
   the device loop for each mode, and each mode trains on
   tests/test_torch_efb.py's EFB-bundled table with a categorical column
   as the JAX package does.
 * The repair of ``average_output``: a random-forest model text of the
   JAX package loaded into the port, and the port's loaded into the JAX
   package, predict equal, with and without ``num_iteration``.
 * The errors the JAX package raises: GOSS with bagging or rates out of
   range, random forest without bagging; and each mode's
   ``device_chunk_fallback_reason``, which is the JAX package's.
"""
import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu.objective as jobj
import lightgbm_tpu_torch as tlgb
import lightgbm_tpu_torch.objective as tobj
from lightgbm_tpu.models.goss import _goss_mask_amp
from lightgbm_tpu_torch.models.gbdt import GBDT, draw_permutation
from lightgbm_tpu_torch.models.goss import GOSS, goss_mask_amp
from lightgbm_tpu_torch.ops import hist_kernel
from lightgbm_tpu_torch.utils.log import LightGBMError
from test_torch_categorical import _exact_gains, _gains_apart, _jax_dyadic, _torch_dyadic
from test_torch_efb import CAT, _onehot


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- GOSS's sample against _goss_mask_amp ------------------------------------


def _gradients(kind, n, K, seed):
    """[K, n] f32 gradients and hessians: ``dyadic`` ones from a few values
    (most scores tied), ``zeros`` with a third of the gradients 0 (tied at
    score 0), ``real`` ones from a normal draw."""
    rng = np.random.RandomState(seed)
    if kind == "real":
        return (rng.randn(K, n).astype(np.float32),
                (rng.rand(K, n) * 0.25 + 0.01).astype(np.float32))
    g = (rng.randint(-4, 5, (K, n)) / 4.0).astype(np.float32)
    h = (rng.randint(1, 3, (K, n)) / 2.0).astype(np.float32)
    if kind == "zeros":
        g[rng.rand(K, n) < 0.33] = 0.0
    return g, h


GOSS_CASES = [  # (seed, iteration, n, K, top_rate, other_rate, values)
    (3, 5, 1000, 1, 0.2, 0.1, "dyadic"),
    (7, 11, 1000, 3, 0.3, 0.2, "dyadic"),
    (11, 4, 4000, 1, 0.1, 0.1, "zeros"),
    (0, 0, 997, 3, 0.1, 0.5, "real"),
    (42, 123456, 5000, 1, 0.05, 0.05, "real"),
    (2 ** 31 + 5, 9, 600, 3, 0.25, 0.25, "zeros"),
    (5, 2, 7, 1, 0.1, 0.1, "dyadic"),  # top_k and other_k clamp up to 1
    (9, 3, 50, 3, 0.5, 0.5, "dyadic"),  # other_k takes every row past the top
    (13, 1, 3, 1, 0.34, 0.66, "real"),
]


@pytest.mark.parametrize("case", range(len(GOSS_CASES)))
def test_goss_sample_equals_jax(case):
    seed, it, n, K, top_rate, other_rate, kind = GOSS_CASES[case]
    top_k = max(1, int(n * top_rate))
    other_k = min(max(1, int(n * other_rate)), n - top_k)
    g, h = _gradients(kind, n, K, seed)
    key = jax.random.fold_in(jax.random.PRNGKey(seed & 0x7FFFFFFF), it)
    want_mask, want_amp = (np.asarray(a) for a in _goss_mask_amp(key, g, h, top_k, other_k))
    perm = draw_permutation(seed, it, n - top_k, "cpu")
    mask, amp = goss_mask_amp(torch.from_numpy(g), torch.from_numpy(h), perm, top_k, other_k)
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    np.testing.assert_array_equal(amp.numpy(), want_amp)
    assert int(mask.sum()) == top_k + other_k and int((amp != 1.0).sum()) <= other_k
    # the amplified gradients, as GOSS._bagging returns them
    np.testing.assert_array_equal((torch.from_numpy(g) * amp).numpy(), g * want_amp)
    # into given buffers, as the captured iteration writes them
    out_m, out_a = torch.full((n,), 7.0), torch.full((n,), 7.0)
    assert goss_mask_amp(torch.from_numpy(g), torch.from_numpy(h), perm, top_k, other_k,
                         out_m, out_a)[0] is out_m
    assert torch.equal(out_m, mask) and torch.equal(out_a, amp)


# ---- whole trainings against the JAX package ----------------------------------

N, NV, ROUNDS = 2000, 500, 8
TRAIN = {"num_leaves": 15, "learning_rate": 0.25, "min_data_in_leaf": 20, "cat_smooth": 5.0,
         "min_data_per_group": 20, "max_cat_threshold": 16, "verbose": -1}


def _numeric(seed, n, K):
    """Five continuous columns and two binary ones; the label (K = 1) or the
    class (K = 3) follows four of them and noise."""
    rng = np.random.RandomState(seed)
    X = np.c_[rng.randn(n, 5), rng.rand(n, 2) < 0.3]
    z = X[:, 0] + 0.5 * X[:, 1] * X[:, 5] - 0.7 * X[:, 2] + 0.3 * rng.randn(n)
    if K == 1:
        return X, (z > 0).astype(np.float64)
    return X, np.digitize(z, [-0.7, 0.6]).astype(np.float64)

# GOSS at N = 2000: top_k 400, other_k 200, amplification 8 (dyadic); warm-up 4
MODES = {
    "goss": {"boosting": "goss", "top_rate": 0.2, "other_rate": 0.1},
    "dart": {"boosting": "dart", "skip_drop": 0.0, "drop_rate": 0.3},
    "dart_uniform": {"boosting": "dart", "skip_drop": 0.0, "drop_rate": 0.3, "uniform_drop": True},
    "dart_xgboost": {"boosting": "dart", "skip_drop": 0.0, "drop_rate": 0.3,
                     "xgboost_dart_mode": True},
    "rf": {"boosting": "random_forest", "bagging_fraction": 0.5, "bagging_freq": 1,
           "feature_fraction": 0.8},
}
OBJECTIVES = {
    1: {"objective": "binary", "metric": ["binary_logloss", "auc"]},
    3: {"objective": "multiclass", "num_class": 3, "metric": "multi_logloss"},
}


def _patch_dyadic(mp):
    """tests/test_torch_categorical.py's dyadic gradients in both packages."""
    mp.setattr(jobj.BinaryLogloss, "get_gradients", _jax_dyadic(lambda o: (o._y_dev + 1.0) / 2.0))
    mp.setattr(tobj.BinaryLogloss, "get_gradients", _torch_dyadic(lambda o: (o._y + 1.0) / 2.0))
    mp.setattr(jobj.MulticlassSoftmax, "get_gradients", _jax_dyadic(lambda o: o._onehot_dev))
    mp.setattr(tobj.MulticlassSoftmax, "get_gradients", _torch_dyadic(lambda o: o._onehot))


def _record_gradients(mp):
    """Record, at each iteration of the port, the gradients and hessians its
    trees take (after the mode's ``_bagging``) times the bag, as f64 numpy
    [K, N] pairs: the histograms' values, for test_torch_categorical.py's
    ``_exact_gains``."""
    log = []
    for cls in (GBDT, GOSS):
        def rec(self, grad, hess, orig=cls._bagging):
            g, h = orig(self, grad, hess)
            w = 1.0 if self._bag is None else self._bag.double().numpy()
            log.append((g.double().numpy() * w, h.double().numpy() * w))
            return g, h
        mp.setattr(cls, "_bagging", rec)
    return log


def _train(pkg, params, K, rounds=ROUNDS, data=None, **kw):
    X, y, Xv, yv, cats = data or (*_numeric(1, N, K), *_numeric(2, NV, K), "auto")
    ds = pkg.Dataset(X, label=y, categorical_feature=cats)
    vs = pkg.Dataset(Xv, label=yv, reference=ds)
    res = {}
    bst = pkg.train(dict(params), ds, rounds, valid_sets=[vs], evals_result=res,
                    early_stopping_rounds=3, verbose_eval=False, **kw)
    return bst, res, Xv


_jax_runs = {}


def _jax_run(mode, K):
    """The JAX package's dyadic training of (``mode``, K), run once."""
    if (mode, K) not in _jax_runs:
        with pytest.MonkeyPatch.context() as mp:
            _patch_dyadic(mp)
            _jax_runs[mode, K] = _train(jlgb, dict(TRAIN, **MODES[mode], **OBJECTIVES[K]), K)
    return _jax_runs[mode, K]


def _assert_equal_runs(jrun, trun, grads, params):
    """The model text equal but its gains; each node's gain, on both sides,
    within the f32 bound of the exact f64 gain (XLA on the CPU contracts
    the gain's multiply-adds, the port rounds each op: up to a few ulps of
    the terms apart); then the scores, evals_result and predictions."""
    (jb, jres, Xv), (tb, tres, _) = jrun, trun
    assert tb.num_trees() == jb.num_trees() and tb.best_iteration == jb.best_iteration
    (jbody, jgains), (tbody, tgains) = _gains_apart(jb.model_to_string()), \
        _gains_apart(tb.model_to_string())
    assert tbody == jbody
    gains = _exact_gains(tb, params, grads)
    for i, ta in enumerate(tb._gbdt._tree_arrays):
        exact, bound = gains[i]
        n = len(exact)
        for gain in (np.asarray(jb._gbdt._device_trees[i][0].split_gain), ta.split_gain.numpy()):
            assert (np.abs(gain[:n] - exact) <= bound).all(), (i, gain[:n], exact, bound)
    bound = np.concatenate([b_ for _, b_ in gains])
    assert (np.abs(tgains - jgains) <= 2 * bound + 1e-7 * np.abs(jgains)).all()  # 8 digits
    np.testing.assert_array_equal(tb._gbdt.scores.numpy(), np.asarray(jb._gbdt.scores))
    np.testing.assert_array_equal(tb._gbdt.valid_scores[0].numpy(),
                                  np.asarray(jb._gbdt.valid_scores[0]))
    np.testing.assert_array_equal(tb._gbdt.train_score(), jb._gbdt._train_score_np())
    assert tres == jres
    for raw in (True, False):
        np.testing.assert_array_equal(tb.predict(Xv, raw_score=raw), jb.predict(Xv, raw_score=raw))


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("mode", list(MODES))
def test_training_equals_jax(monkeypatch, mode, K):
    jrun = _jax_run(mode, K)
    _patch_dyadic(monkeypatch)
    grads = _record_gradients(monkeypatch)
    monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")  # the device loop's plain versions
    params = dict(TRAIN, **MODES[mode], **OBJECTIVES[K])
    trun = _train(tlgb, params, K, device="cpu")
    g = trun[0]._gbdt
    assert g.grow_loop == "device" and type(g).__name__ == type(jrun[0]._gbdt).__name__
    assert g.current_iteration > (4 if mode == "goss" else 2)
    _assert_equal_runs(jrun, trun, grads, params)
    text = trun[0].model_to_string()
    assert ("\naverage_output\n" in text) == (mode == "rf")
    if mode == "goss":  # the last iteration sampled: 600 rows in the bag
        assert int(g._bag.sum()) == 600 and g._goss_k == (400, 200)
    if mode.startswith("dart"):
        assert g.sum_weight > 0 and len(g.tree_weight) == g.current_iteration
        assert any(w != g.tree_weight[-1] for w in g.tree_weight[:-1])  # a tree was rescaled
    if mode == "rf":
        assert all(t.shrinkage == 1.0 for t in g.trees())


@pytest.mark.parametrize("mode", ["goss", "dart", "rf"])
def test_host_loop_equals_device_loop(monkeypatch, mode):
    _patch_dyadic(monkeypatch)
    params = dict(TRAIN, **MODES[mode], **OBJECTIVES[1])
    runs = {}
    for loop in ("host", "device"):
        monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda" if loop == "device" else None)
        runs[loop] = _train(tlgb, params, 1, rounds=6, device="cpu")
        assert runs[loop][0]._gbdt.grow_loop == loop
    (hb, hres, _), (db, dres, _) = runs["host"], runs["device"]
    assert hb.model_to_string() == db.model_to_string() and hres == dres
    assert hb._gbdt.scores.numpy().tobytes() == db._gbdt.scores.numpy().tobytes()
    assert hb._gbdt.valid_scores[0].numpy().tobytes() == db._gbdt.valid_scores[0].numpy().tobytes()


@pytest.mark.parametrize("mode", ["goss", "dart", "rf"])
def test_bundled_training_equals_jax(monkeypatch, mode):
    """test_torch_efb.py's one-hot table as CSR (EFB-bundled in both
    packages), its categorical column sharing a bundle."""
    X, y = _onehot(1, N, 1)
    Xv, yv = _onehot(2, NV, 1)
    data = (sp.csr_matrix(X), y, Xv, yv, [CAT])
    params = dict(TRAIN, **MODES[mode], **OBJECTIVES[1])
    _patch_dyadic(monkeypatch)
    jrun = _train(jlgb, params, 1, rounds=6, data=data)
    grads = _record_gradients(monkeypatch)
    trun = _train(tlgb, params, 1, rounds=6, data=data, device="cpu")
    assert trun[0]._gbdt.num_groups > 0
    _assert_equal_runs(jrun, trun, grads, params)


# ---- average_output: the repair ---------------------------------------------------


@pytest.mark.parametrize("K", [1, 3])
def test_rf_model_text_predicts_the_average_both_ways(K):
    """A random-forest model text of either package, loaded into the other,
    predicts the average of its trees as the package that trained it does
    (before the repair the port summed them: 4 times the JAX package's raw
    score for 4 iterations)."""
    X, y = _numeric(1, N, K)
    params = dict(TRAIN, **MODES["rf"], **OBJECTIVES[K])
    jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y), 4)
    tb = tlgb.train(dict(params), tlgb.Dataset(X, label=y), 4, device="cpu")
    in_port = tlgb.Booster(model_str=jb.model_to_string(), device="cpu")
    in_jax = jlgb.Booster(model_str=tb.model_to_string())
    assert in_port._gbdt.average_output and in_jax._gbdt.average_output
    for it in (-1, 1, 3):
        for raw in (True, False):
            np.testing.assert_array_equal(in_port.predict(X, num_iteration=it, raw_score=raw),
                                          jb.predict(X, num_iteration=it, raw_score=raw))
            np.testing.assert_array_equal(in_jax.predict(X, num_iteration=it, raw_score=raw),
                                          tb.predict(X, num_iteration=it, raw_score=raw))
    # the average of the trees' sums
    total = sum(t.predict_fast(X[:50]) for t in in_port._gbdt.trees()[::K])
    np.testing.assert_allclose(in_port.predict(X[:50], raw_score=True)[..., 0] if K > 1
                               else in_port.predict(X[:50], raw_score=True), total / 4, rtol=1e-12)


# ---- errors and chunks ---------------------------------------------------------------

REFUSED = [
    ({"boosting": "goss", "bagging_fraction": 0.8, "bagging_freq": 1}, "Cannot use bagging in GOSS"),
    ({"boosting": "goss", "top_rate": 0.7, "other_rate": 0.5}, "must be <= 1.0"),
    ({"boosting": "goss", "top_rate": 0.0}, "must be positive"),
    ({"boosting": "goss", "other_rate": -0.1}, "must be positive"),
    ({"boosting": "rf"}, "requires bagging"),
    ({"boosting": "rf", "bagging_fraction": 0.5}, "requires bagging"),
]


@pytest.mark.parametrize("case", range(len(REFUSED)))
def test_refused_configurations_raise_as_in_jax(case):
    extra, msg = REFUSED[case]
    X, y = _numeric(1, 500, 1)
    params = {"objective": "binary", "verbose": -1, **extra}
    with pytest.raises(LightGBMError, match=msg):
        tlgb.Booster(dict(params), tlgb.Dataset(X, label=y), device="cpu")
    with pytest.raises(Exception, match=msg):
        jlgb.Booster(dict(params), jlgb.Dataset(X, label=y))


@pytest.mark.parametrize("mode", list(MODES))
def test_chunk_fallback_reason_is_jax(monkeypatch, mode):
    """A mode runs one iteration at a time, for the JAX package's reason."""
    X, y = _numeric(1, 500, 1)
    params = dict(TRAIN, **MODES[mode], **OBJECTIVES[1], device_chunk_size=4)
    monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")
    tb = tlgb.Booster(dict(params), tlgb.Dataset(X, label=y), device="cpu")
    jb = jlgb.Booster(dict(params), jlgb.Dataset(X, label=y))
    reason = tb._gbdt.device_chunk_fallback_reason()
    assert reason == jb._gbdt.device_chunk_fallback_reason()
    assert reason == "%s overrides per-iteration hooks" % type(tb._gbdt).__name__
    assert tb._gbdt.device_chunk() == 1 and tb.update_chunk(4) == (1, False)
    assert tb.num_trees() == 1
