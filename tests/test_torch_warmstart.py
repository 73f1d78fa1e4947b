"""Continued training (``train(init_model=)``) in the port
(lightgbm_tpu_torch/engine.py, basic.py ``Dataset.set_predictor``,
models/gbdt.py ``warmstart_scores`` / ``_merge_from`` and ``add_valid`` on
trees with no bin-space copy), on the CPU, against itself and the JAX
package; the cases of tests/test_warmstart.py through both packages.

 * train(N + M) is byte for byte train(N), saved, then warm-started from
   the file for M more: plain, chunked, with bagging and feature_fraction,
   multiclass, an untrained class, from a live Booster, in the host loop
   and the device loop (its plain versions); the same continued run in the
   JAX package gives the same model text but its gains (each package's
   gains within 8 f32 ulps of the exact f64 gain) on the dyadic gradients
   of tests/test_torch_categorical.py;
 * ``warmstart_scores`` equals the live score carry bit for bit, from the
   Booster and from its text; it declines random forest and DART, whose
   continued runs take the f64 ``predict_raw`` as the JAX package's do;
 * a validation set attached to a warm-started or loaded model replays the
   trees from its raw rows: the continued run's ``evals_result`` is the
   one-shot run's tail, and a loaded model evaluates as the JAX package's;
 * a model file written by the JAX package as ``init_model``: the JAX
   package's continued model and predictions.
"""
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.ops import hist_kernel
from test_torch_boosting import _patch_dyadic
from test_torch_categorical import _gains_apart

SEED = 13


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(mode, n=260, f=5, seed=SEED):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    if mode == "multiclass":
        return X, rng.randint(0, 3, n).astype(float)
    return X, (X[:, 0] + 0.35 * rng.randn(n) > 0).astype(float)


def _params(mode, **extra):
    p = {"objective": "binary", "num_leaves": 8, "verbosity": -1, "min_data_in_leaf": 5}
    if mode == "multiclass":
        p.update(objective="multiclass", num_class=3)
    p.update(extra)
    return p


def _train(pkg, params, X, y, rounds, init_model=None, **kw):
    if pkg is tlgb:
        kw["device"] = "cpu"
    return pkg.train(dict(params), pkg.Dataset(X, label=y), rounds, init_model=init_model,
                     verbose_eval=False, **kw)


CASES = [
    ("binary", {}),
    ("binary", {"device_chunk_size": 4}),
    ("binary", {"bagging_fraction": 0.8, "bagging_freq": 1, "feature_fraction": 0.8}),
    ("binary", {"device_chunk_size": 3, "bagging_fraction": 0.7, "bagging_freq": 2}),
    ("multiclass", {}),
    ("multiclass", {"device_chunk_size": 4, "feature_fraction": 0.8}),
]


@pytest.mark.parametrize("loop", ["host", "device"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_warmstart_equals_one_shot(tmp_path, monkeypatch, case, loop):
    mode, extra = CASES[case]
    if loop == "device":
        monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")
    X, y = _data(mode)
    params = _params(mode, **extra)
    one = _train(tlgb, params, X, y, 9)
    first = _train(tlgb, params, X, y, 4)
    path = str(tmp_path / "n.txt")
    first.save_model(path)
    warm = _train(tlgb, params, X, y, 5, init_model=path)
    assert warm._gbdt.grow_loop == loop and warm._gbdt.num_init_iteration == 4
    assert warm.model_to_string() == one.model_to_string()
    assert warm._gbdt.scores.numpy().tobytes() == one._gbdt.scores.numpy().tobytes()


@pytest.mark.parametrize("case", [0, 2, 4, 5])
def test_warmstart_equals_jax(tmp_path, monkeypatch, case):
    """The same continued run in both packages, each warm-started from its own
    file, on dyadic gradients: the model text but its gains, and the scores."""
    _patch_dyadic(monkeypatch)
    mode, extra = CASES[case]
    X, y = _data(mode)
    params = _params(mode, **extra)
    runs = []
    for pkg in (jlgb, tlgb):
        path = str(tmp_path / ("%s.txt" % pkg.__name__))
        _train(pkg, params, X, y, 4).save_model(path)
        runs.append(_train(pkg, params, X, y, 5, init_model=path))
    jw, tw = runs
    assert _gains_apart(tw.model_to_string())[0] == _gains_apart(jw.model_to_string())[0]
    np.testing.assert_array_equal(tw._gbdt.scores.numpy(), np.asarray(jw._gbdt.scores))
    np.testing.assert_array_equal(tw.predict(X), jw.predict(X))


@pytest.mark.parametrize("loop", ["host", "device"])
def test_warmstart_with_untrained_class_and_feature_fraction(tmp_path, monkeypatch, loop):
    """A class absent from the labels draws no feature masks: the replay of
    the generator advances by the trained classes only."""
    if loop == "device":
        monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")
    rng = np.random.RandomState(SEED)
    X = rng.randn(240, 5)
    y = rng.choice([0.0, 2.0], 240)
    params = {"objective": "multiclass", "num_class": 3, "num_leaves": 6, "verbosity": -1,
              "feature_fraction": 0.8, "min_data_in_leaf": 5}
    one = _train(tlgb, params, X, y, 7)
    path = str(tmp_path / "n.txt")
    _train(tlgb, params, X, y, 3).save_model(path)
    warm = _train(tlgb, params, X, y, 4, init_model=path)
    assert len(warm._gbdt._train_classes) == 2
    assert warm.model_to_string() == one.model_to_string()


def test_warmstart_from_in_process_booster():
    X, y = _data("binary")
    params = _params("binary")
    one = _train(tlgb, params, X, y, 7)
    first = _train(tlgb, params, X, y, 3)
    warm = _train(tlgb, params, X, y, 4, init_model=first)
    assert warm.model_to_string() == one.model_to_string()
    assert first.current_iteration == 3  # the predictor is left as it was


@pytest.mark.parametrize("loop", ["host", "device"])
def test_warmstart_scores_match_live_carry(monkeypatch, loop):
    if loop == "device":
        monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")
    X, y = _data("binary")
    bst = _train(tlgb, _params("binary", bagging_fraction=0.8, bagging_freq=1), X, y, 5)
    carry = bst._gbdt.scores.numpy()
    ws = bst._gbdt.warmstart_scores(X)
    assert ws is not None and ws.dtype == np.float32 and np.array_equal(ws, carry)
    loaded = tlgb.Booster(model_str=bst.model_to_string(), device="cpu")
    assert np.array_equal(loaded._gbdt.warmstart_scores(X), carry)
    # the JAX package's replay of the port's text gives the same bits
    jloaded = jlgb.Booster(model_str=bst.model_to_string())
    assert np.array_equal(jloaded._gbdt.warmstart_scores(X), carry)


@pytest.mark.parametrize("boosting", ["rf", "dart"])
def test_rf_and_dart_take_the_f64_path(tmp_path, boosting):
    """warmstart_scores declines a random forest or DART Booster: continued
    from one, the init scores are its f64 predict_raw, as in the JAX
    package. A model loaded from text is a plain GBDT in both packages
    (DART's text holds no mode): both replay it in f32, to the same bits."""
    X, y = _data("binary", n=300)
    params = {"objective": "binary", "boosting": boosting, "num_leaves": 6, "verbosity": -1,
              "bagging_fraction": 0.8, "bagging_freq": 1, "learning_rate": 0.5}
    first = _train(tlgb, params, X, y, 4)
    assert first._gbdt.warmstart_scores(X) is None
    live = tlgb.Dataset(X, label=y).set_predictor(first)
    np.testing.assert_array_equal(live.construct()._binned.metadata.init_score,
                                  first._gbdt.predict_raw(X))
    path = str(tmp_path / "n.txt")
    first.save_model(path)
    jinit = jlgb.Dataset(X, label=y)
    jinit.set_predictor(jlgb.Booster(model_file=path))
    tinit = tlgb.Dataset(X, label=y).set_predictor(tlgb.Booster(model_file=path, device="cpu"))
    np.testing.assert_array_equal(tinit.construct()._binned.metadata.init_score,
                                  jinit.construct()._binned.metadata.init_score)
    warm = _train(tlgb, dict(params, boosting="gbdt"), X, y, 3, init_model=first)
    jwarm = _train(jlgb, dict(params, boosting="gbdt"), X, y, 3, init_model=path)
    assert warm.num_trees() == jwarm.num_trees() == 7
    np.testing.assert_allclose(warm.predict(X, raw_score=True), jwarm.predict(X, raw_score=True),
                               rtol=1e-5, atol=1e-5)


def test_warmstart_with_valid_sets_matches_eval_history(tmp_path):
    """The validation set's carry replays the merged trees from its raw rows
    in f32: the continued run's values are the one-shot run's tail."""
    X, y = _data("binary")
    rng = np.random.RandomState(SEED + 1)
    Xv = rng.randn(90, 5)
    yv = (Xv[:, 0] > 0).astype(float)
    params = _params("binary", metric=["binary_logloss", "auc"])

    def run(rounds, init_model=None):
        res = {}
        tlgb.train(dict(params), tlgb.Dataset(X, label=y), rounds,
                   valid_sets=[tlgb.Dataset(Xv, label=yv)], valid_names=["v"],
                   init_model=init_model, verbose_eval=False, evals_result=res, device="cpu")
        return res

    full = run(9)
    path = str(tmp_path / "n.txt")
    _train(tlgb, params, X, y, 4).save_model(path)
    cont = run(5, init_model=path)
    for metric, vals in full["v"].items():
        assert vals[4:] == cont["v"][metric], metric


def test_loaded_model_evaluates_a_validation_set():
    """add_valid on a model loaded from text (no training set) replays its
    trees from the set's raw rows: the JAX package's values."""
    X, y = _data("binary")
    Xv, yv = _data("binary", n=120, seed=SEED + 2)
    text = _train(tlgb, _params("binary", metric="auc,binary_logloss"), X, y, 5).model_to_string()
    params = {"metric": "auc,binary_logloss", "verbose": -1}
    tb = tlgb.Booster(params, model_str=text, device="cpu")
    jb = jlgb.Booster(params, model_str=text)
    got = tb.eval(tlgb.Dataset(Xv, label=yv), "v")
    want = jb.eval(jlgb.Dataset(Xv, label=yv), "v")
    assert [e[:2] for e in got] == [e[:2] for e in want] == [("v", "auc"), ("v", "binary_logloss")]
    np.testing.assert_allclose([e[2] for e in got], [e[2] for e in want], rtol=1e-12)


@pytest.mark.parametrize("K", [1, 3])
def test_jax_model_file_as_init_model(tmp_path, monkeypatch, K):
    """A model file the JAX package wrote, continued by each package on dyadic
    gradients: the same continued model and predictions."""
    _patch_dyadic(monkeypatch)
    mode = "binary" if K == 1 else "multiclass"
    X, y = _data(mode, n=400)
    params = _params(mode, bagging_fraction=0.8, bagging_freq=1, feature_fraction=0.8)
    path = str(tmp_path / "jax.txt")
    _train(jlgb, params, X, y, 4).save_model(path)
    jw = _train(jlgb, params, X, y, 4, init_model=path)
    tw = _train(tlgb, params, X, y, 4, init_model=path)
    assert tw.num_trees() == jw.num_trees() == 8 * K
    assert _gains_apart(tw.model_to_string())[0] == _gains_apart(jw.model_to_string())[0]
    np.testing.assert_array_equal(tw._gbdt.scores.numpy(), np.asarray(jw._gbdt.scores))
    np.testing.assert_array_equal(tw.predict(X, raw_score=True), jw.predict(X, raw_score=True))
    assert os.path.getsize(path) > 0
