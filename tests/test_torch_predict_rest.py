"""The rest of prediction in the PyTorch port, against the JAX package, on the
CPU: prediction early stopping, refit and the if-else C++ export.

* ``pred_early_stop``: the port's callbacks take tensors (the multiclass
  margin is the difference of the two largest scores); its output equals
  the JAX package's bit for bit, and a row never stopped equals ``predict``.
* ``refit``: the trees keep their structure and their leaves are refit on
  new data. On ``regression`` (l2) the leaf values equal the JAX package's
  bit for bit: the gradients are f32 differences, the same on both sides,
  and their f64 sums are exact in any order (N·2^(exponent spread) < 2^29
  here). On ``binary`` and ``multiclass`` the gradients go through ``exp``,
  which XLA and PyTorch round differently: those leaves are held to
  ``REFIT_EXP_RTOL`` (ROADMAP Queue C).
* ``save_model_to_ifelse``: the text equals the JAX package's byte for
  byte for the same model; compiled with g++ its raw scores and leaves
  equal the port's ``predict``.
"""
import ctypes
import functools
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.prediction_early_stop import (
    create_prediction_early_stop_instance as jax_instance,
)
from lightgbm_tpu_torch.prediction_early_stop import create_prediction_early_stop_instance

BASE = {"verbose": -1, "num_leaves": 15, "max_bin": 63, "min_data_in_leaf": 5}
#: refit through exp: an f32 gradient differs by a few ulp between XLA's and
#: PyTorch's exp; summed over a leaf, divided by the hessian sum and carried
#: through the later iterations' scores, a leaf moves by at most this share
#: of its size (measured: under 1e-6 on these models)
REFIT_EXP_RTOL = 1e-5


def _binary(n=200, f=6, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] + 0.3 * X[:, 1] + 0.3 * rng.randn(n) > 0).astype(np.float64)
    return X, y


def _multiclass(n=200, f=5, seed=1):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] > 0).astype(np.float64) + (X[:, 1] > 0.5)
    return X, y


def _train_text(params, X, y, **kw):
    """Model text trained by the port on the CPU (both packages read it; a
    JAX training would spend its seconds compiling)."""
    return tlgb.train(params, tlgb.Dataset(X, label=y, **kw), 5, device="cpu").model_to_string()


def _models(objective):
    """(model text, rows, labels), trained once a file."""
    text, X, y = _trained(objective)
    return text, X.copy(), y.copy()


@functools.lru_cache(maxsize=None)
def _trained(objective):
    if objective in ("multiclass", "multiclassova"):
        X, y = _multiclass()
        params = dict(BASE, objective=objective, num_class=3)
    else:
        X, y = _binary()
        if objective == "regression":
            y = X[:, 0] * 2 + np.abs(X[:, 1])
        params = dict(BASE, objective=objective)
    return _train_text(params, X, y), X, y


# ---------------------------------------------------------------------------
# prediction early stopping
# ---------------------------------------------------------------------------
def test_factory_semantics():
    none = create_prediction_early_stop_instance("none", 10, 1.0)
    assert not bool(none.callback(torch.tensor([[100.0]])).any())
    binary = create_prediction_early_stop_instance("binary", 5, 4.0)
    pred = np.array([[1.0], [3.0], [-3.0], [2.0001], [2.0]])
    stop = binary.callback(torch.tensor(pred))
    np.testing.assert_array_equal(stop.numpy(), [False, True, True, True, False])
    np.testing.assert_array_equal(stop.numpy(), jax_instance("binary", 5, 4.0).callback(pred))
    multi = create_prediction_early_stop_instance("multiclass", 5, 1.5)
    pred = np.array([[3.0, 1.0, 0.0], [2.0, 1.0, 0.0], [0.0, 3.0, 3.0], [-1.0, 0.6, 2.2]])
    stop = multi.callback(torch.tensor(pred))
    np.testing.assert_array_equal(stop.numpy(), [True, False, False, True])
    np.testing.assert_array_equal(stop.numpy(), jax_instance("multiclass", 5, 1.5).callback(pred))
    assert binary.round_period == 5 and none.round_period == 2 ** 31 - 1
    with pytest.raises(ValueError, match="length one"):
        binary.callback(torch.zeros((2, 2)))
    with pytest.raises(ValueError, match="two or larger"):
        multi.callback(torch.zeros((2, 1)))
    with pytest.raises(ValueError, match="Unknown early stopping type"):
        create_prediction_early_stop_instance("ranking", 5, 1.0)


@pytest.mark.parametrize("objective,freq,margin", [
    ("binary", 1, 1.5), ("binary", 2, 0.5), ("multiclass", 1, 0.5), ("multiclass", 2, 0.8),
    ("multiclassova", 1, 1.0),
])
def test_early_stop_equals_jax(objective, freq, margin):
    text, X, _ = _models(objective)
    tb, jb = tlgb.Booster(model_str=text, device="cpu"), jlgb.Booster(model_str=text)
    kw = dict(pred_early_stop=True, pred_early_stop_freq=freq, pred_early_stop_margin=margin)
    for raw in (False, True):
        got = tb.predict(X, raw_score=raw, **kw)
        np.testing.assert_array_equal(got, jb.predict(X, raw_score=raw, **kw))
    got, full = tb.predict(X, raw_score=True, **kw), tb.predict(X, raw_score=True)
    apart = (got != full).reshape(len(X), -1).any(axis=1)
    assert 0 < apart.sum() < len(X), apart.sum()  # some rows stopped, not all
    # a row never stopped took every tree: the bits of predict
    np.testing.assert_array_equal(got[~apart], full[~apart])


def test_early_stop_with_a_huge_margin_is_predict():
    text, X, _ = _models("binary")
    tb = tlgb.Booster(model_str=text, device="cpu")
    np.testing.assert_array_equal(
        tb.predict(X, pred_early_stop=True, pred_early_stop_freq=1, pred_early_stop_margin=1e9),
        tb.predict(X))


def test_early_stop_from_params_and_only_for_classification():
    text, X, _ = _models("binary")
    tb = tlgb.Booster({"pred_early_stop": True, "pred_early_stop_freq": 1,
                       "pred_early_stop_margin": 1.0}, model_str=text, device="cpu")
    jb = jlgb.Booster({"pred_early_stop": True, "pred_early_stop_freq": 1,
                       "pred_early_stop_margin": 1.0}, model_str=text)
    np.testing.assert_array_equal(tb.predict(X), jb.predict(X))
    assert not np.array_equal(tb.predict(X), tlgb.Booster(model_str=text, device="cpu").predict(X))
    text, X, _ = _models("regression")
    tb = tlgb.Booster(model_str=text, device="cpu")
    np.testing.assert_array_equal(
        tb.predict(X, pred_early_stop=True, pred_early_stop_freq=1, pred_early_stop_margin=0.0),
        tb.predict(X))


# ---------------------------------------------------------------------------
# refit
# ---------------------------------------------------------------------------
def _leaves(booster):
    return [np.asarray(t.leaf_value) for t in booster._gbdt.trees()]


def test_refit_changes_leaves_keeps_structure():
    text, X, y = _models("binary")
    bst = tlgb.Booster(model_str=text, device="cpu")
    err_before = np.mean((bst.predict(X) > 0.5) != y)
    before = [v.copy() for v in _leaves(bst)]
    new = bst.refit(X, 1 - y, decay_rate=0.5)
    assert new.num_trees() == bst.num_trees()
    for t_old, t_new in zip(bst._gbdt.trees(), new._gbdt.trees()):
        np.testing.assert_array_equal(t_old.split_feature, t_new.split_feature)
        np.testing.assert_array_equal(t_old.threshold, t_new.threshold)
    assert not np.allclose(_leaves(bst)[0], _leaves(new)[0])
    assert np.mean((new.predict(X) > 0.5) != y) > err_before
    for a, b in zip(before, _leaves(bst)):  # the refit took copies of the trees
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("decay", [0.0, 0.3, 0.9])
def test_refit_l2_equals_jax_bit_for_bit(decay):
    text, X, y = _models("regression")
    y2 = y * 0.5 + np.sin(X[:, 2])
    got = tlgb.Booster(model_str=text, device="cpu").refit(X, y2, decay_rate=decay)
    want = jlgb.Booster(model_str=text).refit(X, y2, decay_rate=decay)
    for a, b in zip(_leaves(got), _leaves(want)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got._gbdt.train_score(), np.asarray(want._gbdt.scores[0]))
    np.testing.assert_array_equal(got.predict(X), want.predict(X))


@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_refit_through_exp_within_its_bound(objective):
    text, X, y = _models(objective)
    y2 = y[::-1].copy()
    got = tlgb.Booster(model_str=text, device="cpu").refit(X, y2, decay_rate=0.5)
    want = jlgb.Booster(model_str=text).refit(X, y2, decay_rate=0.5)
    assert got._gbdt.num_tree_per_iteration == want._gbdt.num_tree_per_iteration
    for a, b in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(a, b, rtol=REFIT_EXP_RTOL, atol=REFIT_EXP_RTOL * np.abs(b).max())


def test_refit_same_data_decay1_is_identity():
    text, X, y = _models("binary")
    bst = tlgb.Booster(model_str=text, device="cpu")
    new = bst.refit(X, y, decay_rate=1.0)
    np.testing.assert_array_equal(new.predict(X), bst.predict(X))


def test_refit_multiclass():
    text, X, y = _models("multiclass")
    bst = tlgb.Booster(model_str=text, device="cpu")
    new = bst.refit(X, y, decay_rate=0.9)
    assert new.num_trees() == bst.num_trees()
    assert np.mean(np.argmax(new.predict(X), axis=1) == y) > 0.8


def test_refit_loaded_model_keeps_objective(tmp_path):
    """A loaded model refits under its own objective and class count even when
    the params omit them; the refit model round-trips through its text."""
    text, X, y = _models("multiclass")
    path = tmp_path / "mc.txt"
    path.write_text(text)
    bst = tlgb.Booster(model_file=str(path), device="cpu")
    loaded = tlgb.Booster(model_file=str(path), device="cpu")
    new = loaded.refit(X, y)
    assert new._gbdt.num_tree_per_iteration == 3 and new.num_trees() == bst.num_trees()
    assert new.predict(X[:4]).shape == (4, 3)
    new.save_model(str(tmp_path / "mc.refit.txt"))
    again = tlgb.Booster(model_file=str(tmp_path / "mc.refit.txt"), device="cpu")
    np.testing.assert_array_equal(again.predict(X[:4]), new.predict(X[:4]))
    as_binary = tlgb.Booster({"objective": "binary", "num_class": 1}, model_file=str(path),
                             device="cpu")
    with pytest.raises(tlgb.basic.LightGBMError, match="models per iteration"):
        as_binary.refit(X, (y > 0).astype(np.float64))


# ---------------------------------------------------------------------------
# the if-else C++ export
# ---------------------------------------------------------------------------
_CASES = ["binary", "regression", "multiclass", "categorical", "rf"]


@functools.lru_cache(maxsize=None)
def _codegen_model(case):
    if case == "categorical":
        X, y = _binary(seed=9)
        X[:, 2] = np.random.RandomState(2).randint(0, 40, len(X))
        X[::7, 2] = np.nan
        y = ((X[:, 2] % 3 == 0) | (X[:, 0] > 1)).astype(np.float64)
        params = dict(BASE, objective="binary", max_cat_to_onehot=2, min_data_per_group=5)
        return _train_text(params, X, y, categorical_feature=[2]), X
    if case == "rf":
        X, y = _binary(seed=10)
        params = dict(BASE, objective="binary", boosting="rf", bagging_fraction=0.7,
                      bagging_freq=1)
        return _train_text(params, X, y), X
    text, X, _ = _models(case)
    X = X.copy()
    X[::7, 0] = np.nan
    return text, X


@pytest.mark.parametrize("case", _CASES)
def test_ifelse_text_equals_jax(case):
    from lightgbm_tpu.models.model_codegen import save_model_to_ifelse as jax_ifelse
    from lightgbm_tpu_torch.models.model_codegen import save_model_to_ifelse

    text, _ = _codegen_model(case)
    got = save_model_to_ifelse(tlgb.Booster(model_str=text, device="cpu")._gbdt)
    assert got == jax_ifelse(jlgb.Booster(model_str=text)._gbdt)
    assert got.startswith("// model_fingerprint: ")
    assert save_model_to_ifelse(tlgb.Booster(model_str=text, device="cpu")._gbdt, 2) == \
        jax_ifelse(jlgb.Booster(model_str=text)._gbdt, 2)


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++ to compile the exported model")
@pytest.mark.parametrize("case", ["binary", "multiclass", "categorical"])
def test_ifelse_compiles_and_predicts_as_the_port(case, tmp_path):
    from lightgbm_tpu_torch.models.model_codegen import save_model_to_ifelse

    text, X = _codegen_model(case)
    bst = tlgb.Booster(model_str=text, device="cpu")
    src, lib = tmp_path / "model.cpp", tmp_path / "model.so"
    src.write_text(save_model_to_ifelse(bst._gbdt) + (
        '\nextern "C" {\n'
        "void predict(const double* f, double* o) { lightgbm_tpu_model::Predict(f, o); }\n"
        "void predict_raw(const double* f, double* o) { lightgbm_tpu_model::PredictRaw(f, o); }\n"
        "void predict_leaf(const double* f, double* o) "
        "{ lightgbm_tpu_model::PredictLeafIndex(f, o); }\n}\n"))
    subprocess.check_call(["g++", "-O1", "-shared", "-fPIC", "-o", str(lib), str(src)])
    so = ctypes.CDLL(str(lib))
    K, T = bst.num_model_per_iteration(), bst.num_trees()
    n = 32
    out = {name: np.zeros((n, width)) for name, width in
           (("predict", K), ("predict_raw", K), ("predict_leaf", T))}
    ptr = ctypes.POINTER(ctypes.c_double)
    for i in range(n):
        row = np.ascontiguousarray(X[i], np.float64)
        for name, arr in out.items():
            buf = np.zeros(arr.shape[1])
            getattr(so, name)(row.ctypes.data_as(ptr), buf.ctypes.data_as(ptr))
            arr[i] = buf
    raw = bst.predict(X[:n], raw_score=True).reshape(n, K)
    np.testing.assert_array_equal(out["predict_raw"], raw)
    np.testing.assert_allclose(out["predict"], bst.predict(X[:n]).reshape(n, K), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_array_equal(out["predict_leaf"].astype(np.int32),
                                  bst.predict(X[:n], pred_leaf=True))
    os.remove(lib)
