"""Custom objectives (``fobj``, ``objective="none"``) and the metric names
the JAX package skips, in the port (lightgbm_tpu_torch/engine.py,
basic.py ``Booster.update(fobj=)``, models/gbdt.py ``train_one_iter(
gradients, hessians)`` and the device iteration's gradient buffer,
metric.py ``create_metric``), on the CPU, against the JAX package.

 * ``train(fobj=)`` with K = 1 (a binary log-loss objective in numpy) and
   K = 3 (softmax), in the host loop and the device loop (its plain
   versions), with a validation set, ``feval`` and ``metric="custom"``:
   the objective's gradients are rounded to 2^-6 (dyadic), so both
   packages grow the same trees: the model text equal but its gains, each
   package's gains within 8 f32 ulps of the exact f64 gain (the rule of
   tests/test_torch_categorical.py), the scores bit for bit,
   ``evals_result`` and the predictions equal. The objective is handed the
   same scores (``[N]`` or class-major ``[K·N]``) and the port's Dataset.
 * ``Booster.update(fobj=)`` one iteration at a time gives the model of
   ``train(fobj=)``, in both loops; with bagging, feature_fraction and
   early stopping ``best_iteration`` and ``evals_result`` are the JAX
   package's.
 * ``metric="custom"``, ``"auc_mu"`` (a name no metric of either package
   has) and ``"binary_logloss,custom"`` train as in the JAX package (the
   repair of the port's refusal): the same ``evals_result``, model text
   and scores, on the dyadic binary gradients of
   tests/test_torch_categorical.py; an unknown name warns and is dropped.
 * With no usable feature, a custom objective's first iteration keeps one
   constant tree a class and stops, as in the JAX package.
 * ``keep_training_booster=True`` trains, and the Booster trains on.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import metric as tmetric
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.ops import hist_kernel
from test_torch_categorical import _exact_gains, _gains_apart
from test_torch_boosting import _patch_dyadic


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N, NV, ROUNDS = 1500, 400, 6
TRAIN = {"num_leaves": 15, "learning_rate": 0.25, "min_data_in_leaf": 20, "verbose": -1}


def _data(seed, n, K):
    rng = np.random.RandomState(seed)
    X = np.c_[rng.randn(n, 5), rng.rand(n, 2) < 0.3]
    z = X[:, 0] + 0.5 * X[:, 1] * X[:, 5] - 0.7 * X[:, 2] + 0.3 * rng.randn(n)
    if K == 1:
        return X, (z > 0).astype(np.float64)
    return X, np.digitize(z, [-0.7, 0.6]).astype(np.float64)


def _dyadic(g, h):
    return np.round(g * 64.0) / 64.0, np.maximum(np.round(h * 64.0), 1.0) / 64.0


def make_fobj(K, log=None):
    """A numpy log-loss objective (binary, or softmax over K classes) whose
    gradients and hessians are rounded to 2^-6; ``log`` collects the
    [K, N] pairs it returns."""
    def fobj(preds, dataset):
        label = np.asarray(dataset.get_label(), np.float64)
        if K == 1:
            p = 1.0 / (1.0 + np.exp(-preds))
            g, h = _dyadic(p - label, p * (1.0 - p))
        else:
            s = preds.reshape(K, -1)
            e = np.exp(s - s.max(axis=0))
            p = e / e.sum(axis=0)
            onehot = (np.arange(K)[:, None] == label[None, :]).astype(np.float64)
            g, h = _dyadic(p - onehot, p * (1.0 - p))
        if log is not None:
            log.append((g.reshape(K, -1), h.reshape(K, -1)))
        return g.reshape(-1), h.reshape(-1)
    return fobj


def feval(preds, dataset):
    return [("mean_score", float(np.mean(preds)), False),
            ("label_sum", float(np.sum(dataset.get_label())), True)]


def _train(pkg, params, K, fobj, rounds=ROUNDS, seed=1, **kw):
    X, y = _data(seed, N, K)
    Xv, yv = _data(seed + 1, NV, K)
    ds = pkg.Dataset(X, label=y)
    res = {}
    bst = pkg.train(dict(params), ds, rounds, valid_sets=[pkg.Dataset(Xv, label=yv, reference=ds)],
                    fobj=fobj, feval=feval, evals_result=res, verbose_eval=False, **kw)
    return bst, res, X, Xv


def _assert_same_model(jb, tb, params, grads):
    """Model text equal but its gains; each gain within the f32 bound of the
    exact f64 gain on both sides; the gains 8 digits apart at most."""
    (jbody, jgains), (tbody, tgains) = _gains_apart(jb.model_to_string()), \
        _gains_apart(tb.model_to_string())
    assert tbody == jbody
    gains = _exact_gains(tb, params, grads)
    for i, ta in enumerate(tb._gbdt._tree_arrays):
        exact, bound = gains[i]
        n = len(exact)
        for gain in (np.asarray(jb._gbdt._device_trees[i][0].split_gain), ta.split_gain.numpy()):
            assert (np.abs(gain[:n] - exact) <= bound).all(), (i, gain[:n], exact, bound)
    bound = np.concatenate([b for _, b in gains])
    assert (np.abs(tgains - jgains) <= 2 * bound + 1e-7 * np.abs(jgains)).all()


@pytest.mark.parametrize("loop", ["host", "device"])
@pytest.mark.parametrize("K", [1, 3])
def test_fobj_training_equals_jax(monkeypatch, K, loop):
    params = dict(TRAIN, metric="custom", num_class=K) if K > 1 else dict(TRAIN, metric="custom")
    jb, jres, X, Xv = _train(jlgb, params, K, make_fobj(K))
    if loop == "device":
        monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")
    grads = []
    tb, tres, _, _ = _train(tlgb, params, K, make_fobj(K, grads), device="cpu")
    g = tb._gbdt
    assert g.grow_loop == loop and g.objective is None and g.config.objective == "none"
    assert tb.num_trees() == jb.num_trees() == ROUNDS * K and len(grads) == ROUNDS
    assert g._custom_grads == (loop == "device")
    _assert_same_model(jb, tb, params, grads)
    np.testing.assert_array_equal(g.scores.numpy(), np.asarray(jb._gbdt.scores))
    np.testing.assert_array_equal(g.valid_scores[0].numpy(), np.asarray(jb._gbdt.valid_scores[0]))
    assert tres == jres and sorted(tres["valid_0"]) == ["label_sum", "mean_score"]
    for data in (X, Xv):
        np.testing.assert_array_equal(tb.predict(data), jb.predict(data))


@pytest.mark.parametrize("loop", ["host", "device"])
def test_booster_update_fobj_equals_train(monkeypatch, loop):
    """Booster.update(fobj=) one iteration at a time, in both packages, gives
    the model of train(fobj=); the objective sees the port's Dataset."""
    if loop == "device":
        monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")
    X, y = _data(3, N, 1)
    params = dict(TRAIN, objective="none")
    seen = []

    def fobj(preds, dataset):
        seen.append(dataset)
        return make_fobj(1)(preds, dataset)

    models = []
    for pkg, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        ds = pkg.Dataset(X, label=y)
        bst = pkg.Booster(dict(params), ds, **kw)
        for _ in range(ROUNDS):
            bst.update(fobj=fobj)
        models.append(_gains_apart(bst.model_to_string())[0])
        assert seen[-1] is ds
    one = tlgb.train(dict(params), tlgb.Dataset(X, label=y), ROUNDS, fobj=make_fobj(1),
                     verbose_eval=False, device="cpu")
    assert models[1] == models[0] == _gains_apart(one.model_to_string())[0]


def test_fobj_with_sampling_and_early_stopping_equals_jax(monkeypatch):
    """Bagging, feature_fraction and early stopping on a custom objective, in
    the device loop: the JAX package's best_iteration, evals_result and trees."""
    params = dict(TRAIN, metric="binary_logloss", bagging_fraction=0.7, bagging_freq=1,
                  feature_fraction=0.8, objective="binary")
    kw = dict(early_stopping_rounds=2)
    jb, jres, X, _ = _train(jlgb, params, 1, make_fobj(1), rounds=30, **kw)
    monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")
    tb, tres, _, _ = _train(tlgb, params, 1, make_fobj(1), rounds=30, device="cpu", **kw)
    assert tb._gbdt.grow_loop == "device" and tb._gbdt._masked and tb._gbdt._bag is not None
    assert tb.best_iteration == jb.best_iteration < 30 and tres == jres
    assert _gains_apart(tb.model_to_string())[0] == _gains_apart(jb.model_to_string())[0]
    np.testing.assert_array_equal(tb.predict(X, num_iteration=None),
                                  jb.predict(X, num_iteration=jb.best_iteration))


@pytest.mark.parametrize("metric", ["custom", "auc_mu", "binary_logloss,custom",
                                    ["auc", "custom", "auc_mu"]])
def test_metric_names_the_jax_package_skips(monkeypatch, metric):
    """``custom`` is skipped and a name no metric has warns and is dropped,
    as in the JAX package: the same evals_result (``feval``'s entries only,
    or with the named metrics), model text and scores."""
    _patch_dyadic(monkeypatch)
    params = dict(TRAIN, objective="binary", metric=metric)
    jb, jres, X, Xv = _train(jlgb, params, 1, None)
    tb, tres, _, _ = _train(tlgb, params, 1, None, device="cpu")
    assert tres == jres
    named = [m for m in (metric.split(",") if isinstance(metric, str) else metric)
             if m not in ("custom", "auc_mu")]
    assert list(tres["valid_0"]) == named + ["mean_score", "label_sum"]
    assert _gains_apart(tb.model_to_string())[0] == _gains_apart(jb.model_to_string())[0]
    np.testing.assert_array_equal(tb._gbdt.scores.numpy(), np.asarray(jb._gbdt.scores))
    np.testing.assert_array_equal(tb.predict(Xv), jb.predict(Xv))


def test_unknown_metric_warns_and_is_dropped(caplog):
    assert tmetric.create_metric("ndcg_at_k", TConfig.from_params({"verbose": -1})) is None
    X, y = _data(5, 300, 1)
    bst = tlgb.Booster({"objective": "binary", "metric": "auc_mu,auc,custom", "verbose": -1},
                       tlgb.Dataset(X, label=y), device="cpu")
    assert [type(m).__name__ for m in bst._gbdt.training_metrics] == ["AUCMetric"]
    # no metric named: the objective's own, as Config::GetMetricType defaults it
    bst = tlgb.Booster({"objective": "binary", "verbose": -1}, tlgb.Dataset(X, label=y),
                       device="cpu")
    assert [type(m).__name__ for m in bst._gbdt.training_metrics] == ["BinaryLoglossMetric"]


@pytest.mark.parametrize("K", [1, 3])
def test_fobj_without_usable_features_equals_jax(K):
    """Every column constant: no feature to split on, so the first iteration
    keeps one constant tree a class (of value 0: a custom objective has no
    boost from average) and stops, as in the JAX package."""
    X = np.ones((200, 3))
    y = (np.arange(200) % max(K, 2)).astype(np.float64)
    params = dict(TRAIN, num_class=K) if K > 1 else dict(TRAIN)
    out = []
    for pkg, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        bst = pkg.train(dict(params), pkg.Dataset(X, label=y), 3, fobj=make_fobj(K),
                        verbose_eval=False, **kw)
        out.append((bst.num_trees(), bst.model_to_string().split("parameters:")[0],
                    bst.predict(X, raw_score=True)))
    assert out[1][0] == out[0][0] == K and out[1][1] == out[0][1]
    np.testing.assert_array_equal(out[1][2], out[0][2])


def test_keep_training_booster_trains():
    X, y = _data(6, 500, 1)
    one = tlgb.train(dict(TRAIN, objective="binary"), tlgb.Dataset(X, label=y), 4,
                     verbose_eval=False, device="cpu")
    bst = tlgb.train(dict(TRAIN, objective="binary"), tlgb.Dataset(X, label=y), 3,
                     keep_training_booster=True, verbose_eval=False, device="cpu")
    assert bst.current_iteration == 3
    bst.update()
    assert bst.model_to_string() == one.model_to_string()
