"""The port's objectives and metrics (lightgbm_tpu_torch/objective.py,
metric.py) against the JAX package's, on the CPU, on the same seeded
labels, weights and scores.

 * gradients and hessians: f32, bit for bit where the formula has no
   transcendental (regression, its ``reg_sqrt``, huber, fair); where it has
   ``exp`` or ``log`` (torch's and XLA's differ in the last ulp), within
   rtol 1e-6. Where the formula takes the difference of two such terms
   (poisson's ``exp(score) - label``), an element is held within 1e-6 of
   the larger of its value and its terms' magnitude (``_TERMS``): one ulp of
   a term is more than 1e-6 of a difference that cancels;
 * ``boost_from_score`` of every class within 1e-12 relative,
   ``class_need_train``, ``num_model_per_iteration`` and
   ``convert_output``;
 * the model string (``to_string``) and its round trip through both
   packages' ``objective_from_model_string``;
 * every ported metric's value;
 * a custom objective and an unknown metric raise, naming themselves; the
   objectives and metrics refused before (``regression_l1``, ``quantile``,
   ``mape``, ``lambdarank``, ``ndcg``, ``map``) train or evaluate as the
   JAX package's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu import metric as jmetric
from lightgbm_tpu import objective as jobj
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.dataset import Metadata as JMetadata
from lightgbm_tpu_torch import metric as tmetric
from lightgbm_tpu_torch import objective as tobj
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.dataset import Metadata as TMetadata


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: faster alone,
    and the test workers do not oversubscribe the cores. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N = 997
K = 3
#: objectives whose gradients have no transcendental: bit for bit
EXACT = {"regression", "regression_sqrt", "huber", "fair"}

#: (case, params, label kind)
CASES = [
    ("regression", {"objective": "regression"}, "real"),
    ("regression_sqrt", {"objective": "regression", "reg_sqrt": True}, "real"),
    ("huber", {"objective": "huber", "alpha": 0.7}, "real"),
    ("fair", {"objective": "fair", "fair_c": 0.6}, "real"),
    ("poisson", {"objective": "poisson", "poisson_max_delta_step": 0.5}, "count"),
    ("gamma", {"objective": "gamma"}, "positive"),
    ("tweedie", {"objective": "tweedie", "tweedie_variance_power": 1.3}, "positive"),
    ("binary", {"objective": "binary", "sigmoid": 1.5}, "binary"),
    ("binary_unbalance", {"objective": "binary", "is_unbalance": True}, "binary"),
    ("multiclass", {"objective": "multiclass", "num_class": K}, "class"),
    ("multiclassova", {"objective": "multiclassova", "num_class": K, "sigmoid": 0.8}, "class"),
    ("xentropy", {"objective": "xentropy"}, "unit"),
    ("xentlambda", {"objective": "xentlambda"}, "unit"),
]


def _labels(kind, rng):
    if kind == "real":
        return rng.randn(N) * 3.0 + 1.0
    if kind == "count":
        return rng.poisson(2.0, N).astype(np.float64)
    if kind == "positive":
        return rng.gamma(2.0, 1.5, N) + 0.01
    if kind == "binary":
        return (rng.rand(N) < 0.3).astype(np.float64)
    if kind == "class":
        return rng.choice(K, N, p=[0.5, 0.3, 0.2]).astype(np.float64)
    return rng.rand(N)


def _pair(case, weighted, seed=0):
    """The JAX and the port's objective, initialised on the same metadata."""
    _, params, kind = next(c for c in CASES if c[0] == case)
    rng = np.random.RandomState(seed)
    label = _labels(kind, rng)
    weight = rng.uniform(0.5, 2.0, N) if weighted else None
    params = dict(params, verbose=-1)
    j = jobj.create_objective(JConfig.from_params(dict(params)))
    j.init(JMetadata(N, label=label, weight=weight), N)
    t = tobj.create_objective(TConfig.from_params(dict(params)))
    t.init(TMetadata(N, label=label, weight=weight), N, torch.device("cpu"))
    return j, t, label, weight


def _scores(t, seed=1):
    rng = np.random.RandomState(seed)
    shape = (t.num_model_per_iteration, N) if t.num_model_per_iteration > 1 else (N,)
    return (rng.randn(*shape) * 0.7).astype(np.float32)


def _tweedie_terms(s, y, rho):
    e1, e2 = np.exp((1.0 - rho) * s), np.exp((2.0 - rho) * s)
    return y * e1 + e2, y * abs(1.0 - rho) * e1 + (2.0 - rho) * e2


def _xentlambda_terms(s, y, w):
    """Its weighted formula also cancels inside: z = 1 - exp(-w log1p(e^s))
    and c - 1 with c = 1 / (1 - z), so each of those terms counts with its
    condition (its terms over its difference)."""
    epf = np.exp(s)
    z = -np.expm1(-w * np.log1p(epf))
    c = 1.0 / (1.0 - z)
    d = 1.0 + epf
    b = c / (c - 1.0) ** 2 * (1.0 + w * epf - c)
    cond_b = 2.0 * c / (c - 1.0) + (1.0 + w * epf + c) / np.abs(1.0 + w * epf - c)
    grad = w / (1.0 + 1.0 / epf) * (1.0 + y / z * (1.0 + 2.0 / z))
    return grad, w * epf / (d * d) * (1.0 + np.abs(y * b) * cond_b)


#: per element, the magnitudes of the terms whose difference each formula
#: takes (gradient, hessian; None where nothing cancels), in f64 from the
#: score, label and weight; only the formulas that take such a difference
_TERMS = {
    "poisson": lambda s, y, w: (w * (np.exp(s) + y), None),
    "gamma": lambda s, y, w: (w * (1.0 + y * np.exp(-s)), None),
    "tweedie": lambda s, y, w: tuple(w * a for a in _tweedie_terms(s, y, 1.3)),
    "xentlambda": _xentlambda_terms,
}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_gradients_match_jax(case, weighted):
    j, t, label, weight = _pair(case, weighted)
    score = _scores(t)
    jg, jh = (np.asarray(a) for a in j.get_gradients(jnp.asarray(score)))
    tg, th = (a.numpy() for a in t.get_gradients(torch.from_numpy(score)))
    terms = (None, None)
    if case in _TERMS and not (case == "xentlambda" and weight is None):  # unweighted: a sigmoid
        w = np.ones(N) if weight is None else weight
        terms = _TERMS[case](score.astype(np.float64), label, w)
    for got, want, term in ((tg, jg, terms[0]), (th, jh, terms[1])):
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == score.shape
        if case in EXACT:
            np.testing.assert_array_equal(got, want)
        elif term is None:
            np.testing.assert_allclose(got, want, rtol=1e-6)
        else:
            scale = np.maximum(np.abs(want), term)
            bad = np.abs(got.astype(np.float64) - want) > 1e-6 * scale
            assert not bad.any(), (np.flatnonzero(bad)[:5], got[bad][:5], want[bad][:5])


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_boost_from_score_and_classes_match_jax(case, weighted):
    j, t, _, _ = _pair(case, weighted)
    assert t.num_model_per_iteration == j.num_model_per_iteration
    for k in range(t.num_model_per_iteration):
        assert t.boost_from_score(k) == pytest.approx(j.boost_from_score(k), rel=1e-12, abs=0)
        assert t.class_need_train(k) == j.class_need_train(k)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_convert_output_and_model_string_match_jax(case):
    j, t, _, _ = _pair(case, False)
    score = _scores(t).astype(np.float64)
    raw = score.T if score.ndim == 2 else score  # [N, K] as predict hands it over
    np.testing.assert_array_equal(t.convert_output(raw), j.convert_output(raw))
    text = t.to_string()
    assert text == j.to_string()
    cfg_t, cfg_j = TConfig.from_params({"verbose": -1}), JConfig.from_params({"verbose": -1})
    back = tobj.objective_from_model_string(text, cfg_t)
    assert type(back).__name__ == type(t).__name__ and back.to_string() == text
    assert tobj.objective_from_model_string(j.to_string(), cfg_t).to_string() == text
    assert jobj.objective_from_model_string(text, cfg_j).to_string() == text


def test_multiclass_need_train_of_an_empty_class():
    """A class no label holds does not train, in both packages."""
    label = np.where(np.arange(N) % 2 == 0, 0.0, 2.0)
    params = {"objective": "multiclass", "num_class": K, "verbose": -1}
    j = jobj.create_objective(JConfig.from_params(dict(params)))
    j.init(JMetadata(N, label=label), N)
    t = tobj.create_objective(TConfig.from_params(dict(params)))
    t.init(TMetadata(N, label=label), N, torch.device("cpu"))
    assert [t.class_need_train(k) for k in range(K)] == [True, False, True]
    assert [j.class_need_train(k) for k in range(K)] == [True, False, True]
    assert t.boost_from_score(1) == j.boost_from_score(1)


#: (metric, objective case whose labels and link it is evaluated with)
METRICS = [
    ("l2", "regression"), ("mse", "regression"), ("rmse", "regression"), ("l1", "regression"),
    ("mae", "regression"), ("quantile", "regression"), ("huber", "huber"), ("fair", "fair"),
    ("poisson", "poisson"), ("gamma", "gamma"), ("gamma-deviance", "gamma"),
    ("gamma_deviance", "gamma"), ("tweedie", "tweedie"), ("mape", "regression"),
    ("binary_logloss", "binary"), ("binary_error", "binary"), ("auc", "binary"),
    ("multi_logloss", "multiclass"), ("multi_error", "multiclass"),
    ("multi_logloss", "multiclassova"), ("multi_error", "multiclassova"),
    ("xentropy", "xentropy"), ("cross_entropy", "xentropy"), ("xentlambda", "xentlambda"),
    ("kldiv", "xentropy"),
]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name,case", METRICS)
def test_metric_matches_jax(name, case, weighted):
    j, t, label, weight = _pair(case, weighted)
    params = {"verbose": -1, "alpha": 0.7, "fair_c": 0.6, "tweedie_variance_power": 1.3}
    jm = jmetric.create_metric(name, JConfig.from_params(dict(params)))
    tm = tmetric.create_metric(name, TConfig.from_params(dict(params)))
    jm.init(JMetadata(N, label=label, weight=weight), N)
    tm.init(TMetadata(N, label=label, weight=weight), N)
    score = _scores(t).astype(np.float64)
    got, want = tm.eval(score, t), jm.eval(score, j)
    assert [(n, b) for n, _, b in got] == [(n, b) for n, _, b in want]
    np.testing.assert_allclose([v for _, v, _ in got], [v for _, v, _ in want], rtol=1e-12)


@pytest.mark.parametrize("name", ["none"])
def test_refused_objectives_name_themselves(name):
    """The name is historical: ``objective="none"`` (a custom objective) is
    no ObjectiveFunction in either package: both give None."""
    assert tobj.create_objective(TConfig.from_params({"objective": name, "verbose": -1})) is None
    assert jobj.create_objective(JConfig.from_params({"objective": name, "verbose": -1})) is None


@pytest.mark.parametrize("name", ["ndcg_at_k"])
def test_refused_metrics_name_themselves(name, capsys):
    """The name is historical: a name that no metric of either package has
    warns "Unknown metric type name" and gives None in both packages."""
    assert tmetric.create_metric(name, TConfig.from_params({"verbose": 0})) is None
    assert "Unknown metric type name: %s" % name in capsys.readouterr().err
    assert jmetric.create_metric(name, JConfig.from_params({"verbose": -1})) is None


def _queries(n):
    sizes = np.full(n // 10, 10)
    sizes[-1] += n - sizes.sum()
    return sizes


@pytest.mark.parametrize("name", ["regression_l1", "quantile", "mape", "lambdarank"])
def test_formerly_refused_objectives_train(name):
    """The objectives once refused here train 3 iterations on the CPU and
    predict what the JAX package's same training predicts (raw scores
    within rtol 1e-4; tests/test_torch_renew.py and test_torch_rank.py hold
    them closer)."""
    import lightgbm_tpu as jlgb
    import lightgbm_tpu_torch as tlgb

    rng = np.random.RandomState(3)
    X = rng.randn(N, 4)
    y = X[:, 0] * 2.0 + X[:, 1] ** 2 + rng.randn(N) + 5.0
    if name == "lambdarank":
        y = np.clip(np.round(y - 4.0), 0, 4)
    group = _queries(N) if name == "lambdarank" else None
    params = {"objective": name, "num_leaves": 7, "verbose": -1}
    tb = tlgb.train(dict(params), tlgb.Dataset(X, label=y, group=group), 3, device="cpu")
    jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y, group=group), 3)
    assert tb.num_trees() == 3 and tb._gbdt.objective.name == name
    np.testing.assert_allclose(tb.predict(X, raw_score=True), jb.predict(X, raw_score=True),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["ndcg", "map"])
def test_formerly_refused_metrics_evaluate(name):
    """ndcg@k and map@k, once refused here, evaluate as the JAX package's
    do (tests/test_torch_rank.py holds them with query weights)."""
    rng = np.random.RandomState(4)
    label = rng.randint(0, 4, N).astype(np.float64)
    params = {"verbose": -1, "eval_at": [2, 4]}
    jm = jmetric.create_metric(name, JConfig.from_params(dict(params)))
    tm = tmetric.create_metric(name, TConfig.from_params(dict(params)))
    jm.init(JMetadata(N, label=label, group=_queries(N)), N)
    tm.init(TMetadata(N, label=label, group=_queries(N)), N)
    score = rng.randn(N)
    got, want = tm.eval(score, None), jm.eval(score, None)
    assert [m for m, _, _ in got] == ["%s@2" % name, "%s@4" % name] == [m for m, _, _ in want]
    np.testing.assert_allclose([v for _, v, _ in got], [v for _, v, _ in want], rtol=1e-12)
