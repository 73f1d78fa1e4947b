"""LambdaRank, the ranking metrics and query groups in the port
(lightgbm_tpu_torch/objective.py ``LambdarankNDCG``, ops/rank.py,
metric.py ``NDCGMetric`` / ``MapMetric``, basic.py ``Dataset(group=)``) on
the CPU, against the JAX package.

 * the lambdas: the port's plain version (ops/rank.py, the wrapper's CPU
   path) against ``LambdarankNDCG.get_gradients`` and its host oracle
   ``_get_gradients_host`` on tests/test_lambdarank_device.py's mixed
   queries (sizes 1 to 130, a tied query, a one-label query), with and
   without weights, within the tolerance the JAX package holds its own twin
   to: rtol 2e-4, atol 2e-6 (the exp and the summation order differ);
   the query plan's constants equal;
 * ``ndcg@k`` and ``map@k`` against the JAX metrics, with query weights
   and queries whose labels are all 0, to rtol 1e-12;
 * whole LambdaRank trainings against ``lightgbm_tpu.train``: raw scores
   within rtol 1e-4 / atol 1e-5 and the same ndcg at every boundary; the
   device loop equals the host loop and chunks of 4 equal chunk 1 byte for
   byte; model text goes both ways;
 * the group API (``set_group``, ``get_group``, ``set_field`` /
   ``get_field`` for ``group`` and ``query``, ``create_valid(group=)``),
   and the errors: no groups, a label beyond ``label_gain``, a boosting
   mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu import metric as jmetric
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.dataset import Metadata as JMetadata
from lightgbm_tpu.objective import LambdarankNDCG as JRank
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import metric as tmetric
from lightgbm_tpu_torch import objective as tobj
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.ops import hist_kernel, rank_kernel
from lightgbm_tpu_torch.utils.log import LightGBMError
from test_lambdarank_device import _mixed_case


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(labels, groups, weights=None, **cfg):
    """The JAX and the port's LambdaRank objective on the same metadata."""
    n = len(labels)
    j = JRank(JConfig(objective="lambdarank", **cfg))
    j.init(JMetadata(n, label=np.asarray(labels, np.float32), weight=weights,
                     group=np.asarray(groups, np.int64)), n)
    t = tobj.create_objective(TConfig.from_params(dict(cfg, objective="lambdarank", verbose=-1)))
    t.init(TMetadata(n, label=np.asarray(labels, np.float32), weight=weights,
                     group=np.asarray(groups, np.int64)), n, torch.device("cpu"))
    return j, t


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_weights", [False, True])
def test_lambdas_match_jax(seed, with_weights):
    labels, groups, w, scores = _mixed_case(seed=seed, with_weights=with_weights)
    j, t = _pair(labels, groups, w)
    s = scores.astype(np.float32)
    tg, th = t.get_gradients(torch.from_numpy(s))
    jg, jh = j.get_gradients(jnp.asarray(s))
    hg, hh = j._get_gradients_host(s)
    for want_g, want_h in ((jg, jh), (hg, hh)):
        _close(tg.numpy(), np.asarray(want_g))
        _close(th.numpy(), np.asarray(want_h))
    # a one-row query (the first and the last) and the one-label query get zeros
    off = sum(groups[:4])
    assert tg[0] == 0 and tg[-1] == 0 and (tg[off:off + 8] == 0).all()
    assert rank_kernel.launches["lambdarank"] == 0  # the CPU path is the plain version


def test_lambdas_at_equal_scores_and_the_plan():
    """At iteration 0 every score is equal (the ``best == worst`` branch in
    every query); the plan's f32 constants are the JAX package's."""
    labels, groups, w, _ = _mixed_case(seed=4, with_weights=True)
    j, t = _pair(labels, groups, w, max_position=5)
    zeros = np.zeros(len(labels), np.float32)
    tg, th = t.get_gradients(torch.from_numpy(zeros))
    jg, jh = j.get_gradients(jnp.asarray(zeros))
    _close(tg.numpy(), np.asarray(jg))
    _close(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(t.inverse_max_dcgs, j.inverse_max_dcgs)
    np.testing.assert_array_equal(t.plan.qb.numpy(), np.asarray(j.query_boundaries))
    rows = np.concatenate([np.asarray(p[0]).reshape(-1) for p in j._device_plans])
    trows = np.concatenate([p[0].numpy().reshape(-1) for p in t.plan.buckets()])
    np.testing.assert_array_equal(trows, rows)  # the same buckets, chunks and pads


@pytest.mark.parametrize("gain", [None, [0.0, 1.0, 2.5, 4.0, 9.0]])
def test_label_gain_and_sigmoid(gain):
    labels, groups, _, scores = _mixed_case(seed=5)
    cfg = {"sigmoid": 1.7}
    if gain is not None:
        cfg["label_gain"] = gain
    j, t = _pair(labels, groups, None, **cfg)
    s = scores.astype(np.float32)
    tg, th = t.get_gradients(torch.from_numpy(s))
    jg, jh = j.get_gradients(jnp.asarray(s))
    _close(tg.numpy(), np.asarray(jg))
    _close(th.numpy(), np.asarray(jh))


def test_init_errors_name_themselves():
    with pytest.raises(LightGBMError, match="query information"):
        t = tobj.create_objective(TConfig.from_params({"objective": "lambdarank", "verbose": -1}))
        t.init(TMetadata(4, label=np.zeros(4)), 4, torch.device("cpu"))
    with pytest.raises(LightGBMError, match="label_gain"):
        t = tobj.create_objective(TConfig.from_params(
            {"objective": "lambdarank", "label_gain": [0, 1], "verbose": -1}))
        t.init(TMetadata(4, label=np.array([0, 1, 2, 0]), group=np.array([4])), 4,
               torch.device("cpu"))


# ---- metrics -------------------------------------------------------------------------


def _ranking_data(seed, n_q=40, weighted=False):
    rng = np.random.RandomState(seed)
    sizes = rng.randint(1, 30, n_q)
    n = int(sizes.sum())
    labels = rng.randint(0, 5, n).astype(np.float64) * (rng.rand(n) < 0.6)
    labels[:sizes[0] + sizes[1]] = 0.0  # two queries whose labels are all 0
    # query weights are each query's first row's weight
    w = np.repeat(rng.uniform(0.5, 2.0, n_q), sizes) if weighted else None
    return sizes, labels, w, rng.randn(n)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", ["ndcg", "map", "lambdarank", "mean_average_precision"])
def test_ranking_metrics_match_jax(name, weighted):
    sizes, labels, w, score = _ranking_data(1, weighted=weighted)
    n = len(labels)
    params = {"eval_at": [1, 3, 5, 10], "verbose": -1}
    jm = jmetric.create_metric(name, JConfig.from_params(dict(params)))
    tm = tmetric.create_metric(name, TConfig.from_params(dict(params)))
    jm.init(JMetadata(n, label=labels, weight=w, group=sizes), n)
    tm.init(TMetadata(n, label=labels, weight=w, group=sizes), n)
    score[5:9] = 0.25  # ties: a stable sort by row
    got, want = tm.eval(score, None), jm.eval(score, None)
    assert [(m, b) for m, _, b in got] == [(m, b) for m, _, b in want]
    assert [m for m, _, _ in got][:1] in (["ndcg@1"], ["map@1"])
    np.testing.assert_allclose([v for _, v, _ in got], [v for _, v, _ in want], rtol=1e-12)


def test_ranking_metric_needs_groups():
    tm = tmetric.create_metric("ndcg", TConfig.from_params({"verbose": -1}))
    with pytest.raises(LightGBMError, match="query information"):
        tm.init(TMetadata(5, label=np.zeros(5)), 5)


# ---- trainings -----------------------------------------------------------------------

TRAIN = {"objective": "lambdarank", "metric": ["ndcg", "map"], "eval_at": [1, 3, 5],
         "num_leaves": 15, "learning_rate": 0.25, "min_data_in_leaf": 10, "verbose": -1}


def _rank_train_data(seed, n_q=60):
    rng = np.random.RandomState(seed)
    sizes = rng.randint(1, 80, n_q)
    n = int(sizes.sum())
    X = rng.randn(n, 6)
    rel = np.clip(np.round(X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.randn(n) + 1), 0, 4)
    return X, rel, sizes


def _train(pkg, params, rounds=5, weighted=False, **kw):
    X, rel, sizes = _rank_train_data(2)
    Xv, relv, sizesv = _rank_train_data(3, 20)
    w = np.repeat(np.random.RandomState(4).uniform(0.5, 2.0, len(sizes)), sizes) if weighted else None
    ds = pkg.Dataset(X, label=rel, group=sizes, weight=w)
    vs = ds.create_valid(Xv, label=relv, group=sizesv)
    res = {}
    bst = pkg.train(dict(params), ds, rounds, valid_sets=[vs], evals_result=res,
                    verbose_eval=False, **kw)
    return bst, res, X, Xv


@pytest.mark.parametrize("loop", ["host", "device"])
@pytest.mark.parametrize("weighted", [False, True])
def test_training_equals_jax(monkeypatch, weighted, loop):
    jb, jres, X, Xv = _train(jlgb, TRAIN, weighted=weighted)
    if loop == "device":
        monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")
    tb, tres, _, _ = _train(tlgb, TRAIN, weighted=weighted, device="cpu")
    assert tb._gbdt.grow_loop == loop and tb.num_trees() == jb.num_trees() == 5
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tb.predict(Xv), jb.predict(Xv), rtol=1e-4, atol=1e-5)
    assert sorted(tres["valid_0"]) == sorted(jres["valid_0"])
    for m in jres["valid_0"]:
        np.testing.assert_allclose(tres["valid_0"][m], jres["valid_0"][m], rtol=1e-6)


def test_device_loop_chunks_and_host_loop_agree(monkeypatch):
    host, _, _, _ = _train(tlgb, TRAIN, rounds=9, device="cpu")
    monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")
    one, _, _, _ = _train(tlgb, TRAIN, rounds=9, device="cpu")
    four, _, _, _ = _train(tlgb, dict(TRAIN, device_chunk_size=4), rounds=9, device="cpu")
    assert host._gbdt.grow_loop == "host" and one._gbdt.grow_loop == "device"
    assert four._gbdt.device_chunk_fallback_reason() is None
    text = one.model_to_string().split("parameters:")[0]
    assert four.model_to_string().split("parameters:")[0] == text
    assert four._gbdt.train_score().tobytes() == one._gbdt.train_score().tobytes()
    assert host.model_to_string().split("parameters:")[0] == text


def test_model_text_both_ways():
    jb, _, X, _ = _train(jlgb, TRAIN)
    tb, _, _, _ = _train(tlgb, TRAIN, device="cpu")
    t_from_j = tlgb.Booster(model_str=jb.model_to_string(), device="cpu")
    j_from_t = jlgb.Booster(model_str=tb.model_to_string())
    assert t_from_j._gbdt.objective.name == "lambdarank"
    np.testing.assert_array_equal(t_from_j.predict(X), jb.predict(X))
    np.testing.assert_array_equal(j_from_t.predict(X, raw_score=True), tb.predict(X, raw_score=True))


def test_group_api():
    X, rel, sizes = _rank_train_data(5, 10)
    ds = tlgb.Dataset(X, label=rel)
    assert ds.get_group() is None
    ds.set_field("query", sizes)
    assert ds.get_field("group") is sizes
    ids = np.repeat(np.arange(len(sizes)), sizes)  # one query id a row gives the same queries
    a = tlgb.Dataset(X, label=rel, group=ids).construct()._binned.metadata.query_boundaries
    b = ds.construct()._binned.metadata.query_boundaries
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.diff(b), sizes)
    ds.set_group(sizes[::-1])  # a constructed Dataset takes the new boundaries
    np.testing.assert_array_equal(np.diff(ds._binned.metadata.query_boundaries), sizes[::-1])
    ds.set_field("label", rel[::-1])  # a field the port refused before; the binned labels follow
    np.testing.assert_array_equal(ds.get_field("label"), rel[::-1].astype(np.float32))
    with pytest.raises(LightGBMError, match="Unknown field name"):
        ds.set_field("position", sizes)
    vs = ds.create_valid(X, label=rel, group=sizes)
    assert vs.get_group() is sizes and vs.reference is ds


@pytest.mark.parametrize("boosting", ["goss", "dart", "rf"])
def test_boosting_modes_refuse_lambdarank_by_name(boosting):
    """The name is historical: each mode trains with LambdaRank now
    (tests/test_torch_mode_objectives.py holds the pairs to the JAX package)."""
    X, rel, sizes = _rank_train_data(6, 10)
    params = {"objective": "lambdarank", "boosting": boosting, "verbose": -1}
    if boosting == "rf":
        params.update(bagging_fraction=0.8, bagging_freq=1)
    bst = tlgb.train(params, tlgb.Dataset(X, label=rel, group=sizes), 2, device="cpu")
    assert bst.num_trees() == 2 and type(bst._gbdt).__name__ == {
        "goss": "GOSS", "dart": "DART", "rf": "RandomForest"}[boosting]
    assert np.isfinite(bst.predict(X)).all()
