"""Validation sets, evaluation at every boundary, early stopping, callbacks
and rollback in the port, on the CPU, against the JAX package.

 * A validation set binned with ``reference=`` has the JAX package's bins
   and mappers.
 * The bin-space traversal (ops/predict.py ``tree_predict_leaf``, and
   ``add_tree_value``, the plain version of csrc/predict_bins.cu) gives the
   JAX ``tree_predict_leaf``'s leaves on the same trees, carried across as
   numpy (``convert.tree_arrays_from_numpy``), for missing types none, zero
   and nan, and the grower's own leaf index on its training rows.
 * Early stopping on the recipe of tests/test_engine.py:209 (binary_logloss,
   300 rounds, 5 rounds of patience) stops at the JAX package's
   ``best_iteration`` with ``evals_result`` within rtol 1e-5 (the fixture has
   no near-tie split), through both split loops.
 * A validation set attached after training starts holds, bit for bit, the
   score of one attached from the start; ``rollback_one_iter`` takes the last
   tree out of the training and validation scores (to f32 rounding: a sum
   and a difference); a ``learning_rates`` schedule trains the JAX package's
   trees and changes nothing the captured iteration is keyed on.
 * ``print_evaluation`` and the early stopper print the JAX package's lines;
   ``binary_error`` has its values; the engine refuses what is not ported,
   naming it.

Sizes: make_higgs_like(3000, 28), 15 leaves; the JAX trainings are shared
through module fixtures.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from helpers.bench_data import make_higgs_like
from lightgbm_tpu import callback as jcallback
from lightgbm_tpu import metric as jmetric
from lightgbm_tpu.ops.grow import TreeArrays as JaxTreeArrays
from lightgbm_tpu.ops.grow import grow_tree as jax_grow_tree
from lightgbm_tpu.ops.predict import make_predict_tree as jax_make_predict_tree
from lightgbm_tpu.ops.predict import tree_predict_leaf as jax_tree_predict_leaf
from lightgbm_tpu.ops.split import SplitParams as JaxSplitParams
from lightgbm_tpu_torch import callback as tcallback
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch import metric as tmetric
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.ops import hist_kernel, predict_kernel
from lightgbm_tpu_torch.ops import predict as tpredict

BASE = {"objective": "binary", "verbosity": -1, "num_leaves": 15, "max_bin": 63,
        "min_data_in_leaf": 5}
LOOPS = ["host", "device"]


@pytest.fixture(scope="module")
def higgs():
    return make_higgs_like(3000, 28, seed=3)


def _loop(monkeypatch, loop):
    """The device loop on the CPU: the cuda impl forced (its plain version)."""
    if loop == "device":
        monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")


# ---- binning and traversal ------------------------------------------------------


def test_valid_binning_equals_jax(higgs):
    X, y = higgs
    X = X.astype(np.float64)
    rng = np.random.RandomState(0)
    X[rng.rand(len(X)) < 0.1, 0] = np.nan
    binned = {}
    for name, pkg, cfg in (("jax", jlgb, jlgb.Config.from_params(dict(BASE))),
                           ("torch", tlgb, Config.from_params(dict(BASE)))):
        tr = pkg.Dataset(X[:2000], label=y[:2000])
        va = pkg.Dataset(X[2000:], label=y[2000:], reference=tr)
        binned[name] = (tr.get_binned(cfg), va.get_binned(cfg))
    (jt, jv), (tt, tv) = binned["jax"], binned["torch"]
    assert tv.mappers is tt.mappers
    np.testing.assert_array_equal(tv.bins, jv.bins)
    for tm, jm in zip(tv.mappers, jv.mappers):
        np.testing.assert_equal(tm.to_dict(), jm.to_dict())  # a NaN bound equals a NaN bound
    assert tv.mappers[0].missing_type == 2  # the NaN bin
    with pytest.raises(Exception, match="features"):
        tlgb.Dataset(X[:10, :5], reference=tlgb.Dataset(X[:2000], label=y[:2000])).get_binned(
            Config.from_params(dict(BASE)))


def _case(seed, missing, N=1500, F=6, B=31):
    rng = np.random.RandomState(seed)
    num_bin = rng.randint(3, B + 1, F).astype(np.int32)
    num_bin[0] = B
    bins = np.stack([rng.randint(0, nb, N) for nb in num_bin]).astype(np.uint8)
    meta = {"num_bin": num_bin, "missing_type": np.full(F, missing, np.int32),
            "default_bin": rng.randint(0, 3, F).astype(np.int32), "monotone": np.zeros(F, np.int8)}
    grad = (rng.randint(-64, 65, N) / 64.0).astype(np.float32)
    hess = (rng.randint(1, 65, N) / 64.0).astype(np.float32)
    other = np.stack([rng.randint(0, nb, 777) for nb in num_bin]).astype(np.uint8)
    return bins, meta, grad, hess, other


@pytest.mark.parametrize("missing", [0, 1, 2])
def test_bin_space_leaves_equal_jax(missing):
    bins, meta, grad, hess, other = _case(missing, missing)
    F, N = bins.shape
    jmeta = {k: jnp.asarray(v) for k, v in meta.items()}
    jtree, jleaf = jax_grow_tree(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess), jnp.ones(N, jnp.float32),
        jnp.ones(F, bool), jmeta, num_leaves=15, max_depth=-1, num_bins=int(meta["num_bin"].max()),
        params=JaxSplitParams(0.0, 1.0, 0.0, 5, 1e-3, 0.0), two_way=True,
    )
    ta = convert.tree_arrays_from_numpy({k: np.array(v) for k, v in jtree._asdict().items()})
    assert int(ta.num_leaves) == 15
    tmeta = convert.meta_tensors(meta)
    ptree = tpredict.make_predict_tree(ta, tmeta)
    jptree = jax_make_predict_tree(jtree, jmeta)
    for rows in (bins, other):
        nf = np.ascontiguousarray(rows.T)
        got = tpredict.tree_predict_leaf(torch.from_numpy(nf), ptree)
        want = np.asarray(jax_tree_predict_leaf(jnp.asarray(nf), jptree))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(tpredict.tree_predict_value(torch.from_numpy(nf), ptree).numpy(),
                                      ta.leaf_value.numpy()[want])
    # on the training rows: the grower's own leaf index
    np.testing.assert_array_equal(
        tpredict.tree_predict_leaf(torch.from_numpy(np.ascontiguousarray(bins.T)), ptree).numpy(),
        np.asarray(jleaf))
    # the kernel's plain version from the split loop's node layout: one f32 add a row
    nodes = torch.stack([ta.split_feature, ta.threshold_bin, ta.left_child, ta.right_child,
                         ta.default_left.to(torch.int32)], 1)[:14].contiguous()
    nf = torch.from_numpy(np.ascontiguousarray(other.T))
    score = torch.full((nf.shape[0],), 0.25)
    leaf_out = torch.empty(nf.shape[0], dtype=torch.int32)
    predict_kernel.add_tree_value(nf, nodes, torch.tensor([15], dtype=torch.int32), tmeta,
                                  ta.leaf_value, score, leaf_out)
    want_leaf = np.asarray(jax_tree_predict_leaf(jnp.asarray(other.T), jptree))
    np.testing.assert_array_equal(leaf_out.numpy(), want_leaf)
    assert score.numpy().tobytes() == (np.float32(0.25) + ta.leaf_value.numpy()[want_leaf]).tobytes()


def test_stump_and_unported_layouts():
    nf = torch.zeros((5, 3), dtype=torch.uint8)
    meta = {"num_bin": torch.full((3,), 4, dtype=torch.int32),
            "missing_type": torch.zeros(3, dtype=torch.int32),
            "default_bin": torch.zeros(3, dtype=torch.int32)}
    score = torch.zeros(5)
    predict_kernel.add_tree_value(nf, torch.zeros((0, 5), dtype=torch.int32),
                                  torch.tensor([1], dtype=torch.int32), meta,
                                  torch.tensor([0.5]), score)
    assert torch.equal(score, torch.full((5,), 0.5))
    # a bundled layout: two features in group 0 (offsets 1 and 3), one alone
    # in group 1; each node reads its feature's group column and decodes it,
    # as the JAX package's predict_tree does
    efb = dict(meta, group_id=torch.tensor([0, 0, 1], dtype=torch.int32),
               bin_offset=torch.tensor([1, 4, 1], dtype=torch.int32),
               default_bin=torch.tensor([0, 2, 1], dtype=torch.int32),
               missing_type=torch.tensor([0, 1, 0], dtype=torch.int32))
    nodes = dict(split_feature=[1, 0, 2], threshold_bin=[1, 2, 0], default_left=[True, False, False],
                 left_child=[1, -1, -3], right_child=[2, -2, -4])
    value = torch.tensor([1.0, 2.0, 3.0, 4.0])
    group_rows = torch.from_numpy(np.stack(np.meshgrid(np.arange(8), np.arange(4)), -1)
                                  .reshape(-1, 2).astype(np.uint8))
    got = tpredict.tree_predict_leaf(group_rows, tpredict.predict_tree(
        *nodes.values(), value, 4, efb))
    m, M = 3, 4
    jtree = JaxTreeArrays(
        num_leaves=jnp.int32(M), default_left=jnp.asarray(nodes["default_left"]),
        **{k: jnp.asarray(nodes[k], jnp.int32)
           for k in ("split_feature", "threshold_bin", "left_child", "right_child")},
        split_gain=jnp.zeros(m), internal_value=jnp.zeros(m), internal_count=jnp.zeros(m),
        leaf_value=jnp.asarray(value.numpy()), leaf_count=jnp.zeros(M), leaf_weight=jnp.zeros(M),
        leaf_parent=jnp.zeros(M, jnp.int32), leaf_depth=jnp.zeros(M, jnp.int32),
        cat_member=jnp.zeros((m, 4), bool))
    want = jax_tree_predict_leaf(jnp.asarray(group_rows.numpy()), jax_make_predict_tree(
        jtree, {k: jnp.asarray(v.numpy()) for k, v in efb.items()}))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(set(got.tolist())) == 4
    # the kernel's plain version on the split loop's node layout takes the same leaves
    node_i = torch.tensor([[f, t, l, r, int(d)] for f, t, d, l, r in zip(*nodes.values())],
                          dtype=torch.int32)
    leaf_out = torch.empty(group_rows.shape[0], dtype=torch.int32)
    score = torch.zeros(group_rows.shape[0])
    predict_kernel.add_tree_value(group_rows, node_i, torch.tensor([4], dtype=torch.int32), efb,
                                  value, score, leaf_out)
    np.testing.assert_array_equal(leaf_out.numpy(), np.asarray(want))
    # a categorical node: the row's bin looked up in the node's membership
    member = torch.tensor([[False, True, False, True]])
    ptree = tpredict.predict_tree([0], [1], [False], [-1], [-2], torch.tensor([1.0, 2.0]), 2,
                                  dict(meta, is_categorical=torch.ones(3, dtype=torch.bool)),
                                  member)
    rows = torch.tensor([[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0]], dtype=torch.uint8)
    assert tpredict.tree_predict_leaf(rows, ptree).tolist() == [1, 0, 1, 0]
    with pytest.raises(ValueError, match="device"):
        predict_kernel.add_tree_value(nf.to("meta"), None, None, meta, None, None)


# ---- early stopping against the JAX package ---------------------------------------

ES_PARAMS = dict(BASE, metric="binary_logloss")


def _es_run(pkg, X, y, **kw):
    res = {}
    tr = pkg.Dataset(X[:2000], label=y[:2000])
    va = pkg.Dataset(X[2000:], label=y[2000:], reference=tr)
    b = pkg.train(dict(ES_PARAMS), tr, 300, valid_sets=[va], early_stopping_rounds=5,
                  evals_result=res, verbose_eval=False, **kw)
    return b, res


@pytest.fixture(scope="module")
def jax_early_stopped(higgs):
    X, y = higgs
    return _es_run(jlgb, X, y)


@pytest.mark.parametrize("loop", LOOPS)
def test_early_stopping_equals_jax(higgs, jax_early_stopped, monkeypatch, loop):
    X, y = higgs
    jb, jres = jax_early_stopped
    _loop(monkeypatch, loop)
    tb, tres = _es_run(tlgb, X, y, device="cpu")
    assert tb._gbdt.grow_loop == loop
    assert 5 < jb.best_iteration < 300
    assert tb.best_iteration == jb.best_iteration
    assert tb.num_trees() == jb.num_trees() == jb.best_iteration + 5
    assert list(tres) == list(jres) == ["valid_0"]
    np.testing.assert_allclose(tres["valid_0"]["binary_logloss"], jres["valid_0"]["binary_logloss"],
                               rtol=1e-5)
    assert dict(tb.best_score["valid_0"]) == pytest.approx(dict(jb.best_score["valid_0"]), rel=1e-5)
    # predict() takes every tree, as the JAX package's does: equal to the JAX
    # model's prediction after the early stop; num_iteration=best_iteration
    # takes the first ones, which agree with the JAX model's first ones
    every = tb.predict(X[2000:], raw_score=True)
    np.testing.assert_array_equal(every, tb.predict(X[2000:], num_iteration=-1, raw_score=True))
    np.testing.assert_allclose(tb.predict(X[2000:]), jb.predict(X[2000:]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(every, jb.predict(X[2000:], raw_score=True), rtol=1e-4, atol=1e-5)
    best = tb.predict(X[2000:], num_iteration=tb.best_iteration, raw_score=True)
    assert not np.array_equal(best, every)
    np.testing.assert_allclose(best, jb.predict(X[2000:], num_iteration=jb.best_iteration,
                                                raw_score=True), rtol=1e-4, atol=1e-5)
    # the validation score is every tree's f32 adds: the raw f64 prediction to rounding
    np.testing.assert_allclose(tb._gbdt._valid_score_np(0),
                               tb.predict(X[2000:], num_iteration=-1, raw_score=True),
                               rtol=1e-5, atol=1e-5)


# ---- validation scores, rollback, learning-rate schedules --------------------------


@pytest.mark.parametrize("stop_first", [False, True])
@pytest.mark.parametrize("loop", LOOPS)
def test_add_valid_later_replays_bit_for_bit(higgs, monkeypatch, loop, stop_first):
    """Also after a first iteration that could not split: its constant tree
    holds the boost-from-average score, which the scores took twice."""
    X, y = higgs
    _loop(monkeypatch, loop)
    params = dict(BASE, metric=["auc", "binary_error"], bagging_fraction=0.7, bagging_freq=1,
                  feature_fraction=0.7)
    if stop_first:
        params["min_gain_to_split"] = 1e9
    boosters = []
    for attach_at in (0, 1 if stop_first else 4):
        tr = tlgb.Dataset(X[:2000], label=y[:2000])
        b = tlgb.Booster(dict(params), tr, device="cpu")
        for it in range(6):
            if it == attach_at:
                b.add_valid(tlgb.Dataset(X[2000:], label=y[2000:]), "v")
            b.update()
        boosters.append(b)
    a, b = boosters
    assert a.num_trees() == (1 if stop_first else 6)
    assert a._gbdt._valid_score_np(0).tobytes() == b._gbdt._valid_score_np(0).tobytes()
    assert a.eval_valid() == b.eval_valid()
    assert [e[1] for e in a.eval_valid()] == ["auc", "binary_error"]


@pytest.mark.parametrize("loop", LOOPS)
def test_rollback_restores_train_and_valid_scores(higgs, monkeypatch, loop):
    X, y = higgs
    _loop(monkeypatch, loop)
    tr = tlgb.Dataset(X[:2000], label=y[:2000])
    b = tlgb.Booster(dict(BASE, metric="auc"), tr, device="cpu")
    b.add_valid(tlgb.Dataset(X[2000:], label=y[2000:], reference=tr), "v")
    b.update()
    b.rollback_one_iter()  # the first tree takes the boost-from-average score with it
    assert b.num_trees() == 0
    np.testing.assert_allclose(b._gbdt.train_score(), 0.0, atol=1e-6)
    np.testing.assert_allclose(b._gbdt._valid_score_np(0), 0.0, atol=1e-6)
    for _ in range(4):
        b.update()
    train0, valid0 = b._gbdt.train_score(), b._gbdt._valid_score_np(0)
    text = b.model_to_string().split("parameters:")[0]
    b.update()
    assert not np.array_equal(b._gbdt._valid_score_np(0), valid0)
    b.rollback_one_iter()
    assert b.num_trees() == 4 and b.model_to_string().split("parameters:")[0] == text
    # a f32 sum and difference: equal to the rounding of the sum
    np.testing.assert_allclose(b._gbdt.train_score(), train0, rtol=0, atol=1e-6)
    np.testing.assert_allclose(b._gbdt._valid_score_np(0), valid0, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def jax_schedule(higgs):
    X, y = higgs
    rates = [0.2 * 0.8 ** i for i in range(6)]
    jb = jlgb.train(dict(BASE), jlgb.Dataset(X, label=y), 6, learning_rates=rates)
    return rates, jb


@pytest.mark.parametrize("loop", LOOPS)
def test_learning_rate_schedule_equals_jax_without_a_new_key(higgs, jax_schedule, monkeypatch,
                                                             loop):
    X, y = higgs
    rates, jb = jax_schedule
    _loop(monkeypatch, loop)
    keys = []

    def record(env):
        keys.append(env.model._gbdt._iteration_key())

    tb = tlgb.train(dict(BASE), tlgb.Dataset(X, label=y), 6, learning_rates=rates,
                    callbacks=[record], device="cpu")
    assert len(keys) == 6 and all(k == keys[0] for k in keys)
    if loop == "device":  # the rate the last iteration read on the device
        assert float(tb._gbdt._rate) == np.float32(rates[-1])
    for a, b in zip(jb._gbdt.trees(), tb._gbdt.trees()):
        assert a.num_leaves == b.num_leaves and np.array_equal(a.split_feature, b.split_feature)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tb.predict(X, raw_score=True), jb.predict(X, raw_score=True),
                               rtol=1e-4, atol=1e-5)


# ---- callbacks, metrics, the engine --------------------------------------------------


def _entries(v):
    return [("valid_0", "auc", 0.8123456789 + v, True), ("valid_0", "binary_logloss", 0.5 - v, False)]


@pytest.mark.parametrize("period,chunk", [(1, 1), (2, 1), (3, 4)])
def test_print_evaluation_lines_equal_jax(capsys, period, chunk):
    printed = {}
    for name, mod in (("jax", jcallback), ("torch", tcallback)):
        cb = mod.print_evaluation(period)
        for it in range(chunk - 1, 12, chunk):
            cb(mod.CallbackEnv(None, {}, it, 0, 12, _entries(it * 1e-3), chunk=chunk))
        printed[name] = capsys.readouterr().out
    assert printed["torch"] == printed["jax"] and printed["torch"].count("\n") >= 3


@pytest.mark.parametrize("values,end", [([0.5, 0.4, 0.45, 0.46, 0.47], 5), ([0.5, 0.4, 0.3], 3)])
def test_early_stopper_lines_and_stop_equal_jax(capsys, values, end):
    out = {}
    for name, mod in (("jax", jcallback), ("torch", tcallback)):
        cb = mod.early_stopping(2, verbose=True)
        stop = None
        for it, v in enumerate(values):
            env = mod.CallbackEnv(None, {}, it, 0, end, [("v", "l2", v, False)])
            try:
                cb(env)
            except mod.EarlyStopException as e:
                stop = (e.best_iteration, list(e.best_score))
                break
        out[name] = (stop, capsys.readouterr().out)
    assert out["torch"] == out["jax"] and out["torch"][0] is not None


def test_binary_error_equals_jax(higgs):
    _, y = higgs
    from lightgbm_tpu.dataset import Metadata as JMeta
    from lightgbm_tpu_torch.dataset import Metadata as TMeta
    score = np.random.RandomState(1).randn(len(y))
    w = np.random.RandomState(2).rand(len(y))
    for weight in (None, w):
        jm = jmetric.create_metric("binary_error", jlgb.Config.from_params(dict(BASE)))
        tm = tmetric.create_metric("binary_error", Config.from_params(dict(BASE)))
        jm.init(JMeta(len(y), label=y, weight=weight), len(y))
        tm.init(TMeta(len(y), label=y, weight=weight), len(y))
        jobj = jlgb.Booster(dict(BASE), jlgb.Dataset(np.zeros((20, 2)), label=np.arange(20) % 2))
        tobj = tlgb.Booster(dict(BASE), tlgb.Dataset(np.zeros((20, 2)), label=np.arange(20) % 2),
                            device="cpu")
        assert tm.eval(score, tobj._gbdt.objective) == jm.eval(score, jobj._gbdt.objective)


def test_eval_feval_and_eval_train(higgs):
    X, y = higgs
    tr = tlgb.Dataset(X[:2000], label=y[:2000])
    va = tr.create_valid(X[2000:], label=y[2000:])
    b = tlgb.Booster(dict(BASE, metric="auc"), tr, device="cpu")
    b.add_valid(va, "v")
    for _ in range(3):
        b.update()

    def feval(preds, data):
        return "mean_pred", float(np.mean(preds)), False

    assert b.eval(va, "v") == b.eval_valid()
    (name, metric, val, bigger), extra = b.eval_valid(feval)
    assert (name, metric, bigger) == ("v", "auc", True) and extra[:2] == ("v", "mean_pred")
    assert extra[2] == pytest.approx(float(np.mean(b.predict(X[2000:]))), rel=1e-5)
    assert b.eval(tr, "training") == b.eval_train()
    other = tlgb.Dataset(X[:500], label=y[:500])
    assert b.eval(other, "other")[0][:2] == ("other", "auc")  # attached first
    res = {}
    tlgb.train(dict(BASE, metric="auc"), tr, 3, valid_sets=[tr, va], valid_names=["train", "v"],
               evals_result=res, verbose_eval=False, device="cpu")
    assert list(res) == ["train", "v"] and len(res["train"]["auc"]) == 3


def test_chunk_clamped_to_an_early_stopping_callback(higgs, monkeypatch):
    X, y = higgs
    _loop(monkeypatch, "device")
    sizes = []
    update_chunk = tlgb.Booster.update_chunk

    def record(self, n):
        sizes.append(n)
        return update_chunk(self, n)

    monkeypatch.setattr(tlgb.Booster, "update_chunk", record)
    tr = tlgb.Dataset(X[:2000], label=y[:2000])
    tlgb.train(dict(BASE, metric="auc", device_chunk_size=8), tr, 10,
               valid_sets=[tr.create_valid(X[2000:], label=y[2000:])],
               callbacks=[tlgb.early_stopping(3, verbose=False)], verbose_eval=False, device="cpu")
    assert sizes and set(sizes) == {3}


@pytest.mark.parametrize("kwargs,name", [
    ({"params": {"resume_from": "ck"}}, "resume_from"),
    ({"params": {"preempt_exit": True}}, "preempt_exit"),
    ({"params": {"checkpoint_rounds": 5}}, "checkpoint_rounds"),
    ({"checkpoint_path": "ck"}, "checkpoint_path"),
    ({"checkpoint_rounds": 5}, "checkpoint_rounds"),
    ({"resume_from": "ck"}, "resume_from"),
    ({"checkpoint_keep": 2}, "checkpoint_keep"),
    ({"preempt_exit": True}, "preempt_exit"),
    ({"flex_plan": "plan.json"}, "flex_plan"),
    ({"params": {"checkpoint_path": "ck"}}, "checkpoint_path"),
    ({"params": {"flex_plan": "plan.json"}}, "flex_plan"),
])
def test_engine_refuses_what_is_not_ported(higgs, kwargs, name):
    X, y = higgs
    kwargs = dict(kwargs)
    params = dict(BASE, **kwargs.pop("params", {}))
    with pytest.raises(NotImplementedError, match=name):
        tlgb.train(params, tlgb.Dataset(X, label=y), 1, device="cpu", **kwargs)


def test_cv_is_not_ported():
    """The name is historical: ``cv`` was refused and now trains a Booster a
    fold (tests/test_torch_cv.py holds it to the JAX package)."""
    X, y = make_higgs_like(900, 28, seed=5)
    res = tlgb.cv(dict(BASE, metric="auc"), tlgb.Dataset(X, label=y), 3, nfold=3, device="cpu")
    assert sorted(res) == ["auc-mean", "auc-stdv"] and len(res["auc-mean"]) == 3
    assert 0.5 < res["auc-mean"][-1] <= 1.0
