"""K trees an iteration in the port (models/gbdt.py), on the CPU, against the
JAX package: multiclass and multiclassova at 2,000 rows, K = 3, 8 leaves,
6 rounds, through the host loop and the device loop (its plain versions).

 * Trainings agree with the JAX package under tests/test_torch_train.py's
   rule (the same trees unless a split is an f32 near-tie; leaf values and
   raw scores within rtol 1e-4 / atol 1e-5), with bagging and
   feature_fraction (one mask a tree, iteration-major and class-minor), and
   where one class stops splitting while the others go on (multiclassova at
   min_gain_to_split 4: its trees from the fourth iteration on have one
   leaf);
 * ``predict`` returns ``[N, K]``, raw and converted;
 * ``train_chunk(4)`` equals one iteration at a time bit for bit (model
   text, training and validation scores);
 * model text goes both ways with the JAX package;
 * early stopping on ``multi_logloss`` stops at the JAX package's
   ``best_iteration`` with its ``evals_result``;
 * ``rollback_one_iter`` takes out K trees;
 * a class that no label holds keeps a constant tree, as in the JAX package;
 * regression objectives train as the JAX package's at the same size.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.ops import hist_kernel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: faster alone,
    and the test workers do not oversubscribe the cores. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N, K, ROUNDS = 2000, 3, 6
BASE = {"num_class": K, "num_leaves": 8, "learning_rate": 0.2, "min_data_in_leaf": 40,
        "verbose": -1}
CASES = {
    "multiclass": dict(BASE, objective="multiclass"),
    "multiclassova": dict(BASE, objective="multiclassova", min_gain_to_split=4.0),
    "sampled": dict(BASE, objective="multiclass", bagging_fraction=0.7, bagging_freq=2,
                    feature_fraction=0.75),
}


def _data(seed=0, n=N):
    """5 continuous and 3 binary features; classes 0 and 1 follow the
    features, class 2 is 30% of the rows drawn at random."""
    rng = np.random.RandomState(seed)
    X = np.empty((n, 8))
    X[:, :5] = rng.randn(n, 5)
    X[:, 5:] = rng.rand(n, 3) < 0.3
    y = np.where(X[:, 0] + X[:, 5] > X[:, 1] - X[:, 6], 0.0, 1.0)
    y[rng.rand(n) < 0.3] = 2.0
    return X, y


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def jax_runs(data):
    X, y = data
    return {case: jlgb.train(dict(p), jlgb.Dataset(X, label=y), ROUNDS) for case, p in CASES.items()}


def _loop(monkeypatch, loop):
    if loop == "device":
        monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")


def _assert_agrees(jb, tb, X):
    """tests/test_torch_train.py's rule, tree by tree in iteration and class
    order, then the raw and converted predictions [N, K]."""
    jt, tt = jb._gbdt.trees(), tb._gbdt.trees()
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        same = (a.num_leaves == b.num_leaves and np.array_equal(a.split_feature, b.split_feature)
                and np.array_equal(a.threshold_bin, b.threshold_bin)
                and np.array_equal(a.left_child, b.left_child))
        if not same:
            k = int(np.argmax(a.split_feature != b.split_feature))
            np.testing.assert_allclose(b.split_gain[k], a.split_gain[k], rtol=1e-5)
            return False
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(b.internal_count, a.internal_count)
    for raw in (True, False):
        got, want = tb.predict(X, raw_score=raw), jb.predict(X, raw_score=raw)
        assert got.shape == want.shape == (len(X), K)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    return True


@pytest.mark.parametrize("loop", ["host", "device"])
@pytest.mark.parametrize("case", list(CASES))
def test_training_agrees_with_jax(data, jax_runs, monkeypatch, case, loop):
    X, y = data
    _loop(monkeypatch, loop)
    tb = tlgb.train(dict(CASES[case]), tlgb.Dataset(X, label=y), ROUNDS, device="cpu")
    assert tb._gbdt.grow_loop == loop
    assert tb.num_trees() == ROUNDS * K and tb.current_iteration == ROUNDS
    assert _assert_agrees(jax_runs[case], tb, X), "a near-tie flip: the comparison stopped early"
    np.testing.assert_allclose(tb._gbdt.train_score(), tb.predict(X, raw_score=True).T,
                               rtol=1e-5, atol=1e-5)
    if case == "multiclassova":
        leaves = np.array([t.num_leaves for t in tb._gbdt.trees()]).reshape(ROUNDS, K)
        stopped = (leaves[:, 2] == 1) & (leaves[:, :2] > 1).all(1)
        # class 2 splits, then stops for good while classes 0 and 1 go on
        assert not stopped[0] and stopped[np.argmax(stopped):].all() and stopped[-1], leaves


CHUNK = dict(BASE, objective="multiclassova", min_gain_to_split=4.0, bagging_fraction=0.7,
             bagging_freq=1, feature_fraction=0.75)


def _chunk_run(params, chunk, rounds):
    X, y = _data(1, 1200)
    Xv, yv = _data(2, 400)
    ds = tlgb.Dataset(X, label=y)
    return tlgb.train(dict(params, device_chunk_size=chunk), ds, rounds,
                      valid_sets=[tlgb.Dataset(Xv, label=yv, reference=ds)], verbose_eval=False,
                      device="cpu")


@pytest.mark.parametrize("min_gain,rounds", [(4.0, 9), (20.0, 12)])
def test_chunk_4_equals_chunk_1(monkeypatch, min_gain, rounds):
    """Bit for bit, with the bag, a mask a tree and a validation set; at
    min_gain_to_split 20 every class stops in the middle of a chunk."""
    monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")
    params = dict(CHUNK, min_gain_to_split=min_gain)
    ref = _chunk_run(params, 1, rounds)
    got = _chunk_run(params, 4, rounds)
    assert got._gbdt.grow_loop == "device" and got._gbdt.device_chunk_fallback_reason() is None
    if min_gain > 4.0:
        assert 1 < ref.current_iteration < rounds and ref.current_iteration % 4 != 0
    else:
        assert ref.current_iteration == rounds
    assert got.num_trees() == ref.num_trees() == ref.current_iteration * K
    assert got.model_to_string().split("parameters:")[0] == ref.model_to_string().split("parameters:")[0]
    assert got._gbdt.train_score().tobytes() == ref._gbdt.train_score().tobytes()
    assert got._gbdt._valid_score_np(0).shape == (K, 400)
    assert got._gbdt._valid_score_np(0).tobytes() == ref._gbdt._valid_score_np(0).tobytes()


@pytest.mark.parametrize("case", ["multiclass", "multiclassova"])
def test_model_text_both_ways(data, jax_runs, case):
    X, y = data
    jb = jax_runs[case]
    tb = tlgb.train(dict(CASES[case]), tlgb.Dataset(X, label=y), ROUNDS, device="cpu")
    text = tb.model_to_string()
    assert "num_class=3" in text and "num_tree_per_iteration=3" in text
    in_jax = jlgb.Booster(model_str=text)
    in_port = tlgb.Booster(model_str=jb.model_to_string(), device="cpu")
    assert in_jax.num_trees() == in_port.num_trees() == ROUNDS * K
    for raw in (True, False):
        np.testing.assert_array_equal(in_jax.predict(X, raw_score=raw), tb.predict(X, raw_score=raw))
        np.testing.assert_array_equal(in_port.predict(X, raw_score=raw), jb.predict(X, raw_score=raw))
    assert in_port.predict(X).shape == (N, K)
    np.testing.assert_array_equal(in_port.predict(X, num_iteration=2, raw_score=True),
                                  jb.predict(X, num_iteration=2, raw_score=True))


ES = dict(BASE, objective="multiclass", learning_rate=0.5, num_leaves=15, min_data_in_leaf=5,
          metric=["multi_logloss", "multi_error"])


def _es_run(pkg, X, y, **kw):
    res = {}
    tr = pkg.Dataset(X[:1500], label=y[:1500])
    va = pkg.Dataset(X[1500:], label=y[1500:], reference=tr)
    b = pkg.train(dict(ES), tr, 40, valid_sets=[va], early_stopping_rounds=3, evals_result=res,
                  verbose_eval=False, **kw)
    return b, res


@pytest.mark.parametrize("loop", ["host", "device"])
def test_early_stopping_on_multi_logloss(data, monkeypatch, loop):
    X, y = data
    jb, jres = _es_run(jlgb, X, y)
    _loop(monkeypatch, loop)
    tb, tres = _es_run(tlgb, X, y, device="cpu")
    assert 1 < jb.best_iteration < 40
    assert tb.best_iteration == jb.best_iteration
    assert tb.num_trees() == jb.num_trees() == (jb.best_iteration + 3) * K
    for name in ("multi_logloss", "multi_error"):
        np.testing.assert_allclose(tres["valid_0"][name], jres["valid_0"][name], rtol=1e-5)
    # every tree by default, the best iterations on request, as in the JAX package
    np.testing.assert_allclose(tb.predict(X[1500:]), jb.predict(X[1500:]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tb.predict(X[1500:], num_iteration=tb.best_iteration),
                               jb.predict(X[1500:], num_iteration=jb.best_iteration),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tb._gbdt._valid_score_np(0), tb.predict(X[1500:], raw_score=True).T,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("loop", ["host", "device"])
def test_rollback_takes_out_k_trees(data, monkeypatch, loop):
    X, y = data
    _loop(monkeypatch, loop)
    tr = tlgb.Dataset(X[:1500], label=y[:1500])
    b = tlgb.Booster(dict(CASES["multiclass"]), tr, device="cpu")
    b.add_valid(tlgb.Dataset(X[1500:], label=y[1500:], reference=tr), "v")
    for _ in range(3):
        b.update()
    b.rollback_one_iter()
    assert b.num_trees() == 2 * K and b.current_iteration == 2
    np.testing.assert_allclose(b._gbdt.train_score(), b.predict(X[:1500], raw_score=True).T,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b._gbdt._valid_score_np(0), b.predict(X[1500:], raw_score=True).T,
                               rtol=1e-5, atol=1e-5)
    for _ in range(2):
        b.rollback_one_iter()
    assert b.num_trees() == 0
    assert np.abs(b._gbdt.train_score()).max() < 1e-6  # the init scores went with the first trees


@pytest.mark.parametrize("loop", ["host", "device"])
def test_untrained_class_keeps_a_constant_tree(data, monkeypatch, loop):
    """Class 1 holds no label: its trees are constant (the first its
    boost_from_score), the run takes the one-iteration path, and the model
    predicts as the JAX package's."""
    X, y = data
    y = np.where(y == 1, 2.0, y)
    params = dict(CASES["multiclass"], device_chunk_size=4)
    jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y), 3)
    _loop(monkeypatch, loop)
    tb = tlgb.train(dict(params), tlgb.Dataset(X, label=y), 3, device="cpu")
    assert tb._gbdt.device_chunk_fallback_reason() == "untrained constant class (class_need_train=False)"
    trees = tb._gbdt.trees()
    assert len(trees) == len(jb._gbdt.trees()) == 3 * K
    assert all(trees[i].num_leaves == 1 for i in range(1, 3 * K, K))
    assert trees[1].leaf_value[0] == jb._gbdt.trees()[1].leaf_value[0] != 0.0
    np.testing.assert_allclose(tb.predict(X, raw_score=True), jb.predict(X, raw_score=True),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tb._gbdt.train_score(), np.asarray(jb._gbdt.scores),
                               rtol=1e-4, atol=1e-5)


REGRESSION = {
    "regression": {"objective": "regression"},
    "regression_sqrt": {"objective": "regression", "reg_sqrt": True},
    "huber": {"objective": "huber", "alpha": 2.0},
    "poisson": {"objective": "poisson"},
    "xentropy": {"objective": "xentropy"},
}


@pytest.mark.parametrize("loop", ["host", "device"])
@pytest.mark.parametrize("case", list(REGRESSION))
def test_regression_training_agrees_with_jax(data, monkeypatch, case, loop):
    X, _ = data
    rng = np.random.RandomState(5)
    t = X[:, 0] * 2.0 + X[:, 5] - X[:, 1] * X[:, 6] + rng.randn(N) * 0.5
    y = {"poisson": np.floor(np.exp(t / 3.0)), "xentropy": 1.0 / (1.0 + np.exp(-t))}.get(case, t * 3.0)
    params = dict(REGRESSION[case], num_leaves=8, learning_rate=0.2, min_data_in_leaf=40,
                  verbose=-1, metric="l2")
    jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y), ROUNDS)
    _loop(monkeypatch, loop)
    tb = tlgb.train(dict(params), tlgb.Dataset(X, label=y), ROUNDS, device="cpu")
    assert tb._gbdt.grow_loop == loop and tb.num_trees() == ROUNDS
    jt, tt = jb._gbdt.trees(), tb._gbdt.trees()
    flipped = False
    for a, b in zip(jt, tt):
        if not (a.num_leaves == b.num_leaves and np.array_equal(a.split_feature, b.split_feature)
                and np.array_equal(a.threshold_bin, b.threshold_bin)):
            k = int(np.argmax(a.split_feature != b.split_feature))
            np.testing.assert_allclose(b.split_gain[k], a.split_gain[k], rtol=1e-5)
            flipped = True
            break
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4, atol=1e-5)
    if not flipped:
        np.testing.assert_allclose(tb.predict(X, raw_score=True), jb.predict(X, raw_score=True),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=1e-4, atol=1e-5)
    ((_, name, tval, _),) = tb.eval_train()
    ((_, _, jval, _),) = jb.eval_train()
    assert name == "l2" and tval == pytest.approx(jval, rel=1e-4)
