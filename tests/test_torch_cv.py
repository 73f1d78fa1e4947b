"""Cross-validation and row subsets in the port (lightgbm_tpu_torch/engine.py
``cv``, ``_make_n_folds``, ``CVBooster``; basic.py ``Dataset.subset`` /
``construct_subset``), on the CPU, against the JAX package.

 * the folds of ``_make_n_folds`` equal the JAX package's from the same
   ``seed``: stratified, shuffled, in order, by whole queries, and an
   sklearn-style ``folds`` object split on labels and query ids;
 * a subset's BinnedDataset equals the JAX package's ``construct_subset``:
   the bins gathered on the parent's mappers (and EFB groups and offsets,
   with a categorical column in a bundle, which ``add_valid``'s layout
   check then takes), labels, weights, ``[N]`` and class-major init scores,
   and the query boundaries rebuilt;
 * ``cv`` results equal the JAX package's: on the dyadic gradients of
   tests/test_torch_categorical.py exactly (stratified binary, shuffled
   regression with ``metrics=``, multiclass, early stopping with
   ``print_evaluation(show_stdv=)``, a custom objective and ``feval``); a
   LambdaRank ``cv`` over query folds within rtol 1e-5 (real-valued
   lambdas).
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu import engine as jengine
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu_torch import engine as tengine
from lightgbm_tpu_torch.config import Config as TConfig
from test_torch_boosting import _patch_dyadic
from test_torch_custom import _dyadic


def fold_fobj(preds, dataset):
    """A dyadic binary log-loss objective reading a fold's labels through its
    reference and rows (the JAX package's subsets hold no labels of their own)."""
    label = np.asarray(dataset.reference.label, np.float64)[dataset.used_indices]
    p = 1.0 / (1.0 + np.exp(-preds))
    return _dyadic(p - label, p * (1.0 - p))


def fold_feval(preds, dataset):
    return ("mean_score", float(np.mean(preds)), False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TRAIN = {"num_leaves": 7, "learning_rate": 0.3, "min_data_in_leaf": 10, "verbose": -1}


def _data(seed=0, n=700, K=1):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5)
    z = X[:, 0] - 0.6 * X[:, 1] + 0.4 * rng.randn(n)
    if K == 1:
        return X, (z > 0.3).astype(np.float64)
    return X, np.digitize(z, [-0.5, 0.5]).astype(np.float64)


def _queries(seed=1, n_q=50):
    rng = np.random.RandomState(seed)
    sizes = rng.randint(2, 25, n_q)
    X = rng.randn(sizes.sum(), 5)
    rel = np.clip(np.round(X[:, 0] + 0.4 * rng.randn(len(X)) + 1), 0, 3)
    return X, rel, sizes


class _Splitter:
    """An sklearn-style folds object: ``split(X, y, groups)``."""

    def split(self, X, y=None, groups=None):
        key = groups if groups is not None else np.arange(len(X))
        for k in range(3):
            test = np.nonzero(key % 3 == k)[0]
            yield np.setdiff1d(np.arange(len(X)), test), test


@pytest.mark.parametrize("kind", ["stratified", "shuffled", "in_order", "query", "query_in_order",
                                  "splitter", "splitter_query"])
def test_folds_equal_jax(kind):
    if kind.startswith(("query", "splitter_query")):
        X, y, group = _queries()
    else:
        (X, y), group = _data(), None
    stratified = kind == "stratified"
    shuffle = kind not in ("in_order", "query_in_order")
    folds = _Splitter() if kind.startswith("splitter") else None
    params = {"objective": "binary", "verbose": -1}
    want = jengine._make_n_folds(jlgb.Dataset(X, label=y, group=group), folds, 4, params, 7,
                                 stratified, shuffle, JConfig.from_params(params))
    got = tengine._make_n_folds(tlgb.Dataset(X, label=y, group=group), folds, 4, params, 7,
                                stratified, shuffle, TConfig.from_params(params))
    want, got = list(want), list(got)
    assert len(got) == len(want) == (3 if folds else 4)
    for (gt, gs), (wt, ws) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gs, ws)


def _subset_pair(X, idx, params, **fields):
    """The JAX package's and the port's subset BinnedDatasets of ``X``."""
    out = []
    for pkg, Config in ((jlgb, JConfig), (tlgb, TConfig)):
        full = pkg.Dataset(X, **fields)
        sub = full.subset(idx)
        config = Config.from_params(params)
        out.append(sub.construct_subset(config) if pkg is jlgb else sub.get_binned(config))
    return out


@pytest.mark.parametrize("case", ["dense", "weighted_init", "multiclass_init", "query",
                                  "bundled_categorical"])
def test_subset_equals_jax(case):
    rng = np.random.RandomState(3)
    params = {"verbose": -1}
    fields = {}
    if case == "query":
        X, y, sizes = _queries()
        fields["group"] = sizes
        qb = np.concatenate([[0], np.cumsum(sizes)])
        idx = np.concatenate([np.arange(qb[q], qb[q + 1]) for q in (1, 2, 5, 9, 30)])
    else:
        X, y = _data(2, 600)
        idx = np.sort(rng.choice(600, 250, replace=False))
    fields["label"] = y
    if case == "weighted_init":
        fields.update(weight=rng.rand(len(y)) + 0.5, init_score=rng.randn(len(y)))
    if case == "multiclass_init":
        fields["init_score"] = rng.randn(3 * len(y))
    if case == "bundled_categorical":
        hot = np.zeros((600, 6))
        hot[np.arange(600), rng.randint(0, 6, 600)] = 1.0
        X = sp.csr_matrix(np.c_[X[:, :2], hot, rng.randint(0, 5, 600) * (rng.rand(600) < 0.2)])
        fields["categorical_feature"] = [8]
    want, got = _subset_pair(X, idx, params, **fields)
    np.testing.assert_array_equal(got.bins, want.bins)
    assert got.num_data == len(idx) and got.mappers is not None
    assert [m.to_dict() for m in got.mappers] == [m.to_dict() for m in want.mappers]
    for name in ("label", "weight", "init_score", "query_boundaries"):
        a, b = getattr(got.metadata, name), getattr(want.metadata, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert got.is_bundled == want.is_bundled == (case == "bundled_categorical")
    if got.is_bundled:
        np.testing.assert_array_equal(got.group_id, want.group_id)
        np.testing.assert_array_equal(got.bin_offset, want.bin_offset)
        # a fold's test rows attach to a Booster of its training rows
        full = tlgb.Dataset(X, label=y, categorical_feature=[8])
        bst = tlgb.Booster(dict(TRAIN, objective="binary"), full.subset(idx), device="cpu")
        bst.add_valid(full.subset(np.setdiff1d(np.arange(600), idx)), "valid")
        bst.update()
        assert bst._gbdt.num_groups > 0 and len(bst.eval_valid()) == 1


def _cv_pair(params, X, y, **kw):
    out = []
    for pkg in (jlgb, tlgb):
        extra = {"device": "cpu"} if pkg is tlgb else {}
        out.append(pkg.cv(dict(params), pkg.Dataset(X, label=y), **kw, **extra))
    return out


CV_CASES = {
    "stratified_binary": (dict(TRAIN, objective="binary", metric=["binary_logloss", "auc"]), 1,
                          dict(num_boost_round=6, nfold=4)),
    "shuffled_metrics": (dict(TRAIN, objective="binary"), 1,
                         dict(num_boost_round=5, nfold=3, stratified=False, metrics="auc",
                              seed=3)),
    "multiclass": (dict(TRAIN, objective="multiclass", num_class=3), 3,
                   dict(num_boost_round=4, nfold=3)),
    "early_stopping": (dict(TRAIN, objective="binary", metric="binary_logloss",
                            learning_rate=1.5), 1,
                       dict(num_boost_round=40, nfold=3, early_stopping_rounds=2,
                            verbose_eval=True, show_stdv=False)),
    "fobj_feval": (dict(TRAIN, objective="binary", metric="custom"), 1,
                   dict(num_boost_round=4, nfold=3, fobj=fold_fobj, feval=fold_feval)),
}


@pytest.mark.parametrize("case", list(CV_CASES))
def test_cv_equals_jax(monkeypatch, capsys, case):
    _patch_dyadic(monkeypatch)
    params, K, kw = CV_CASES[case]
    X, y = _data(4, 600, K)
    want, got = _cv_pair(params, X, y, **kw)
    assert got == want and got
    n = len(next(iter(got.values())))
    if case == "early_stopping":
        assert n < kw["num_boost_round"]
        lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("[")]
        assert lines and all("+" not in l for l in lines)
        assert lines[:n] == lines[len(lines) // 2:][:n]  # the same lines from both packages
    else:
        assert n == kw["num_boost_round"]


def test_cv_over_query_folds_equals_jax():
    X, rel, sizes = _queries(5, 60)
    params = dict(TRAIN, objective="lambdarank", metric="ndcg", eval_at=[3])
    out = []
    for pkg in (jlgb, tlgb):
        extra = {"device": "cpu"} if pkg is tlgb else {}
        out.append(pkg.cv(dict(params), pkg.Dataset(X, label=rel, group=sizes), 4, nfold=3,
                          **extra))
    want, got = out
    assert sorted(got) == sorted(want) == ["ndcg@3-mean", "ndcg@3-stdv"]
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-7)


def test_cvbooster_calls_each_fold():
    booster = tengine.CVBooster()
    X, y = _data(6, 300)
    for seed in (0, 1):
        booster._append(tlgb.Booster(dict(TRAIN, objective="binary", seed=seed),
                                     tlgb.Dataset(X, label=y), device="cpu"))
    assert booster.update() == [False, False]
    assert booster.num_trees() == [1, 1] and booster.best_iteration == -1
    # return_cvbooster: the folds' Boosters beside the results, each on its subset
    res = tlgb.cv(dict(TRAIN, objective="binary", metric="auc"), tlgb.Dataset(X, label=y), 3,
                  nfold=3, early_stopping_rounds=1, return_cvbooster=True, device="cpu")
    cvb = res.pop("cvbooster")
    assert len(cvb.boosters) == 3 and sorted(res) == ["auc-mean", "auc-stdv"]
    assert [b.train_set.num_data() for b in cvb.boosters] == [200, 200, 200]
    assert cvb.best_iteration in (-1, len(res["auc-mean"]))


def test_subset_takes_the_predictor(tmp_path):
    """A subset continued from a model takes the model's scores of its rows
    as init scores (the per-tree f32 replay)."""
    X, y = _data(7, 400)
    first = tlgb.train(dict(TRAIN, objective="binary"), tlgb.Dataset(X, label=y), 3,
                       verbose_eval=False, device="cpu")
    idx = np.arange(50, 350)
    sub = tlgb.Dataset(X, label=y).subset(idx).set_predictor(first)
    np.testing.assert_array_equal(sub.construct()._binned.metadata.init_score,
                                  first._gbdt.warmstart_scores(X[idx])[0])
    warm = tlgb.train(dict(TRAIN, objective="binary"), tlgb.Dataset(X, label=y).subset(idx), 2,
                      init_model=first, verbose_eval=False, device="cpu")
    assert warm.num_trees() == 5
