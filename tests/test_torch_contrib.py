"""SHAP contributions of the PyTorch port (``Booster.predict(pred_contrib=True)``,
ops/shap.py, the plain version of csrc/tree_shap.cu) against the JAX
package's ``predict_contrib``, on the CPU.

Models are built by the JAX package and read by both packages from the same
model text, so the comparison is of the TreeSHAP arithmetic alone: equal
bits, every expression kept in the Python's order of f64 operations and each
row's leaves added in its own (hot child first) order. The JAX reference
runs TreeSHAP in Python row by row, so the models are small (at most 5
trees of at most 15 leaves) and the rows few (at most 200).
"""
import itertools
import math

import numpy as np
import pytest
import torch

import chip_smoke
import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.ops import shap as shap_plain
from lightgbm_tpu_torch.ops import shap_kernel


def _rows(n=200, f=5, seed=3, nan_every=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    if nan_every:
        X[::nan_every, 1] = np.nan
        X[1::nan_every, 3] = np.nan
    return X


def _model(case):
    """(JAX booster, rows) of each case."""
    params = {"verbosity": -1, "num_leaves": 15, "min_data_in_leaf": 5}
    if case == "binary":
        X = _rows()
        y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] > 0).astype(np.float64)
        params["objective"] = "binary"
    elif case == "multiclass":
        X = _rows(seed=4)
        y = (X[:, 0] > 0).astype(np.float64) + (X[:, 1] > 0.5)
        params.update(objective="multiclass", num_class=3)
    elif case == "categorical":
        X = _rows(seed=5)
        X[:, 2] = np.random.RandomState(6).randint(0, 40, len(X))
        X[::9, 2] = np.nan
        X[1::11, 2] = -3.0
        y = ((X[:, 2] % 3 == 0) | (X[:, 0] > 1)).astype(np.float64)
        params.update(objective="binary", max_cat_to_onehot=2, min_data_per_group=5,
                      cat_smooth=1.0)
        return jlgb.train(params, jlgb.Dataset(X, label=y, categorical_feature=[2]), 5), X
    elif case == "nan":
        X = _rows(seed=7, nan_every=5)
        y = (np.nan_to_num(X[:, 1], nan=1.0) + X[:, 0] > 0.3).astype(np.float64)
        params.update(objective="regression", use_missing=True)
    else:  # random forest: an average_output model
        X = _rows(seed=8)
        y = (X[:, 0] - X[:, 4] > 0).astype(np.float64)
        params.update(objective="binary", boosting="rf", bagging_fraction=0.7, bagging_freq=1,
                      feature_fraction=0.8)
    return jlgb.train(params, jlgb.Dataset(X, label=y), 5 if case != "multiclass" else 3), X


CASES = ["binary", "multiclass", "categorical", "nan", "rf"]


@pytest.mark.parametrize("case", CASES)
def test_contrib_equals_jax(case):
    jbst, X = _model(case)
    text = jbst.model_to_string()
    tbst = tlgb.Booster(model_str=text, device="cpu")
    if case == "categorical":
        assert any(t.num_cat > 0 for t in tbst._gbdt.trees())
    if case == "rf":
        assert tbst._gbdt.average_output
    want = jlgb.Booster(model_str=text).predict(X, pred_contrib=True)
    got = tbst.predict(X, pred_contrib=True)
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    # the first iterations only, as num_iteration clips them
    np.testing.assert_array_equal(tbst.predict(X[:20], pred_contrib=True, num_iteration=2),
                                  jbst.predict(X[:20], pred_contrib=True, num_iteration=2))


@pytest.mark.parametrize("case", CASES)
def test_contrib_rows_sum_to_raw_score(case):
    jbst, X = _model(case)
    tbst = tlgb.Booster(model_str=jbst.model_to_string(), device="cpu")
    contrib = tbst.predict(X, pred_contrib=True)
    raw = tbst.predict(X, raw_score=True)
    K = tbst.num_model_per_iteration()
    F1 = X.shape[1] + 1
    sums = contrib.reshape(len(X), K, F1).sum(axis=2)
    np.testing.assert_allclose(sums[:, 0] if K == 1 else sums, raw, rtol=1e-9, atol=1e-12)


def _expvalue(tree, x, subset, node=0):
    """The coverage-weighted conditional expectation (EXPVALUE of the
    TreeSHAP paper), as tests/test_contrib.py computes it."""
    if node < 0:
        return float(tree.leaf_value[-(node + 1)])
    f = int(tree.split_feature[node])
    left, right = int(tree.left_child[node]), int(tree.right_child[node])
    if f in subset:
        return _expvalue(tree, x, subset, left if tree._decide(node, float(x[f])) else right)
    wl, wr = tree._data_count(left), tree._data_count(right)
    return (wl * _expvalue(tree, x, subset, left) + wr * _expvalue(tree, x, subset, right)) / (wl + wr)


def _brute_shap(tree, x, num_features):
    """Exact Shapley values by subset enumeration."""
    phi = np.zeros(num_features + 1)
    feats = list(range(num_features))
    for i in feats:
        others = [f for f in feats if f != i]
        for k in range(num_features):
            for S in itertools.combinations(others, k):
                wgt = (math.factorial(k) * math.factorial(num_features - k - 1)
                       / math.factorial(num_features))
                phi[i] += wgt * (_expvalue(tree, x, set(S) | {i}) - _expvalue(tree, x, set(S)))
    phi[-1] = _expvalue(tree, x, set())
    return phi


def test_contrib_matches_brute_force_shapley():
    X = _rows(n=200, f=4, seed=3)
    y = ((X[:, 0] + 0.5 * X[:, 1] * X[:, 2]) > 0).astype(np.float64)
    bst = tlgb.train({"objective": "binary", "num_leaves": 8, "min_data_in_leaf": 10,
                      "verbose": -1}, tlgb.Dataset(X, label=y), 1, device="cpu")
    tree = bst._gbdt.trees()[0]
    assert tree.num_leaves > 2
    got = shap_plain.tree_contrib(torch.as_tensor(X[:5]), tree, 4).numpy()
    for r in range(5):
        np.testing.assert_allclose(got[r], _brute_shap(tree, X[r], 4), rtol=1e-9, atol=1e-12)


def test_chain_tree_of_depth_70():
    """A hand-written chain of 70 levels over 6 features (each repeats down
    the chain, so the path unwinds), every missing type: the port's plain
    version equals the JAX package's contributions."""
    text = chip_smoke.chain_model_text(70, 6, seed=3)
    X = _rows(n=60, f=6, seed=11, nan_every=4)
    X[::7, 0] = 0.0
    tbst = tlgb.Booster(model_str=text, device="cpu")
    assert tbst._gbdt.trees()[0].max_depth() == 70
    got = tbst.predict(X, pred_contrib=True)
    np.testing.assert_array_equal(got, jlgb.Booster(model_str=text).predict(X, pred_contrib=True))
    # the port's own host reference (Tree.predict_contrib, row by row) too
    np.testing.assert_array_equal(got, tbst._gbdt.trees()[0].predict_contrib(X, 6))
    np.testing.assert_allclose(got.sum(axis=1), tbst.predict(X), rtol=1e-9, atol=1e-12)


def test_wrapper_takes_the_plain_version_on_the_cpu_and_counts_no_launch():
    jbst, X = _model("multiclass")
    trees = tlgb.Booster(model_str=jbst.model_to_string(), device="cpu")._gbdt.trees()
    shap_kernel.reset_launches()
    ens = shap_kernel.shap_trees(trees, "cpu")
    Xt = torch.as_tensor(X)
    got = shap_kernel.tree_shap(Xt, ens, 3, X.shape[1])
    assert torch.equal(got, shap_plain.contrib_plain(Xt, trees, 3, X.shape[1]))
    assert shap_kernel.launches["tree_shap"] == 0
    with pytest.raises(ValueError, match="device"):
        shap_kernel.tree_shap(torch.zeros((4, 5), dtype=torch.float64, device="meta"), ens, 3, 5)
    with pytest.raises(ValueError, match="feature"):
        shap_kernel.tree_shap(Xt[:, :2], ens, 3, 2)


def test_shap_trees_pack_nodes_leaves_and_bitsets():
    """The node records csrc/tree_shap.cu reads: children, counts as f64, the
    bitset's first word and word count in the pool, the legacy flag of a
    categorical node in a tree without bitsets, and the scratch sizes."""
    jbst, _ = _model("categorical")
    trees = tlgb.Booster(model_str=jbst.model_to_string(), device="cpu")._gbdt.trees()
    ens = shap_kernel.shap_trees(trees, "cpu")
    T, M = len(trees), max(t.num_leaves - 1 for t in trees)
    nodes = ens.nodes.numpy().view(shap_kernel.NODE_DTYPE).reshape(T, M)
    leaves = ens.leaves.numpy().view(shap_kernel.LEAF_DTYPE).reshape(T, M + 1)
    words = ens.words.numpy().view(np.uint32)
    base = 0
    for i, t in enumerate(trees):
        n = t.num_leaves - 1
        np.testing.assert_array_equal(nodes["left"][i, :n], t.left_child[:n])
        np.testing.assert_array_equal(nodes["count"][i, :n], t.internal_count[:n])
        np.testing.assert_array_equal(leaves["value"][i, :n + 1], t.leaf_value)
        for node in range(n):
            if t._is_categorical(node):
                lo, nw = nodes["cat_lo"][i, node], nodes["cat_nw"][i, node]
                cat_idx = int(t.threshold[node])
                want = t.cat_threshold[t.cat_boundaries[cat_idx]:t.cat_boundaries[cat_idx + 1]]
                np.testing.assert_array_equal(words[lo:lo + nw], want)
                assert lo >= base
        base += len(t.cat_threshold)
    legacy = next(t for t in trees if t.num_cat > 0)
    legacy.num_cat = 0
    flags = shap_kernel.shap_trees([legacy], "cpu").nodes.numpy().view(
        shap_kernel.NODE_DTYPE).reshape(-1)
    cat_nodes = [j for j in range(legacy.num_leaves - 1) if legacy._is_categorical(j)]
    assert cat_nodes and all(flags["flags"][j] & shap_kernel.LEGACY_CATEGORICAL for j in cat_nodes)
    assert shap_kernel.path_positions(25) == 27 * 28 // 2 + 27
    assert shap_kernel.slot_bytes(25) == shap_kernel.path_positions(25) * 28 + 27 * 32
