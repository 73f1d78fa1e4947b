"""Sparse input and EFB-bundled datasets in the port, on the CPU, against
the JAX package.

 * Construction: a scipy CSR or CSC matrix bins and bundles as the JAX
   package's does (``bins`` bytes, ``group_id``, ``bin_offset``,
   ``max_group_bins``, every mapper's bounds), and so do validation sets,
   sparse and dense, binned against a bundled reference.
 * The plain remap (lightgbm_tpu_torch/ops/remap.py ``remap_hist``, the
   plain version of csrc/efb_remap.cu) equals the feature-space histogram
   of the densified, unbundled matrix bit for bit on dyadic values
   (multiples of 1/8), and lies within the f32 bound of two summation
   orders on real ones; ``decode_col`` inverts efb.py's encoding for every
   feature and group bin.
 * Whole binary and multiclass trainings on a one-hot fixture whose
   categorical column shares a bundle, through the host loop and the device
   loop (its plain versions), in the bitwise tier of
   tests/test_torch_categorical.py (both packages' gradients through one
   dyadic rule): the TreeArrays equal the JAX package's node for node, the
   training and validation scores bit for bit, the model text but its
   gains, the gains within 8 ulps of the exact f64 gain; the device loop
   equals the host loop (binary) and chunks of 4 single iterations
   (multiclass).
 * The port's bundled model equals its model of the densified matrix: the
   same split features and thresholds, predictions within rtol 1e-6.
 * A bundled validation set gives the JAX package's ``evals_result`` and
   ``best_iteration`` under early stopping; one of another layout is
   refused.
 * ``Booster.predict`` on CSR input equals the JAX package's and the port's
   own prediction of the dense array.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu.efb as jefb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu_torch import efb as tefb
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.ops import hist_kernel, remap
from lightgbm_tpu_torch.ops.grow import TreeArrays
from lightgbm_tpu_torch.ops.histogram import leaf_histogram
from test_torch_categorical import _exact_gains, _gains_apart, dyadic  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_sparse(n, f, density, seed):
    """tests/test_sparse_efb.py's fixture: uniform values at ``density``, a
    label from every fifth of the first 50 columns."""
    rng = np.random.RandomState(seed)
    X = sp.random(n, f, density=density, format="csr", random_state=rng, dtype=np.float64)
    sig = np.zeros(n)
    for j in range(0, min(f, 50), 5):
        sig += X[:, j].toarray().ravel()
    return X, (sig + 0.1 * rng.randn(n) > np.median(sig)).astype(np.float64)


#: the one-hot fixture's categorical column
CAT = 10


def _onehot(seed, n, K):
    """31 columns as CSR: two dense numerical ones; a one-hot block of 8
    columns whose rows are exclusive with a categorical column (categories
    1-6, column CAT); a one-hot block of 20 columns exclusive with a sparse
    numerical column of many values (column 30). The label (K classes)
    follows column 0 and every block's effect."""
    rng = np.random.RandomState(seed)
    eff = np.random.RandomState(99).randn(4, 22)
    X = np.zeros((n, 31))
    X[:, :2] = rng.randn(n, 2)
    a = rng.randint(0, 12, n)  # 0-7 block A, 8-10 the categorical column, 11 neither
    rows = np.arange(n)
    X[rows[a < 8], 2 + a[a < 8]] = 1.0
    cat = rng.randint(1, 7, n)
    X[(a >= 8) & (a < 11), CAT] = cat[(a >= 8) & (a < 11)]
    b = rng.randint(0, 22, n)  # 0-19 block B, 20 the sparse numerical column, 21 neither
    X[rows[b < 20], 11 + b[b < 20]] = 1.0
    X[b == 20, 30] = rng.rand(int((b == 20).sum())) * 4.0 + 0.1
    z = X[:, 0] + eff[0, a] + 2.0 * eff[1, X[:, CAT].astype(int)] + eff[2, b] \
        + np.where(b == 20, X[:, 30] - 2.0, 0.0)
    if K == 1:
        y = (z + 0.3 * rng.randn(n) > 0).astype(np.float64)
    else:
        y = np.digitize(z + 0.3 * rng.randn(n), [-0.7, 0.7]).astype(np.float64)
    return sp.csr_matrix(X), y


PARAMS = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
          "learning_rate": 0.2, "verbose": -1, "max_conflict_rate": 0.0}


def _binned(pkg, X, y, params, reference=None, cat=None):
    kw = {} if cat is None else {"categorical_feature": cat}
    if pkg is jlgb:
        ds = jlgb.Dataset(X, label=y, reference=reference, **kw)
        ds.construct(JConfig.from_params(params))
        return ds, ds._binned
    ds = tlgb.Dataset(X, label=y, reference=reference, **kw)
    return ds, ds.get_binned(Config.from_params(params))


def _same_binned(a, b):
    assert a.bins.dtype == b.bins.dtype and a.bins.tobytes() == b.bins.tobytes()
    assert a.is_bundled == b.is_bundled
    if a.is_bundled:
        np.testing.assert_array_equal(a.group_id, b.group_id)
        np.testing.assert_array_equal(a.bin_offset, b.bin_offset)
        assert a.max_group_bins == b.max_group_bins and a.num_groups == b.num_groups
    assert list(a.used_feature_idx) == list(b.used_feature_idx)
    for ma, mb in zip(a.mappers, b.mappers):
        assert (ma.num_bin, ma.default_bin, ma.missing_type, ma.bin_type) == (
            mb.num_bin, mb.default_bin, mb.missing_type, mb.bin_type)
        np.testing.assert_array_equal(np.asarray(ma.bin_upper_bound),
                                      np.asarray(mb.bin_upper_bound))


@pytest.mark.parametrize("fmt", ["csr", "csc"])
@pytest.mark.parametrize("fixture", ["random", "onehot"])
def test_construction_equals_jax(fixture, fmt):
    if fixture == "random":
        X, y = _random_sparse(2000, 80, 0.02, seed=3)
        Xv, yv = _random_sparse(400, 80, 0.02, seed=4)
        cat = None
    else:
        X, y = _onehot(1, 2000, 1)
        Xv, yv = _onehot(2, 400, 1)
        cat = [CAT]
    X, Xv = X.asformat(fmt), Xv.asformat(fmt)
    jds, jb = _binned(jlgb, X, y, PARAMS, cat=cat)
    tds, tb = _binned(tlgb, X, y, PARAMS, cat=cat)
    assert tb.is_bundled and tb.num_groups < tb.num_features / 2, tb.num_groups
    _same_binned(tb, jb)
    for valid in (Xv, Xv.toarray()):  # sparse and dense, re-encoded into the bundles
        _, jv = _binned(jlgb, valid, yv, PARAMS, reference=jds)
        _, tv = _binned(tlgb, valid, yv, PARAMS, reference=tds)
        assert tv.is_bundled
        _same_binned(tv, jv)
    if fixture == "onehot":  # the categorical feature shares its bundle
        f = list(tb.used_feature_idx).index(CAT)
        assert tb.mappers[f].bin_type == 1
        assert (tb.group_id == tb.group_id[f]).sum() > 1


def test_decode_inverts_encoding():
    X, y = _onehot(1, 2000, 1)
    _, b = _binned(tlgb, X, y, PARAMS, cat=[CAT])
    for f, m in enumerate(b.mappers):
        g, off, d, nb = int(b.group_id[f]), int(b.bin_offset[f]), m.default_bin, m.num_bin
        width = int(max(b.bin_offset[h] + b.mappers[h].num_bin - 1
                        for h in np.nonzero(b.group_id == g)[0]))
        col = np.arange(width)
        want = np.full(width, d)
        subs = np.array([s for s in range(nb) if s != d])
        want[tefb.encode_subbin(subs, d, off)] = subs
        got = remap.decode_col(torch.from_numpy(col), off, d, nb).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jefb.decode_subbin(col, off, d, nb))
        # every row's group byte decodes to the feature's sub-bin of the dense matrix
        dense = m.values_to_bins(X[:, b.used_feature_idx[f]].toarray().ravel())
        np.testing.assert_array_equal(
            remap.decode_col(torch.from_numpy(b.bins[g].astype(np.int64)), off, d, nb).numpy(),
            dense)


@pytest.mark.parametrize("values", ["dyadic", "real"])
@pytest.mark.parametrize("fixture", ["random", "onehot"])
def test_remap_equals_dense_histogram(fixture, values):
    X, y = _random_sparse(2000, 80, 0.02, seed=3) if fixture == "random" else _onehot(1, 2000, 1)
    cat = None if fixture == "random" else [CAT]
    _, b = _binned(tlgb, X, y, PARAMS, cat=cat)
    _, d = _binned(tlgb, X.toarray(), y, PARAMS, cat=cat)
    assert b.is_bundled and not d.is_bundled
    rng = np.random.RandomState(5)
    n = X.shape[0]
    v = np.stack([rng.randn(n), rng.rand(n), np.ones(n)], 1)
    if values == "dyadic":
        v[:, :2] = np.round(v[:, :2] * 8) / 8
    v = torch.from_numpy(v.astype(np.float32))
    meta = {k: torch.from_numpy(np.asarray(a).astype(np.int32))
            for k, a in b.feature_meta_arrays().items() if k != "is_categorical"}
    B = b.max_num_bin
    for rows in (None, torch.from_numpy(np.sort(rng.choice(n, 600, replace=False))).int()):
        vr = v if rows is None else v[rows.long()]
        gh = leaf_histogram(torch.from_numpy(b.bins), v, b.max_group_bins, rows)
        got = remap.remap_hist(gh, vr.sum(0), meta, B)
        want = leaf_histogram(torch.from_numpy(d.bins), v, B, rows)
        if values == "dyadic":
            assert got.numpy().tobytes() == want.numpy().tobytes()
        else:
            abs_sum = vr.abs().sum(0)
            bound = vr.shape[0] * 2.0 ** -23 * abs_sum + 1e-6
            assert ((got - want).abs() <= bound).all(), float(((got - want).abs() / bound).max())
        # the default row sums the other rows in the kernel's pairwise order
        f = 0
        dbin = int(meta["default_bin"][f])
        others = got[f].clone()
        others[dbin] = 0.0
        assert torch.equal(got[f, dbin], vr.sum(0) - remap.pairwise_sum(others[None])[0])


# ---- whole trainings in the bitwise tier ----------------------------------------------

N, NV, ROUNDS = 3000, 800, 5
OBJECTIVES = {
    "binary": ({"objective": "binary", "metric": "binary_logloss"}, 1),
    "multiclass": ({"objective": "multiclass", "num_class": 3, "metric": "multi_logloss"}, 3),
}
TRAIN = {"num_leaves": 15, "learning_rate": 0.25, "min_data_in_leaf": 20, "cat_smooth": 5.0,
         "min_data_per_group": 20, "max_cat_threshold": 16, "verbose": -1}
_jax_runs = {}


def _train(pkg, params, X, y, Xv, yv, rounds=ROUNDS, **kw):
    ds = pkg.Dataset(X, label=y, categorical_feature=[CAT])
    vs = pkg.Dataset(Xv, label=yv, reference=ds)
    res = {}
    bst = pkg.train(dict(params), ds, rounds, valid_sets=[vs], evals_result=res,
                    verbose_eval=False, **kw)
    return bst, res


def _jax_run(objective):
    """The JAX package's dyadic training of ``objective`` (run once; the
    caller holds the ``dyadic`` patch)."""
    if objective not in _jax_runs:
        extra, K = OBJECTIVES[objective]
        X, y = _onehot(1, N, K)
        Xv, yv = _onehot(2, NV, K)
        _jax_runs[objective] = _train(jlgb, dict(TRAIN, **extra), X, y, Xv, yv)
    return _jax_runs[objective]


@pytest.mark.parametrize("loop", ["host", "device"])
@pytest.mark.parametrize("objective", list(OBJECTIVES))
def test_bundled_training_equals_jax(dyadic, monkeypatch, objective, loop):
    extra, K = OBJECTIVES[objective]
    params = dict(TRAIN, **extra)
    X, y = _onehot(1, N, K)
    Xv, yv = _onehot(2, NV, K)
    jb, jres = _jax_run(objective)
    if loop == "device":
        monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")
    tb, tres = _train(tlgb, params, X, y, Xv, yv, device="cpu")
    g = tb._gbdt
    assert g.grow_loop == loop and g.num_groups == g.train_set.num_groups < g.train_set.num_features
    assert g.hist_width == g.train_set.max_group_bins and g.num_words > 0
    assert tb.num_trees() == jb.num_trees() == ROUNDS * K

    jt = jb._gbdt._device_trees
    gains = _exact_gains(tb, params)
    f_cat = list(g.train_set.used_feature_idx).index(CAT)
    bundled = set(np.nonzero(np.bincount(g.train_set.group_id)[g.train_set.group_id] > 1)[0])
    n_cat = n_bundled = 0
    for i, ta in enumerate(g._tree_arrays):
        want = jt[i][0]
        for name in TreeArrays._fields:
            a, b = np.asarray(getattr(want, name)), getattr(ta, name).numpy()
            if name == "leaf_value" and i < K:
                b = b + np.float32(g._init_fold[i])
            if name == "split_gain":  # each within 8 ulps of the exact gain
                exact, bound = gains[i]
                n = len(exact)
                for gain in (a, b):
                    assert (np.abs(gain[:n] - exact) <= bound).all(), (i, gain[:n], exact, bound)
                np.testing.assert_array_equal(b[n:], a[n:])
            else:
                np.testing.assert_array_equal(b, a, err_msg="tree %d %s" % (i, name))
        feats = ta.split_feature.numpy()[:int(ta.num_leaves) - 1]
        n_cat += int((feats == f_cat).sum())
        n_bundled += int(np.isin(feats, list(bundled)).sum())
    assert n_cat and n_bundled, (n_cat, n_bundled)

    np.testing.assert_array_equal(g.scores.numpy(), np.asarray(jb._gbdt.scores))
    np.testing.assert_array_equal(g.valid_scores[0].numpy(), np.asarray(jb._gbdt.valid_scores[0]))
    assert tres == jres

    jtext, ttext = jb.model_to_string(), tb.model_to_string()
    (jbody, jgains), (tbody, tgains) = _gains_apart(jtext), _gains_apart(ttext)
    assert tbody == jbody
    bound = np.concatenate([b_ for _, b_ in gains])
    assert (np.abs(tgains - jgains) <= 2 * bound + 1e-7 * np.abs(jgains)).all()

    # Booster.predict on CSR input: the JAX package's, and the dense array's
    for raw in (True, False):
        np.testing.assert_array_equal(tb.predict(Xv, raw_score=raw), jb.predict(Xv, raw_score=raw))
        np.testing.assert_array_equal(tb.predict(Xv, raw_score=raw),
                                      tb.predict(Xv.toarray(), raw_score=raw))

    if loop == "device":
        # the device loop equals the host loop (binary), and chunks of 4
        # single iterations (multiclass: K trees a replay)
        for kw in ({"device_chunk_size": 4} if K > 1 else {},):
            if not kw:
                monkeypatch.setattr(hist_kernel, "_ENV_IMPL", None)
            other, ores = _train(tlgb, dict(params, **kw), X, y, Xv, yv, device="cpu")
            assert other._gbdt.grow_loop == ("device" if kw else "host")
            assert other.model_to_string().split("parameters:")[0] == \
                ttext.split("parameters:")[0]
            if not kw:  # a chunk evaluates at its boundaries only
                assert ores == tres
            assert other._gbdt.scores.numpy().tobytes() == g.scores.numpy().tobytes()


def test_bundled_equals_densified():
    """tests/test_sparse_efb.py:42-63 for the port: conflict-free bundling
    is exact up to the f32 order of the default row."""
    X, y = _random_sparse(2000, 80, 0.02, seed=3)
    bst_sparse = tlgb.train(PARAMS, tlgb.Dataset(X, label=y), 8, device="cpu")
    bst_dense = tlgb.train(PARAMS, tlgb.Dataset(X.toarray(), label=y), 8, device="cpu")
    assert bst_sparse._gbdt.num_groups and not bst_dense._gbdt.num_groups
    Xd = X.toarray()
    np.testing.assert_allclose(bst_sparse.predict(Xd), bst_dense.predict(Xd), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(bst_sparse.predict(X), bst_sparse.predict(Xd))
    for ts, td in zip(bst_sparse._gbdt.trees(), bst_dense._gbdt.trees()):
        np.testing.assert_array_equal(ts.split_feature, td.split_feature)
        np.testing.assert_allclose(ts.threshold, td.threshold, rtol=1e-12)


def test_bundled_validation_early_stopping_equals_jax(dyadic):
    X, y = _onehot(1, N, 1)
    Xv, yv = _onehot(2, NV, 1)
    params = dict(TRAIN, objective="binary", metric="binary_logloss", learning_rate=0.6)
    runs = {}
    for pkg, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        runs[pkg] = _train(pkg, params, X, y, Xv, yv, rounds=60, early_stopping_rounds=2, **kw)
    (jb, jres), (tb, tres) = runs[jlgb], runs[tlgb]
    assert tres == jres and tb.best_iteration == jb.best_iteration < 60
    assert tb.num_trees() == jb.num_trees() == tb.best_iteration + 2


def test_valid_set_of_another_layout_is_refused():
    X, y = _onehot(1, 1000, 1)
    tr = tlgb.Dataset(X, label=y)
    bst = tlgb.Booster(dict(PARAMS), tr, device="cpu")
    assert bst._gbdt.num_groups
    unbundled = tlgb.Dataset(X, label=y).get_binned(
        Config.from_params(dict(PARAMS, enable_bundle=False)))
    assert not unbundled.is_bundled
    with pytest.raises(ValueError, match="bundles"):
        bst._gbdt.add_valid(unbundled, [], "other")
