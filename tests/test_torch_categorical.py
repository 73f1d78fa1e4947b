"""Categorical features in the port, on the CPU, against the JAX package.

 * The plain split scan (lightgbm_tpu_torch/ops/split.py
   ``find_best_split_pair``) against the JAX package's ``find_best_split``
   (its categorical block, lightgbm_tpu/ops/split.py:325-468) on dyadic
   histograms (multiples of 1/8 over integer counts: every prefix exact):
   the one-hot branch, the CTR branch with tied CTRs, bins under
   ``cat_smooth``, ``min_data_per_group`` grouping, the
   ``max_cat_threshold`` cap on a 200-category feature, a reverse-direction
   winner, missing NaN beside missing none over the same bins, the feature
   mask, and ``cat_l2`` in the leaf outputs. Every field and the membership
   bitset are equal; the gain is held to rtol 1e-6, the bound of XLA's
   fused multiply-adds (tests/test_torch_split.py).
 * Whole binary and multiclass trainings with categorical features through
   the host loop and the device loop (its plain versions), against
   ``lightgbm_tpu.train``: in both packages the objective's gradients and
   hessians go through the same dyadic rule of the scores (a clipped linear
   link, multiples of 1/64, no transcendental function), so every sum is
   exact and the two trainings must agree bit for bit: the TreeArrays
   (``cat_member`` included), the training and validation scores, the
   model text but its gains (within rtol 1e-6), raw-value prediction with
   unseen, negative and NaN categories, and model text loaded each way.
"""
import jax.numpy as jnp
import jax
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu.objective as jobj
import lightgbm_tpu_torch as tlgb
import lightgbm_tpu_torch.objective as tobj
from lightgbm_tpu.ops.split import SplitParams as JaxSplitParams
from lightgbm_tpu.ops.split import find_best_split
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.ops import hist_kernel
from lightgbm_tpu_torch.ops import predict as predict_plain
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops.grow import TreeArrays


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: faster alone,
    and the test workers do not oversubscribe the cores. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- the plain scan against the JAX scan ---------------------------------------------

B = 256
BASE = (0.0, 0.0, 0.0, 5, 1e-3, 0.0)  # l1, l2, max_delta_step, min_data, min_hess, min_gain


def _feature(rng, nb, counts=(0, 60), grads=8, ties=False):
    """One feature's [B, 3] dyadic histogram over ``nb`` bins: integer counts,
    hessians a quarter of the count, gradients a multiple of 1/8 of the
    count (``ties``: a few (count, gradient) pairs repeated, so CTRs tie)."""
    h = np.zeros((B, 3), np.float32)
    if ties:
        cnt = rng.choice([12, 20, 36], nb).astype(np.float32)
        g = rng.choice([-2, 1, 3], nb) * cnt / 8.0
    else:
        cnt = rng.randint(counts[0], counts[1], nb).astype(np.float32)
        g = rng.randint(-grads, grads + 1, nb) * np.maximum(cnt, 1) / 8.0
    h[:nb, 0], h[:nb, 1], h[:nb, 2] = g, cnt * 0.25, cnt
    return h


def _case(name, seed):
    """(hist [2, F, B, 3], meta, feature mask, SplitParams fields) of a case."""
    rng = np.random.RandomState(seed)
    nbs = [4, 30, 12, 64]  # categorical: one-hot, CTR, CTR; numerical
    cat = [True, True, True, False]
    missing = [0, 0, 2, 1]
    params = BASE + (4, 10.0, 10.0, 32, 100)
    kw = {}
    if name == "onehot":
        nbs, cat, missing = [4, 3, 2, 64], [True, True, True, False], [0, 2, 0, 0]
        params = BASE + (4, 10.0, 10.0, 32, 20)
    elif name == "ctr_ties":
        kw = dict(ties=True)
        params = BASE + (4, 10.0, 10.0, 32, 20)
    elif name == "smooth":
        kw = dict(counts=(0, 14))  # many bins under cat_smooth 10
        params = BASE + (4, 10.0, 10.0, 32, 10)
    elif name == "grouping":
        kw = dict(counts=(5, 40))
        params = BASE + (4, 3.0, 10.0, 32, 60)
    elif name == "cap":
        nbs, cat, missing = [200, 200, 12, 64], [True, True, True, False], [0, 1, 0, 0]
        params = BASE + (4, 1.0, 10.0, 3, 10)
    elif name == "reverse":
        params = BASE + (4, 1.0, 1.0, 2, 10)
    elif name == "missing":
        nbs, cat, missing = [30, 30, 30, 30], [True, True, True, True], [0, 2, 1, 2]
        params = BASE + (4, 5.0, 10.0, 32, 20)
    elif name == "mask":
        params = BASE + (4, 5.0, 10.0, 32, 20)
    elif name == "cat_l2":
        params = (0.0, 1.0, 0.0, 5, 1e-3, 0.0) + (4, 5.0, 5.0, 32, 20)
    F = len(nbs)
    hist = np.zeros((2, F, B, 3), np.float32)
    for c in range(2):
        for f, nb in enumerate(nbs):
            hist[c, f] = _feature(rng, nb, **kw)
    if name == "reverse":
        # a few categories of a strongly positive gradient: the best left
        # side is the top of the CTR order, taken from the reverse end
        hist[:, 1, :3, 0] = hist[:, 1, :3, 2] * 4.0
        hist[:, 1, 3:30, 0] = -hist[:, 1, 3:30, 2] / 8.0
    if name in ("missing",):
        hist[:, 1:] = hist[:, :1]  # the same bins under each missing type
        hist[:, :, 29, 2] += 40.0  # mass in the last (the NaN) bin
        hist[:, :, 29, 1] += 10.0
        hist[:, :, 29, 0] += 20.0
    # every feature's rows sum to the child's totals, those of its feature
    # with the most rows: the others' last bins take the rest
    totals = hist.sum(axis=2)  # [2, F, 3]
    for c in range(2):
        target = totals[c, np.argmax(totals[c, :, 2])]
        for f in range(F):
            hist[c, f, nbs[f] - 1] += target - totals[c, f]
    meta = {
        "num_bin": np.asarray(nbs, np.int32),
        "missing_type": np.asarray(missing, np.int32),
        "default_bin": np.zeros(F, np.int32),
        "monotone": np.zeros(F, np.int32),
        "is_categorical": np.asarray(cat, bool),
    }
    fmask = np.ones(F, bool)
    if name == "mask":
        fmask[1] = False
    elif name in ("ctr_ties", "smooth", "grouping", "reverse", "cat_l2", "cap"):
        fmask[[0, 3]] = False  # the CTR features alone compete
    return hist, meta, fmask, params


CASES = ["onehot", "ctr_ties", "smooth", "grouping", "cap", "reverse", "missing", "mask", "cat_l2"]
EXACT = ("feature", "threshold", "default_left", "left_sum_grad", "left_sum_hess",
         "left_count", "right_sum_grad", "right_sum_hess", "right_count", "num_cat",
         "left_output", "right_output")


def _scan_both(hist, meta, fmask, params, mn, mx):
    sums = hist[:, 0].sum(axis=1)
    jmeta = {k: jnp.asarray(v) for k, v in meta.items()}
    want = jax.vmap(lambda h, g, s, n, lo, hi: find_best_split(
        h, g, s, n, lo, hi, jmeta, jnp.asarray(fmask), JaxSplitParams(*params)))(
        jnp.asarray(hist), jnp.asarray(sums[:, 0]), jnp.asarray(sums[:, 1]),
        jnp.asarray(sums[:, 2]), jnp.asarray(mn), jnp.asarray(mx))
    outf, outi, outb = tsplit.find_best_split_pair(
        torch.from_numpy(hist), torch.from_numpy(sums), torch.from_numpy(np.stack([mn, mx], 1)),
        convert.meta_tensors(meta), torch.from_numpy(fmask), tsplit.SplitParams(*params))
    return tsplit.unpack(outf, outi, outb), want


@pytest.mark.parametrize("case", CASES)
def test_categorical_scan_matches_jax(case):
    hist, meta, fmask, params = _case(case, seed=CASES.index(case))
    mn = np.array([-np.inf, -0.5], np.float32)
    mx = np.array([np.inf, 0.5], np.float32)
    got, want = _scan_both(hist, meta, fmask, params, mn, mx)
    assert got.cat_bitset.shape == (2, B // 32)
    for c in range(2):
        for name in EXACT:
            a, b = np.asarray(getattr(want, name))[c], getattr(got, name)[c].numpy()
            assert a == b, (case, c, name, a, b)
        member = tsplit.words_member(got.cat_bitset[c], B).numpy()
        np.testing.assert_array_equal(member, np.asarray(want.cat_bitset)[c], err_msg=case)
        np.testing.assert_allclose(got.gain[c].numpy(), np.asarray(want.gain)[c], rtol=1e-6)
    f = got.feature.numpy()
    ncat = got.num_cat.numpy()
    # what each case is there for
    if case == "onehot":
        assert meta["is_categorical"][f].any() and (ncat[meta["is_categorical"][f]] == 1).all()
    elif case in ("ctr_ties", "smooth", "grouping", "reverse", "missing", "cat_l2"):
        assert (ncat > 1).any(), (case, f, ncat)
    elif case == "cap":
        assert (f < 2).any() and (ncat[f < 2] <= 3).all() and (ncat[f < 2] >= 1).all(), (f, ncat)
    elif case == "mask":
        assert (f != 1).all()
    if case == "reverse":
        # the left side of a reverse winner holds the highest CTRs of the feature
        c = int(np.argmax(f == 1))
        assert f[c] == 1
        ctr = hist[c, 1, :30, 0] / (hist[c, 1, :30, 1] + params[7])
        left = tsplit.words_member(got.cat_bitset[c], B).numpy()[:30]
        assert ctr[left].min() > ctr[~left & (hist[c, 1, :30, 2] >= params[7])].max()


def test_no_categorical_feature_has_no_words():
    """Without ``is_categorical`` the records carry no membership words
    (W = 0), and the scan is the numerical one."""
    hist, meta, fmask, params = _case("mask", seed=3)
    del meta["is_categorical"]
    mn = np.full(2, -np.inf, np.float32)
    mx = np.full(2, np.inf, np.float32)
    got, want = _scan_both(hist, meta, fmask, params, mn, mx)
    assert got.cat_bitset.shape == (2, 0) and (got.num_cat.numpy() == 0).all()
    np.testing.assert_array_equal(got.threshold.numpy(), np.asarray(want.threshold))


def test_member_words_round_trip():
    rng = np.random.RandomState(0)
    member = torch.from_numpy(rng.rand(5, 3, 70) < 0.4)
    words = tsplit.member_words(member, 3)
    assert words.dtype == torch.int32 and words.shape == (5, 3, 3)
    assert torch.equal(tsplit.words_member(words, 70), member)
    top = torch.zeros(1, 32, dtype=torch.bool)
    top[0, 31] = True
    assert int(tsplit.member_words(top, 1)) == -(1 << 31)


# ---- whole trainings against lightgbm_tpu.train ------------------------------------

N, NV, ROUNDS = 3000, 800, 5


def _data(seed, n, K):
    """Two numerical columns and three categorical ones (4, 30 and 150
    categories, integer-valued floats, skewed to the low categories); the
    label follows column 0 and the categories' effects."""
    rng = np.random.RandomState(seed)
    X = np.empty((n, 5))
    X[:, :2] = rng.randn(n, 2)
    for j, nc in ((2, 4), (3, 30), (4, 150)):
        X[:, j] = np.floor(rng.rand(n) ** 2 * nc)
    eff = np.random.RandomState(99).randn(3, 150)
    z = X[:, 0] + eff[0, X[:, 2].astype(int)] + eff[1, X[:, 3].astype(int)] \
        + 0.5 * eff[2, X[:, 4].astype(int)]
    if K == 1:
        return X, (z + 0.3 * rng.randn(n) > 0).astype(np.float64)
    return X, np.digitize(z + 0.3 * rng.randn(n), [-1.0, 0.5]).astype(np.float64)


def _link(score):
    """The dyadic probability of a score: 0.5 + score / 4, clipped."""
    return score / 4.0 + 0.5


def _jax_dyadic(target):
    def get_gradients(self, score):
        p = jnp.clip(_link(score), 1.0 / 16, 15.0 / 16)
        g = jnp.round((p - target(self)) * 64.0) / 64.0
        h = jnp.maximum(jnp.round(p * (1.0 - p) * 64.0), 1.0) / 64.0
        return g, h
    return get_gradients


def _torch_dyadic(target):
    def get_gradients(self, score):
        p = torch.clamp(_link(score), 1.0 / 16, 15.0 / 16)
        g = torch.round((p - target(self)) * 64.0) / 64.0
        h = torch.clamp(torch.round(p * (1.0 - p) * 64.0), min=1.0) / 64.0
        return g, h
    return get_gradients


@pytest.fixture
def dyadic(monkeypatch):
    monkeypatch.setattr(jobj.BinaryLogloss, "get_gradients",
                        _jax_dyadic(lambda o: (o._y_dev + 1.0) / 2.0))
    monkeypatch.setattr(tobj.BinaryLogloss, "get_gradients",
                        _torch_dyadic(lambda o: (o._y + 1.0) / 2.0))
    monkeypatch.setattr(jobj.MulticlassSoftmax, "get_gradients",
                        _jax_dyadic(lambda o: o._onehot_dev))
    monkeypatch.setattr(tobj.MulticlassSoftmax, "get_gradients",
                        _torch_dyadic(lambda o: o._onehot))


OBJECTIVES = {
    "binary": ({"objective": "binary", "metric": "binary_logloss"}, 1),
    "multiclass": ({"objective": "multiclass", "num_class": 3, "metric": "multi_logloss"}, 3),
}
TRAIN = {"num_leaves": 15, "learning_rate": 0.25, "min_data_in_leaf": 20, "cat_smooth": 5.0,
         "min_data_per_group": 20, "max_cat_threshold": 16, "verbose": -1}


def _train(pkg, params, X, y, Xv, yv, **kw):
    ds = pkg.Dataset(X, label=y, categorical_feature=[2, 3, 4])
    vs = pkg.Dataset(Xv, label=yv, reference=ds)
    res = {}
    bst = pkg.train(dict(params), ds, ROUNDS, valid_sets=[vs], evals_result=res,
                    verbose_eval=False, **kw)
    return bst, res


def _gains_apart(text):
    """Model text without its split_gain lines (and tree_sizes, the trees'
    lengths in bytes, which the gains' digits move), and the gains."""
    keep, gains = [], []
    for line in text.split("parameters:")[0].splitlines():
        if line.startswith("split_gain="):
            gains.extend(float(v) for v in line.split("=", 1)[1].split())
        elif not line.startswith("tree_sizes="):
            keep.append(line)
    return "\n".join(keep), np.asarray(gains)


def _replayed_gradients(g):
    """The [K, N] gradients and hessians (f64 numpy) each iteration's trees
    took in a GBDT training, replayed from the scores tree by tree."""
    K = g.num_tree_per_iteration
    scores = g._initial_scores(None, g.num_data)
    for k in range(K):
        scores[k] += np.float32(g._init_fold[k])
    out = []
    for i in range(0, len(g._tree_arrays), K):
        grad, hess = g.objective.get_gradients(scores if K > 1 else scores[0])
        grad, hess = (grad, hess) if K > 1 else (grad[None], hess[None])
        out.append((grad.double().numpy(), hess.double().numpy()))
        for kk in range(K):
            t = g._tree_arrays[i + kk]
            scores[kk] += predict_plain.tree_predict_value(g.bins_nf, predict_plain.make_predict_tree(
                t, g.feature_meta))
    return out


def _exact_gains(tb, params, grads=None):
    """Each node's gain in f64 from the exact (dyadic) sums of the rows it
    splits, G_L^2 / (H_L + l2') + G_R^2 / (H_R + l2') - G^2 / (H + l2), with
    l2' = lambda_l2 + cat_l2 at a CTR node (a categorical feature above
    max_cat_to_onehot bins), and the f32 error bound of a gain computed from
    those sums: 8 ulps of the three terms' sum. ``grads`` holds the [K, N]
    pair of histogram values each iteration's trees took; by default they
    are replayed from the scores, as a GBDT training computed them."""
    g = tb._gbdt
    K = g.num_tree_per_iteration
    if grads is None:
        grads = _replayed_gradients(g)
    l2, cat_l2 = params.get("lambda_l2", 0.0), params.get("cat_l2", 10.0)
    nbin = g.feature_meta["num_bin"].numpy()
    is_cat = g.feature_meta.get("is_categorical", torch.zeros(len(nbin), dtype=torch.bool)).numpy()
    out = []
    for i, ta in enumerate(g._tree_arrays):
        gk, hk = grads[i // K][0][i % K], grads[i // K][1][i % K]
        leaf = predict_plain.tree_predict_leaf(g.bins_nf, predict_plain.make_predict_tree(
            ta, g.feature_meta)).numpy()
        lc, rc = ta.left_child.numpy(), ta.right_child.numpy()

        def rows(child):
            leaves, stack = [], [child]
            while stack:
                c = stack.pop()
                if c < 0:
                    leaves.append(-c - 1)
                else:
                    stack.extend((lc[c], rc[c]))
            return np.isin(leaf, leaves)

        exact, bound = [], []
        for n in range(int(ta.num_leaves) - 1):
            f = int(ta.split_feature[n])
            lam = l2 + cat_l2 if is_cat[f] and nbin[f] > params.get("max_cat_to_onehot", 4) else l2
            left, right = rows(lc[n]), rows(rc[n])
            terms = [gk[m].sum() ** 2 / (hk[m].sum() + lam) for m in (left, right)]
            terms.append(gk[left | right].sum() ** 2 / (hk[left | right].sum() + l2))
            exact.append(terms[0] + terms[1] - terms[2])
            bound.append(8 * 2.0 ** -24 * sum(terms))
        out.append((np.asarray(exact), np.asarray(bound)))
    return out


@pytest.mark.parametrize("loop", ["host", "device"])
@pytest.mark.parametrize("objective", list(OBJECTIVES))
def test_training_equals_jax(dyadic, monkeypatch, objective, loop):
    extra, K = OBJECTIVES[objective]
    params = dict(TRAIN, **extra)
    X, y = _data(1, N, K)
    Xv, yv = _data(2, NV, K)
    jb, jres = _train(jlgb, params, X, y, Xv, yv)
    if loop == "device":
        monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")
    tb, tres = _train(tlgb, params, X, y, Xv, yv, device="cpu")
    g = tb._gbdt
    assert g.grow_loop == loop and g.num_words == -(-g.num_bins // 32)
    assert tb.num_trees() == jb.num_trees() == ROUNDS * K

    # the TreeArrays, cat_member included (the JAX package's first trees hold
    # their class's init score in their leaf values)
    jt = jb._gbdt._device_trees
    gains = _exact_gains(tb, params)
    n_cat = n_ctr = 0
    for i, ta in enumerate(g._tree_arrays):
        want = jt[i][0]
        for name in TreeArrays._fields:
            a, b = np.asarray(getattr(want, name)), getattr(ta, name).numpy()
            if name == "leaf_value" and i < K:
                b = b + np.float32(g._init_fold[i])
            if name == "split_gain":  # each within the f32 bound of the exact gain
                exact, bound = gains[i]
                n = len(exact)
                for gain in (a, b):
                    assert (np.abs(gain[:n] - exact) <= bound).all(), (i, gain[:n], exact, bound)
                np.testing.assert_array_equal(b[n:], a[n:])
            else:
                np.testing.assert_array_equal(b, a, err_msg="tree %d %s" % (i, name))
        nl = int(ta.num_leaves)
        cat_nodes = np.isin(ta.split_feature.numpy()[:nl - 1], [2, 3, 4])
        members = ta.cat_member.numpy()[:nl - 1].sum(1)
        n_cat += int(cat_nodes.sum())
        n_ctr += int((cat_nodes & (members > 1)).sum())
    assert n_cat and n_ctr, (n_cat, n_ctr)

    # the training and validation scores, bit for bit
    np.testing.assert_array_equal(g.scores.numpy(), np.asarray(jb._gbdt.scores))
    np.testing.assert_array_equal(g.valid_scores[0].numpy(), np.asarray(jb._gbdt.valid_scores[0]))
    assert tres == jres

    # model text, its gains apart
    jtext, ttext = jb.model_to_string(), tb.model_to_string()
    (jbody, jgains), (tbody, tgains) = _gains_apart(jtext), _gains_apart(ttext)
    assert tbody == jbody
    bound = np.concatenate([b_ for _, b_ in gains])
    assert (np.abs(tgains - jgains) <= 2 * bound + 1e-7 * np.abs(jgains)).all()  # 8 digits
    assert "cat_threshold=" in tbody

    # raw-value prediction with unseen, negative, fractional and NaN categories
    Xp = Xv[:200].copy()
    Xp[:40, 3] = [-1, -0.5, np.nan, 31, 999, 2.7, 1e6, 29.99] * 5
    Xp[40:60, 4] = np.nan
    Xp[60:80, 2] = 7
    for raw in (True, False):
        np.testing.assert_array_equal(tb.predict(Xp, raw_score=raw), jb.predict(Xp, raw_score=raw))

    # model text loaded each way predicts as the model it came from
    from_jax = tlgb.Booster(model_str=jtext, device="cpu")
    from_port = jlgb.Booster(model_str=ttext)
    np.testing.assert_array_equal(from_jax.predict(Xp), jb.predict(Xp))
    np.testing.assert_array_equal(from_port.predict(Xp), tb.predict(Xp))


def test_categorical_feature_by_name_and_auto():
    """``categorical_feature`` by name reads as by index; ``"auto"`` with no
    pandas categories is no categorical feature."""
    X, y = _data(3, 1500, 1)
    names = ["a", "b", "c", "d", "e"]
    params = dict(TRAIN, objective="binary")
    by_index = tlgb.train(dict(params), tlgb.Dataset(X, label=y, categorical_feature=[2, 3, 4]),
                          2, device="cpu")
    by_name = tlgb.train(dict(params), tlgb.Dataset(X, label=y, feature_name=names,
                                                    categorical_feature=["c", "d", "e"]),
                         2, device="cpu")
    auto = tlgb.train(dict(params), tlgb.Dataset(X, label=y), 2, device="cpu")
    assert by_index._gbdt.num_words == by_name._gbdt.num_words > 0 and auto._gbdt.num_words == 0
    np.testing.assert_array_equal(by_name.predict(X), by_index.predict(X))
    assert "is_categorical" not in auto._gbdt.feature_meta
