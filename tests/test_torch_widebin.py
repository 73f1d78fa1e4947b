"""Wide bins in the port (257 to 1024 bins a feature), on the CPU, against
the JAX package.

 * The plain histogram on int32 bins (the JAX dataset's type past 256 bins)
   and on int16 bins (the port's training copy): at B = 300 against the JAX
   package's ``histogram_pallas`` in interpret mode (the TPU kernel's wide
   range, 257-336), at B = 1024 against ``histogram_reference``; dyadic
   values, so every order of the sums gives the same bits.
 * The plain partition and bin-space predict take uint8, int16 and int32
   bins alike.
 * The plain split scan at B = 300 and 1024 against the JAX package's
   vmapped ``find_best_split`` on dyadic histograms, numerical and
   categorical features: every field equal, the gain within rtol 1e-6 (the
   8-ulp rule of tests/test_torch_split.py: XLA's fused multiply-adds).
 * Training at ``max_bin`` 300 and 1024 with a categorical feature of 400
   categories (``min_data_in_bin=1``, so the bins really are wide), through
   the host loop and the device loop (its plain versions), against
   ``lightgbm_tpu.train``, both packages' gradients patched to one dyadic
   rule (tests/test_torch_categorical.py), so every sum is exact: the
   trees, the training and validation scores and the model text are equal
   byte for byte but for the split gains, which XLA computes with fused
   multiply-adds: each package's gain lies within 8 ulps of the three
   terms' sum of the gain computed in f64 from the exact sums (the rule of
   tests/test_torch_categorical.py ``_exact_gains``).
 * A ``max_bin=1024`` model gives the same results through
   ``Booster.predict``, the packed ensemble's exact path (bit for bit), its
   fused f32 path (within 2·T·2^-24·Σ|v|) and ``pred_contrib`` (each row
   sums to the raw score within 1e-9 of its absolute sum).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu.objective as jobj
import lightgbm_tpu_torch as tlgb
import lightgbm_tpu_torch.objective as tobj
from lightgbm_tpu.ops.hist_pallas import histogram_pallas
from lightgbm_tpu.ops.histogram import histogram_reference
from lightgbm_tpu.ops.split import SplitParams as JaxSplitParams
from lightgbm_tpu.ops.split import find_best_split
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.ops import hist_kernel, packed_kernel
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops.grow import TreeArrays
from test_torch_categorical import _exact_gains, _gains_apart

EXACT = (
    "feature", "threshold", "default_left", "left_sum_grad", "left_sum_hess", "left_count",
    "right_sum_grad", "right_sum_hess", "right_count", "num_cat", "left_output", "right_output",
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- the plain histogram ---------------------------------------------------------------

def _hist_inputs(F, n, B, seed):
    """[F, n] int32 bins over [0, B) and dyadic [n, 3] values."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (F, n)).astype(np.int32)
    g = rng.randint(-64, 65, n) / 64.0
    h = rng.randint(1, 65, n) / 64.0
    return bins, np.stack([g, h, np.ones(n)], 1).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int16])
def test_histogram_at_300_matches_the_pallas_kernel(dtype):
    bins, vals = _hist_inputs(3, 1001, 300, seed=1)
    want = np.asarray(histogram_pallas(jnp.asarray(bins), jnp.asarray(vals), 300, chunk=512,
                                       dtype_name="float32", interpret=True))
    got = hist_kernel.histogram(torch.from_numpy(bins).to(dtype), torch.from_numpy(vals), 300)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int16])
def test_histogram_at_1024_matches_the_reference(dtype):
    bins, vals = _hist_inputs(4, 3000, 1024, seed=2)
    rows = np.sort(np.random.RandomState(3).permutation(3000)[:1200]).astype(np.int32)
    want = histogram_reference(bins[:, rows], vals[rows], 1024)
    # the [N, F] copy the grower reads, as a transposed view, by rows
    nf = torch.from_numpy(np.ascontiguousarray(bins.T)).to(dtype)
    got = hist_kernel.histogram(nf.t(), torch.from_numpy(vals), 1024, torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not any(hist_kernel.launches.values())  # CPU tensors: the plain version


def test_plain_partition_and_predict_take_every_bin_type():
    """The plain partition and bin-space predict give the same rows and
    leaves on uint8, int16 and int32 copies of one bin matrix (the card's
    and the JAX dataset's types), numerical and categorical nodes alike."""
    from lightgbm_tpu_torch.ops import partition as tpartition
    from lightgbm_tpu_torch.ops import predict as tpredict

    rng = np.random.RandomState(4)
    F, n = 3, 2000
    bins = rng.randint(0, 200, (F, n))
    meta = convert.meta_tensors({"num_bin": np.full(F, 200), "missing_type": np.array([0, 1, 2]),
                                 "default_bin": np.array([0, 7, 0]), "monotone": np.zeros(F),
                                 "is_categorical": np.array([False, False, True])})
    bits = tsplit.member_words(torch.from_numpy(rng.rand(200) < 0.3), 7)
    node_i = torch.tensor([[0, 90, 1, -1, 1], [2, 0, -2, -3, 0]], dtype=torch.int32)
    node_b = torch.stack([torch.zeros(7, dtype=torch.int32), bits])
    value = torch.tensor([0.5, -1.0, 2.0])
    got = []
    for dtype in (torch.uint8, torch.int16, torch.int32):
        b = torch.from_numpy(bins).to(dtype)
        order = torch.arange(n, dtype=torch.int32)
        left = [tpartition.stable_partition(order, b, 100, 1500, f, 99, 1, meta, bits)
                for f in range(F)]
        score = torch.zeros(n)
        leaf = torch.empty(n, dtype=torch.int32)
        tpredict.add_tree_value(b.t().contiguous(), node_i, torch.tensor([3], dtype=torch.int32),
                                meta, value, score, leaf, node_b)
        got.append((left, order, score, leaf))
    for other in got[1:]:
        assert other[0] == got[0][0]
        for a, b in zip(other[1:], got[0][1:]):
            assert torch.equal(a, b)
    assert set(got[0][3].tolist()) == {0, 1, 2}


# ---- the plain split scan --------------------------------------------------------------

def _scan_case(B, seed):
    """Two children's dyadic [2, F, B, 3] histograms over features of up to
    B bins (numerical with each missing type, and one categorical feature of
    B - 1 bins), their meta and feature mask."""
    rng = np.random.RandomState(seed)
    F = 5
    num_bin = np.array([B, B // 2 + 3, 40, B - 7, B - 1], np.int32)
    hist = np.zeros((2, F, B, 3), np.float32)
    for c in range(2):
        for f in range(F):
            nb = num_bin[f]
            cnt = rng.randint(0, 30, nb).astype(np.float32)
            hist[c, f, :nb, 0] = rng.randint(-8, 9, nb) * np.maximum(cnt, 1) / 8.0
            hist[c, f, :nb, 1] = cnt * 0.25
            hist[c, f, :nb, 2] = cnt
    meta = {"num_bin": num_bin, "missing_type": np.array([0, 1, 2, 2, 0], np.int32),
            "default_bin": np.array([0, 5, 0, 0, 0], np.int32),
            "monotone": np.zeros(F, np.int32),
            "is_categorical": np.array([False, False, False, False, True])}
    return hist, meta, np.ones(F, bool)


@pytest.mark.parametrize("B", [300, 1024])
def test_split_scan_matches_jax(B):
    hist, meta, fmask = _scan_case(B, seed=B)
    params = (0.0, 0.0, 0.0, 5, 1e-3, 0.0, 4, 10.0, 10.0, 32, 20)
    sums = hist[:, 0].sum(axis=1)
    mn = np.array([-np.inf, -np.inf], np.float32)
    mx = np.array([np.inf, np.inf], np.float32)
    jmeta = {k: jnp.asarray(v) for k, v in meta.items()}
    want = jax.vmap(lambda h, g, s, n, lo, hi: find_best_split(
        h, g, s, n, lo, hi, jmeta, jnp.asarray(fmask), JaxSplitParams(*params)))(
        jnp.asarray(hist), jnp.asarray(sums[:, 0]), jnp.asarray(sums[:, 1]),
        jnp.asarray(sums[:, 2]), jnp.asarray(mn), jnp.asarray(mx))
    outf, outi, outb = tsplit.find_best_split_pair(
        torch.from_numpy(hist), torch.from_numpy(sums), torch.from_numpy(np.stack([mn, mx], 1)),
        convert.meta_tensors(meta), torch.from_numpy(fmask), tsplit.SplitParams(*params))
    got = tsplit.unpack(outf, outi, outb)
    assert got.cat_bitset.shape == (2, -(-B // 32))
    for c in range(2):
        for name in EXACT:
            assert np.asarray(getattr(want, name))[c] == getattr(got, name)[c].numpy(), (B, c, name)
        np.testing.assert_array_equal(tsplit.words_member(got.cat_bitset[c], B).numpy(),
                                      np.asarray(want.cat_bitset)[c])
        np.testing.assert_allclose(got.gain[c].numpy(), np.asarray(want.gain)[c], rtol=1e-6)
    # the wide bins are in play: a threshold or a category past bin 255
    assert (got.threshold.numpy() > 255).any() or tsplit.words_member(
        got.cat_bitset, B).numpy()[:, 256:].any()


# ---- training against the JAX package --------------------------------------------------

N, NV, ROUNDS = 4000, 1000, 3
TRAIN = {"objective": "binary", "metric": "binary_logloss", "num_leaves": 31,
         "learning_rate": 0.25, "min_data_in_leaf": 20, "min_data_in_bin": 1, "cat_smooth": 5.0,
         "min_data_per_group": 20, "max_cat_threshold": 32, "verbose": -1}


def _data(seed, n):
    """Five numerical columns and one categorical column of 400 categories
    (integer-valued floats, skewed to the low ones)."""
    rng = np.random.RandomState(seed)
    X = np.empty((n, 6))
    X[:, :5] = rng.randn(n, 5)
    X[:, 5] = np.floor(rng.rand(n) ** 1.5 * 400)
    eff = np.random.RandomState(99).randn(400)
    z = X[:, 0] + 0.5 * X[:, 1] + eff[X[:, 5].astype(int)]
    return X, (z + 0.3 * rng.randn(n) > 0).astype(np.float64)


def _jax_dyadic(self, score):
    p = jnp.clip(score / 4.0 + 0.5, 1.0 / 16, 15.0 / 16)
    y = (self._y_dev + 1.0) / 2.0
    return jnp.round((p - y) * 64.0) / 64.0, jnp.maximum(jnp.round(p * (1.0 - p) * 64.0), 1.0) / 64.0


def _torch_dyadic(self, score):
    p = torch.clamp(score / 4.0 + 0.5, 1.0 / 16, 15.0 / 16)
    y = (self._y + 1.0) / 2.0
    return (torch.round((p - y) * 64.0) / 64.0,
            torch.clamp(torch.round(p * (1.0 - p) * 64.0), min=1.0) / 64.0)


@pytest.fixture
def dyadic(monkeypatch):
    monkeypatch.setattr(jobj.BinaryLogloss, "get_gradients", _jax_dyadic)
    monkeypatch.setattr(tobj.BinaryLogloss, "get_gradients", _torch_dyadic)


def _train(pkg, params, X, y, Xv, yv, **kw):
    ds = pkg.Dataset(X, label=y, categorical_feature=[5])
    vs = pkg.Dataset(Xv, label=yv, reference=ds)
    res = {}
    bst = pkg.train(dict(params), ds, ROUNDS, valid_sets=[vs], evals_result=res,
                    verbose_eval=False, **kw)
    return bst, res


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's trainings of each max_bin, once for the module."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jobj.BinaryLogloss, "get_gradients", _jax_dyadic)
        for max_bin in (300, 1024):
            X, y = _data(1, N)
            Xv, yv = _data(2, NV)
            runs[max_bin] = _train(jlgb, dict(TRAIN, max_bin=max_bin), X, y, Xv, yv)
    return runs


@pytest.mark.parametrize("loop", ["host", "device"])
@pytest.mark.parametrize("max_bin", [300, 1024])
def test_training_equals_jax(dyadic, jax_runs, monkeypatch, max_bin, loop):
    X, y = _data(1, N)
    Xv, yv = _data(2, NV)
    jb, jres = jax_runs[max_bin]
    if loop == "device":
        monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")
    tb, tres = _train(tlgb, dict(TRAIN, max_bin=max_bin), X, y, Xv, yv, device="cpu")
    g = tb._gbdt
    assert g.grow_loop == loop and g.num_bins > 256 and g.bins_dev.dtype == torch.int16
    assert g._valid_bins[0].dtype == torch.int16
    assert g.num_bins == int(np.asarray(jb._gbdt.train_set.bins).max()) + 1 or g.num_bins > 300
    assert tb.num_trees() == jb.num_trees() == ROUNDS
    params = dict(TRAIN, max_bin=max_bin)
    gains = _exact_gains(tb, params)
    for i, ta in enumerate(g._tree_arrays):
        want = jb._gbdt._device_trees[i][0]
        for name in TreeArrays._fields:
            a, b = np.asarray(getattr(want, name)), getattr(ta, name).numpy()
            if name == "leaf_value" and i == 0:
                b = b + np.float32(g._init_fold[0])
            if name == "split_gain":
                exact, bound = gains[i]
                n = len(exact)
                for gain in (a, b):
                    assert (np.abs(gain[:n] - exact) <= bound).all(), (i, gain[:n], exact, bound)
                np.testing.assert_array_equal(b[n:], a[n:])
            else:
                np.testing.assert_array_equal(b, a, err_msg="tree %d %s" % (i, name))
    # splits past bin 255: a numerical threshold or a category
    wide = [int(t.threshold_bin[n]) > 255 or bool(t.cat_member[n, 256:].any())
            for t in g._tree_arrays for n in range(int(t.num_leaves) - 1)]
    assert any(wide)
    np.testing.assert_array_equal(g.scores.numpy(), np.asarray(jb._gbdt.scores))
    np.testing.assert_array_equal(g.valid_scores[0].numpy(), np.asarray(jb._gbdt.valid_scores[0]))
    assert tres == jres
    (jbody, jgains), (tbody, tgains) = (_gains_apart(b.model_to_string()) for b in (jb, tb))
    assert tbody == jbody
    bound = np.concatenate([b_ for _, b_ in gains])
    assert (np.abs(tgains - jgains) <= 2 * bound + 1e-7 * np.abs(jgains)).all()  # 8 digits


# ---- serving a wide-bin model ----------------------------------------------------------

def test_wide_model_serves_alike_on_every_path():
    """A max_bin=1024 model through Booster.predict, the packed exact path,
    the packed fused path and pred_contrib."""
    X, y = _data(3, N)
    X = X.astype(np.float32).astype(np.float64)  # f32 rows: the fused path's codes are exact
    bst = tlgb.train(dict(TRAIN, max_bin=1024, num_leaves=15), tlgb.Dataset(
        X, label=y, categorical_feature=[5]), 4, device="cpu")
    assert bst._gbdt.num_bins > 256
    Xt = X[:500].copy()
    Xt[:20, 2] = np.nan
    raw = bst.predict(Xt, raw_score=True)
    pk = bst.to_packed(device="cpu")
    np.testing.assert_array_equal(pk.predict(Xt, raw_score=True), raw)
    np.testing.assert_array_equal(pk.predict(Xt), bst.predict(Xt))
    np.testing.assert_array_equal(pk.predict(Xt, pred_leaf=True), bst.predict(Xt, pred_leaf=True))
    # fused: f32 sums within two orders of T f32 adds of the f64 sum
    leaves = bst.predict(Xt, pred_leaf=True)
    absum = sum(np.abs(pk.leaf_value64[i][leaves[:, i]]) for i in range(pk.num_trees))
    fused = pk.predict_fused(Xt, raw_score=True)
    assert np.all(np.abs(fused - raw) <= 2.0 * pk.num_trees * 2.0 ** -24 * absum)
    codes, isnan = packed_kernel.packed_bin_rows(torch.from_numpy(Xt.astype(np.float32)),
                                                 pk.bounds_dev, pk.is_cat_dev)
    np.testing.assert_array_equal(
        packed_kernel.packed_predict_leaves(codes, isnan, pk.packed).numpy().T, leaves)
    # pred_contrib: each row's contributions sum to its raw score
    contrib = bst.predict(Xt, pred_contrib=True)
    assert contrib.shape == (len(Xt), X.shape[1] + 1)
    np.testing.assert_allclose(contrib.sum(1), raw, rtol=0, atol=1e-9 * max(1.0, np.abs(raw).max()))
    assert np.abs(contrib[:, 5]).max() > 0  # the 400-category feature takes part
