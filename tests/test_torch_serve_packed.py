"""The port's packed serving ensemble against the JAX package's
(tests/test_serve_packed.py, case for case).

Each model is trained by the port on the CPU and carried to the JAX package
as model text, so both packages pack the same trees. The contract:
- ``pack_booster``'s fields, lattices and f64 leaf values equal the JAX
  package's;
- codes (``packed_bin_rows``) and leaves (``packed_predict_leaves``) equal
  the JAX package's bit for bit, on the port's own packed model and, through
  ``convert.packed_trees_from_numpy``, on the JAX package's;
- the exact path equals the JAX ``PackedEnsemble.predict`` and the port's
  ``Booster.predict`` bit for bit (values, raw scores, leaves), and
  ``Booster.predict(pred_leaf=True)`` equals the JAX package's;
- the fused path's raw scores lie within 2·T·2^-24·Σ|v| of the JAX
  package's a row (both sum T f32 values, in two orders);
plus the bucket cache's zero retraces after warmup, the micro-batcher and
the serving metrics.
"""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops import predict as jpredict
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.models.model_text import model_fingerprint, save_model_to_string
from lightgbm_tpu_torch.obs import retrace
from lightgbm_tpu_torch.ops import packed_kernel
from lightgbm_tpu_torch.ops import predict as tpredict
from lightgbm_tpu_torch.serve.batcher import MicroBatcher
from lightgbm_tpu_torch.serve.cache import BucketedDispatcher, next_bucket
from lightgbm_tpu_torch.serve.metrics import LatencyWindow, RateMeter, ServeMetrics
from lightgbm_tpu_torch.utils.log import LightGBMError

FIELDS = tuple(packed_kernel.FIELDS)


def _data(rng, n=600, f=7, cat_col=None, nan_frac=0.06):
    X = rng.randn(n, f)
    if cat_col is not None:
        X[:, cat_col] = rng.randint(0, 12, n)
    if nan_frac:
        X[rng.rand(n, f) < nan_frac] = np.nan
    return X


def _train(params, X, y, rounds, **ds):
    full = {"verbosity": -1, **params}
    return tlgb.train(full, tlgb.Dataset(X, label=y, **ds), rounds, device="cpu")


def _fused_bound(pk, leaves):
    """[N, K] (or [N]) f32 bound of two orders of T f32 adds: 2·T·2^-24·Σ|v|
    over each class's trees at the row's leaves."""
    K = pk.num_tree_per_iteration
    absum = np.zeros((leaves.shape[0], K))
    for i in range(pk.num_trees):
        absum[:, i % K] += np.abs(pk.leaf_value64[i][leaves[:, i]])
    bound = 2.0 * pk.num_trees * 2.0 ** -24 * absum
    return bound[:, 0] if K == 1 else bound


def _assert_parity(tbst, X, multiclass=False):
    """The port's packed ensemble against its own Booster and the JAX
    package's packed ensemble of the same model text; returns both."""
    pk = tbst.to_packed()
    assert pk.device == torch.device("cpu")
    assert np.array_equal(tbst.predict(X), pk.predict(X))
    assert np.array_equal(tbst.predict(X, raw_score=True), pk.predict(X, raw_score=True))
    leaf_ref = tbst.predict(X, pred_leaf=True)
    leaf_got = pk.predict(X, pred_leaf=True)
    assert leaf_ref.dtype == leaf_got.dtype == np.int32
    assert np.array_equal(leaf_ref, leaf_got)
    if multiclass:
        assert pk.predict(X).shape == (X.shape[0], pk.num_class)

    jbst = jlgb.Booster(model_str=tbst.model_to_string())
    jpk = jbst.to_packed()
    # pack_booster's fields, lattices and leaf values equal the JAX package's
    for name in FIELDS:
        want = np.asarray(getattr(jpk.packed, name))
        got = getattr(pk.packed, name).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert len(pk.feat_bounds) == len(jpk.feat_bounds)
    for a, b in zip(pk.feat_bounds, jpk.feat_bounds):
        assert np.array_equal(a, b)
    assert np.array_equal(pk.is_cat_feat, jpk.is_cat_feat)
    assert np.array_equal(pk.leaf_value64, jpk.leaf_value64)
    assert np.array_equal(pk.bounds_dev.numpy(), np.asarray(jpk.bounds_dev))
    assert (pk.num_class, pk.num_tree_per_iteration, pk.average_output) == (
        jpk.num_class, jpk.num_tree_per_iteration, jpk.average_output)
    # the exact path and pred_leaf equal the JAX package's bit for bit
    assert np.array_equal(pk.predict(X), jpk.predict(X))
    assert np.array_equal(pk.predict(X, raw_score=True), jpk.predict(X, raw_score=True))
    assert np.array_equal(leaf_got, jpk.predict(X, pred_leaf=True))
    assert np.array_equal(leaf_ref, jbst.predict(X, pred_leaf=True))
    # codes and leaves of the fused path equal the JAX package's bit for bit
    X32 = X.astype(np.float32)
    jc, jn = jpredict.packed_bin_rows(jnp.asarray(X32), jpk.bounds_dev, jpk.is_cat_dev)
    tc, tn = packed_kernel.packed_bin_rows(torch.from_numpy(X32), pk.bounds_dev, pk.is_cat_dev)
    assert tc.dtype == torch.int32 and tn.dtype == torch.bool
    assert np.array_equal(tc.numpy(), np.asarray(jc)) and np.array_equal(tn.numpy(), np.asarray(jn))
    jl = np.asarray(jpredict.packed_predict_leaves(jc, jn, jpk.packed))
    tl = packed_kernel.packed_predict_leaves(tc, tn, pk.packed)
    assert tl.dtype == torch.int32 and np.array_equal(tl.numpy(), jl)
    # the fused sums: within the bound of two f32 orders of the JAX package's
    got = pk.predict_fused(X, raw_score=True)
    want = jpk.predict_fused(X, raw_score=True)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= _fused_bound(pk, tl.numpy().T))
    # and the port's f32 sum is the in-order one, bit for bit
    vals = pk.packed.leaf_value.numpy()[np.arange(pk.num_trees)[:, None], tl.numpy()]
    seq = np.zeros((pk.num_tree_per_iteration, X.shape[0]), np.float32)
    for i in range(pk.num_trees):
        seq[i % pk.num_tree_per_iteration] += vals[i]
    if pk.average_output:
        seq /= np.float32(max(pk.num_trees // pk.num_tree_per_iteration, 1))
    fused = packed_kernel.packed_predict_values(tc, tn, pk.packed, pk.num_tree_per_iteration,
                                                pk.average_output)
    assert fused.dtype == torch.float32 and np.array_equal(fused.numpy(), seq)
    return pk, jpk


@pytest.fixture(scope="module")
def rng_m():
    return np.random.RandomState(7)


def test_binary_parity_with_nan_and_categorical(rng_m):
    X = _data(rng_m, cat_col=3)
    y = (np.nan_to_num(X[:, 0] + 0.5 * X[:, 1]) + 2.0 * (np.nan_to_num(X[:, 3]) % 3 == 0)
         > 0.5).astype(float)
    bst = _train({"objective": "binary", "num_leaves": 15, "seed": 3}, X, y, 4,
                 categorical_feature=[3])
    Xt = _data(rng_m, n=300, cat_col=3, nan_frac=0.1)
    Xt[:5, 3] = 25  # unseen categories route right, both paths
    Xt[5:8, 3] = -1  # negative categories too
    pk, _ = _assert_parity(bst, Xt)
    assert pk.packed.is_cat.any() and pk.packed.cat_n.max() > 0
    # fused f32 fast path: approximately equal, never used for the contract
    assert np.allclose(bst.predict(Xt), pk.predict_fused(Xt), rtol=1e-4, atol=1e-5)
    assert np.allclose(bst.predict(Xt, raw_score=True), pk.predict_fused(Xt, raw_score=True),
                       rtol=1e-4, atol=1e-4)


def test_multiclass_parity(rng_m):
    X = _data(rng_m)
    y = rng_m.randint(0, 3, X.shape[0]).astype(float)
    bst = _train({"objective": "multiclass", "num_class": 3, "num_leaves": 7}, X, y, 3)
    Xt = _data(rng_m, n=200)
    pk, _ = _assert_parity(bst, Xt, multiclass=True)
    assert np.allclose(bst.predict(Xt), pk.predict_fused(Xt), rtol=1e-4, atol=1e-5)


def test_renew_l1_parity(rng_m):
    X = _data(rng_m)
    y = np.nan_to_num(X[:, 0]) + 0.1 * rng_m.randn(X.shape[0])
    bst = _train({"objective": "regression_l1", "num_leaves": 15}, X, y, 4)
    _assert_parity(bst, _data(rng_m, n=200))


def test_rf_average_output_parity(rng_m):
    X = _data(rng_m, nan_frac=0)
    y = (X[:, 0] > 0).astype(float)
    bst = _train({"objective": "binary", "boosting": "rf", "bagging_fraction": 0.7,
                  "bagging_freq": 1, "num_leaves": 15}, X, y, 4)
    pk, _ = _assert_parity(bst, _data(rng_m, n=200, nan_frac=0))
    assert pk.average_output


def test_loaded_model_parity(rng_m):
    """Pack of a text-round-tripped model == pack of the live model, and
    one fingerprint in both packages."""
    X = _data(rng_m, cat_col=2)
    y = (np.nan_to_num(X[:, 0]) + 2.0 * (np.nan_to_num(X[:, 2]) % 4 == 1) > 0.5).astype(float)
    bst = _train({"objective": "binary", "num_leaves": 15}, X, y, 3, categorical_feature=[2])
    loaded = convert.booster_from_model_string(bst.model_to_string(), device="cpu")
    Xt = _data(rng_m, n=200, cat_col=2)
    pk, jpk = _assert_parity(loaded, Xt)
    assert np.array_equal(bst.predict(Xt), pk.predict(Xt))
    assert pk.fingerprint == bst.to_packed().fingerprint == jpk.fingerprint


def test_num_iteration_clip(rng_m):
    X = _data(rng_m, nan_frac=0)
    y = X[:, 0] + 0.1 * rng_m.randn(X.shape[0])
    bst = _train({"objective": "regression", "num_leaves": 15}, X, y, 5)
    Xt = _data(rng_m, n=100, nan_frac=0)
    pk = bst.to_packed(num_iteration=3)
    assert pk.num_trees == 3
    assert np.array_equal(bst.predict(Xt, num_iteration=3), pk.predict(Xt))
    assert np.array_equal(bst.predict(Xt, num_iteration=3, pred_leaf=True),
                          pk.predict(Xt, pred_leaf=True))
    jpk = jlgb.Booster(model_str=bst.model_to_string()).to_packed(num_iteration=3)
    assert np.array_equal(pk.predict(Xt), jpk.predict(Xt))


def test_fingerprint_hashes_the_packed_range(rng_m):
    """One fingerprint means one model: the packed ensemble hashes the model
    text of exactly its iteration range (the JAX package's rule)."""
    X = _data(rng_m, n=200, nan_frac=0)
    y = (X[:, 0] > 0).astype(float)
    bst = _train({"objective": "binary", "num_leaves": 7}, X, y, 3)
    assert bst.to_packed().fingerprint == model_fingerprint(save_model_to_string(bst._gbdt, 0, -1))
    assert bst.to_packed(num_iteration=2).fingerprint == model_fingerprint(
        save_model_to_string(bst._gbdt, 0, 2))
    assert bst.to_packed(num_iteration=2).fingerprint != bst.to_packed().fingerprint


def test_input_validation(rng_m):
    X = _data(rng_m, n=200, nan_frac=0)
    y = (X[:, 0] > 0).astype(float)
    bst = _train({"objective": "binary", "num_leaves": 7}, X, y, 2)
    pk = bst.to_packed()
    with pytest.raises(LightGBMError):
        pk.predict(np.zeros(7))  # 1-d is ambiguous, like Booster.predict
    with pytest.raises(LightGBMError):
        pk.predict(np.zeros((3, 9)))  # wrong width


def test_unported_prediction_arguments_raise(rng_m):
    """``save_drift_reference`` (the drift monitor) still raises; the SHAP
    contributions and prediction early stopping are ported and give the JAX
    package's values (tests/test_torch_contrib.py and
    tests/test_torch_predict_rest.py hold them bit for bit)."""
    X = _data(rng_m, n=200, nan_frac=0)
    y = (X[:, 0] > 0).astype(float)
    bst = _train({"objective": "binary", "num_leaves": 7}, X, y, 2)
    jbst = jlgb.Booster(model_str=bst.model_to_string())
    np.testing.assert_array_equal(bst.predict(X, pred_contrib=True),
                                  jbst.predict(X, pred_contrib=True))
    kw = dict(pred_early_stop=True, pred_early_stop_freq=1, pred_early_stop_margin=0.05)
    np.testing.assert_array_equal(bst.predict(X, **kw), jbst.predict(X, **kw))
    with pytest.raises(NotImplementedError, match="save_drift_reference"):
        bst.save_drift_reference("m.txt")


# ---------------------------------------------------------------------------
# every decision rule, on a hand-built JAX PackedTrees driven through the port
# ---------------------------------------------------------------------------


def _hand_packed():
    """Three trees over 3 features: a stump; a missing-zero numerical node
    and a legacy single-category equality node (cat_n == 0); a bitset node
    under missing NaN and a missing-NaN numerical node."""
    T, M = 3, 2
    f = dict(
        feature=np.array([[0, 0], [0, 1], [1, 2]], np.int32),
        thr_rank=np.array([[0, 0], [2, 3], [0, 1]], np.int32),
        default_left=np.array([[False, False], [True, False], [False, True]]),
        missing_type=np.array([[0, 0], [1, 0], [2, 2]], np.int32),
        left_child=np.array([[-1, -1], [-1, -2], [1, -1]], np.int32),
        right_child=np.array([[-1, -1], [1, -3], [-3, -2]], np.int32),
        is_cat=np.array([[False, False], [False, True], [True, False]]),
        cat_off=np.array([[0, 0], [0, 0], [0, 0]], np.int32),
        cat_n=np.array([[0, 0], [0, 0], [2, 0]], np.int32),
        leaf_value=np.array([[0.5, 0, 0], [1.0, -2.0, 0.25], [3.0, -0.125, 7.5]], np.float32),
        num_leaves=np.array([1, 3, 3], np.int32),
        cat_words=np.array([0b1010_0110, 1 << 3], np.uint32),
        rank0=np.array([2, 0, 1], np.int32),
        zero_lo=np.array([1, 0, 0], np.int32),
        zero_hi=np.array([2, 0, 1], np.int32),
    )
    assert f["feature"].shape == (T, M)
    return jpredict.PackedTrees(**{k: jnp.asarray(v) for k, v in f.items()})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decision_rules_equal_jax_on_its_packed_model(seed):
    jp = _hand_packed()
    tp = convert.packed_trees_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()})
    for name in FIELDS:
        assert getattr(tp, name).dtype == packed_kernel.FIELDS[name][0]
        assert np.array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)))
    rng = np.random.RandomState(seed)
    N = 400
    codes = rng.randint(-3, 70, (N, 3)).astype(np.int32)
    isnan = rng.rand(N, 3) < 0.25
    want = np.asarray(jpredict.packed_predict_leaves(jnp.asarray(codes), jnp.asarray(isnan), jp))
    got = packed_kernel.packed_predict_leaves(torch.from_numpy(codes), torch.from_numpy(isnan), tp)
    assert np.array_equal(got.numpy(), want)
    assert set(np.unique(want[1])) == {0, 1, 2} and set(np.unique(want[2])) == {0, 1, 2}
    assert np.all(want[0] == 0)  # the stump
    sums = {}
    for K, avg in ((1, False), (3, False), (1, True)):
        wv = np.asarray(jpredict.packed_predict_values(
            jnp.asarray(codes), jnp.asarray(isnan), jp, num_class=K, average_output=avg))
        tv = packed_kernel.packed_predict_values(torch.from_numpy(codes), torch.from_numpy(isnan),
                                                 tp, K, avg).numpy()
        if not avg:
            # dyadic leaf values: every summation order is exact
            assert np.array_equal(tv, wv)
            sums[K] = tv
        else:
            # the average is the IEEE quotient of the sum by the 3 iterations;
            # XLA may multiply by the reciprocal instead: one rounding apart
            assert np.array_equal(tv, sums[1] / np.float32(3))
            assert np.all(np.abs(tv - wv) <= np.spacing(np.abs(wv)))


def test_bin_rows_edges_equal_jax():
    """-0.0, +/-inf, NaN, values on a bound, and clipped categories."""
    bounds = np.array([[-1e-35, 0.0, 1e-35, 0.5, np.inf], [-2.0, 1.0, 3.0, np.inf, np.inf],
                       [0, 0, 0, 0, 0]], np.float32)
    is_cat = np.array([False, False, True])
    X = np.array([[-0.0, -2.0, 3.7], [0.0, 1.0, -3.7], [np.inf, np.inf, 5e9],
                  [-np.inf, -np.inf, -5e9], [np.nan, np.nan, np.nan], [0.5, 3.0, 12.0],
                  [1e-35, 2.9999998, -0.0], [np.float32(1e-35) * 2, 0.99999994, 2.0e9]], np.float32)
    jc, jn = jpredict.packed_bin_rows(jnp.asarray(X), jnp.asarray(bounds), jnp.asarray(is_cat))
    tc, tn = packed_kernel.packed_bin_rows(torch.from_numpy(X), torch.from_numpy(bounds),
                                           torch.from_numpy(is_cat))
    assert np.array_equal(tc.numpy(), np.asarray(jc)) and np.array_equal(tn.numpy(), np.asarray(jn))
    assert tc[2, 0] == 4 and tc[0, 0] == tc[1, 0] == 1


def test_wrappers_refuse_other_devices():
    p = convert.packed_trees_from_numpy(
        {k: np.asarray(v) for k, v in _hand_packed()._asdict().items()})
    codes = torch.zeros((4, 3), dtype=torch.int32, device="meta")
    isnan = torch.zeros((4, 3), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="device"):
        packed_kernel.packed_predict_leaves(codes, isnan, p)
    with pytest.raises(ValueError, match="device"):
        packed_kernel.packed_predict_values(codes, isnan, p)
    with pytest.raises(ValueError, match="device"):
        packed_kernel.packed_bin_rows(torch.zeros((4, 3), device="meta"),
                                      torch.zeros((3, 2), device="meta"),
                                      torch.zeros(3, dtype=torch.bool, device="meta"))


def test_cpu_path_launches_no_kernel(rng_m):
    packed_kernel.reset_launches()
    X = _data(rng_m, n=200)
    y = (np.nan_to_num(X[:, 0]) > 0).astype(float)
    pk = _train({"objective": "binary", "num_leaves": 7}, X, y, 2).to_packed()
    pk.predict(X)
    pk.predict_fused(X)
    assert not any(packed_kernel.launches.values())


# ---------------------------------------------------------------------------
# shape-bucketed dispatch
# ---------------------------------------------------------------------------


def test_next_bucket():
    assert next_bucket(1, 16) == 16
    assert next_bucket(16, 16) == 16
    assert next_bucket(17, 16) == 32
    assert next_bucket(1000, 16) == 1024
    assert next_bucket(1024, 16) == 1024
    # a non-pow2 floor is rounded up at construction
    assert BucketedDispatcher(lambda x: x, min_rows=24).min_rows == 32


def test_bucket_cache_zero_retrace_after_warmup(rng_m):
    """Mixed-batch-size load through the real packed traversal: after
    warmup, no new shape reaches the kernel entry (the watchdog counts none)
    and no new bucket appears."""
    X = _data(rng_m, n=300, nan_frac=0)
    y = (X[:, 0] > 0).astype(float)
    pk = _train({"objective": "binary", "num_leaves": 7}, X, y, 3).to_packed()
    disp = BucketedDispatcher(pk.leaves_dev, min_rows=16)
    F = pk.num_features
    warmed = disp.warmup(lambda n: (np.zeros((n, F), np.int32), np.zeros((n, F), bool)),
                         max_rows=256)
    assert warmed == [16, 32, 64, 128, 256]
    traces_after_warmup = retrace.counts()["ops.packed_predict_leaves"]
    assert disp.retraces == len(warmed)
    rng = np.random.RandomState(0)
    for n in rng.randint(1, 257, size=30):
        rows = rng.randn(n, F)
        codes, isnan = pk._host_codes(rows)
        out = disp(codes, isnan)
        assert out.shape == (pk.num_trees, n)
        want = tpredict.packed_predict_leaves(torch.from_numpy(codes), torch.from_numpy(isnan),
                                              pk.packed)  # the plain version notes no trace
        assert np.array_equal(out, want.numpy())
    assert retrace.counts()["ops.packed_predict_leaves"] == traces_after_warmup
    assert disp.retraces == len(warmed)
    stats = disp.stats()
    assert stats["calls"] == len(warmed) + 30
    assert set(stats["buckets"]) == set(warmed)


def test_bucket_cache_splits_oversized_requests():
    disp = BucketedDispatcher(lambda x: (x * 2.0).T, min_rows=8, max_rows=32)
    x = np.arange(80, dtype=np.float64)[:, None]
    out = disp(x)
    assert out.shape == (1, 80)
    assert np.array_equal(out, (x * 2).T)
    assert set(disp.stats()["buckets"]) == {32, 16}  # 32+32+16, no 128 bucket


def test_bucket_cache_pads_and_slices_rows_axis0():
    disp = BucketedDispatcher(lambda x: x + 0.0, min_rows=8, rows_axis=0)
    x = np.arange(5, dtype=np.float64)[:, None]
    out = disp(x)
    assert out.shape == (5, 1)
    assert np.array_equal(out, x)


# ---------------------------------------------------------------------------
# micro-batcher
# ---------------------------------------------------------------------------


def test_batcher_coalesces_requests():
    calls = []

    def dispatch(key, X):
        calls.append((key, X.shape[0]))
        return X[:, 0] * 10.0

    m = ServeMetrics()
    b = MicroBatcher(dispatch, max_batch_rows=1000, max_delay_ms=250.0, metrics=m)
    try:
        futs = [b.submit("k", np.full((n, 2), float(i))) for i, n in enumerate((3, 4, 5))]
        outs = [f.result(timeout=10) for f in futs]
        for i, (n, out) in enumerate(zip((3, 4, 5), outs)):
            assert out.shape == (n,)
            assert np.all(out == i * 10.0)
        # all three rode one dispatch (the delay window coalesced them)
        assert len(calls) == 1 and calls[0][1] == 12
        assert m.counters()["batches"] == 1
        assert m.counters()["batched_requests"] == 3
        assert m.batch_occupancy.snapshot()["count"] == 1
    finally:
        b.close()


def test_batcher_separates_keys():
    def dispatch(key, X):
        return X[:, 0] + (100.0 if key == "b" else 0.0)

    b = MicroBatcher(dispatch, max_batch_rows=1000, max_delay_ms=20.0)
    try:
        fa = b.submit("a", np.ones((2, 1)))
        fb = b.submit("b", np.ones((3, 1)))
        assert np.all(fa.result(timeout=10) == 1.0)
        assert np.all(fb.result(timeout=10) == 101.0)
    finally:
        b.close()


def test_batcher_survives_mismatched_width_coalesce():
    def dispatch(key, X):
        return X[:, 0]

    b = MicroBatcher(dispatch, max_batch_rows=1000, max_delay_ms=150.0)
    try:
        f1 = b.submit("k", np.ones((2, 3)))
        f2 = b.submit("k", np.ones((2, 5)))  # coalesces, concat must fail
        with pytest.raises(ValueError):
            f1.result(timeout=10)
        with pytest.raises(ValueError):
            f2.result(timeout=10)
        f3 = b.submit("k", np.full((2, 4), 7.0))  # worker still alive
        assert np.all(f3.result(timeout=10) == 7.0)
    finally:
        b.close()


def test_batcher_propagates_errors():
    def dispatch(key, X):
        raise RuntimeError("device on fire")

    b = MicroBatcher(dispatch, max_batch_rows=10, max_delay_ms=1.0)
    try:
        f = b.submit("k", np.ones((2, 1)))
        with pytest.raises(RuntimeError, match="device on fire"):
            f.result(timeout=10)
    finally:
        b.close()


def test_batcher_queue_depth_wired():
    m = ServeMetrics()
    gate = threading.Event()

    def dispatch(key, X):
        gate.wait(5)
        return X[:, 0]

    b = MicroBatcher(dispatch, max_batch_rows=1, max_delay_ms=1.0, metrics=m)
    try:
        futs = [b.submit("k", np.ones((1, 1))) for _ in range(4)]
        assert m.snapshot()["queue_depth"] >= 0  # gauge is live, not stale
        gate.set()
        for f in futs:
            f.result(timeout=10)
    finally:
        gate.set()
        b.close()


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def test_latency_window_percentiles():
    w = LatencyWindow(size=100)
    for ms in range(1, 101):
        w.record(ms / 1e3)
    s = w.snapshot()
    assert s["count"] == 100
    assert s["p50_ms"] == pytest.approx(51.0)
    assert s["p99_ms"] == pytest.approx(100.0)
    assert s["max_ms"] == pytest.approx(100.0)


def test_rate_meter():
    m = RateMeter(window_s=10.0)
    t0 = time.time()
    for i in range(20):
        m.record(now=t0 + i * 0.1)
    assert m.rate(now=t0 + 2.0) == pytest.approx(10.0, rel=0.2)


def test_plain_values_equal_jax_on_a_trained_model(rng_m):
    """The plain traversal of the JAX package's own packed model (carried by
    ``convert.packed_trees_from_numpy``) gives the JAX leaves."""
    X = _data(rng_m, cat_col=4)
    y = (np.nan_to_num(X[:, 1]) + 2.0 * (np.nan_to_num(X[:, 4]) % 3 == 2) > 0.5).astype(float)
    bst = _train({"objective": "binary", "num_leaves": 15}, X, y, 3, categorical_feature=[4])
    jpk = jlgb.Booster(model_str=bst.model_to_string()).to_packed()
    tp = convert.packed_trees_from_numpy({k: np.asarray(v) for k, v in jpk.packed._asdict().items()})
    codes, isnan = jpk._host_codes(np.asarray(X, np.float64))
    want = np.asarray(jpredict.packed_predict_leaves(jnp.asarray(codes), jnp.asarray(isnan),
                                                     jpk.packed))
    got = tpredict.packed_predict_leaves(torch.from_numpy(codes), torch.from_numpy(isnan), tp)
    assert np.array_equal(got.numpy(), want)


def test_node_table_packs_every_decision_field():
    """The traversal kernels' node table (two 16-byte words a node) holds
    each node's fields, and is rebuilt when a field changes in place."""
    p = convert.packed_trees_from_numpy(
        {k: np.asarray(v) for k, v in _hand_packed()._asdict().items()})
    tab = packed_kernel.node_table(p)
    assert tab.dtype == torch.int32 and tuple(tab.shape) == (3, 2, 8) and tab.is_contiguous()
    assert packed_kernel.node_table(p) is tab  # built once
    for k, name in enumerate(("feature", "thr_rank", "left_child", "right_child")):
        assert torch.equal(tab[..., k], getattr(p, name))
    assert torch.equal(tab[..., 4] & 3, p.missing_type)
    assert torch.equal((tab[..., 4] >> 2) & 1 == 1, p.default_left)
    assert torch.equal((tab[..., 4] >> 3) & 1 == 1, p.is_cat)
    assert torch.equal(tab[..., 5], p.cat_off) and torch.equal(tab[..., 6], p.cat_n)
    assert not tab[..., 7].any()
    p.thr_rank[1, 0] = 5
    assert packed_kernel.node_table(p)[1, 0, 1] == 5
