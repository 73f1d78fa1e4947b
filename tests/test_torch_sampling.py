"""Row bagging and feature_fraction in the port (models/gbdt.py ``draw_bag``,
``_prepare_bag``, ``_sample_feature_masks``; the ``bag`` of ops/grow.py's two
split loops), on the CPU, against the JAX package.

 * feature_fraction masks equal the JAX package's, drawn one an iteration
   and a chunk's at once, from the same generator in the same order;
 * the bag has exactly ``int(bagging_fraction * N)`` ones, is redrawn on the
   ``bagging_freq`` schedule, is a function of (seed, iteration) alone, and
   equals the JAX package's draw (threefry's permutation) bit for bit;
 * with the same bag, both split loops grow the JAX ``grow_tree``'s tree bit
   for bit on dyadic gradients (multiples of 1/64: every sum exact), also
   where the physically larger child is the bagged smaller one (both loops
   build the bagged smaller child's histogram);
 * a whole training equals the JAX package's under tests/test_torch_train.py's
   rule, with the JAX bag draw as it is and with it
   (``lightgbm_tpu.models.gbdt._device_bag_mask``, monkeypatched there only)
   returning the port's bag;
 * chunks of 4 equal chunk 1 bit for bit with bagging, feature_fraction, a
   validation set and a mid-chunk no-split stop (the port's twin of
   tests/test_device_chunk.py's stop-with-bagging and stop-with-valid cases).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu.models.gbdt as jgbdt
import lightgbm_tpu_torch as tlgb
from helpers.bench_data import make_higgs_like
from lightgbm_tpu.ops.grow import grow_tree as jax_grow_tree
from lightgbm_tpu.ops.split import SplitParams as JaxSplitParams
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.models.gbdt import draw_bag
from lightgbm_tpu_torch.ops import grow_state as gs
from lightgbm_tpu_torch.ops import hist_kernel
from lightgbm_tpu_torch.ops.grow import TreeArrays, grow_tree, grow_tree_device, run_step, start_tree
from lightgbm_tpu_torch.ops.split import SplitParams


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: faster alone,
    and the test workers do not oversubscribe the cores. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SAMPLED = {"objective": "binary", "metric": "auc", "num_leaves": 15, "learning_rate": 0.1,
           "max_bin": 255, "verbose": -1, "bagging_fraction": 0.8, "bagging_freq": 2,
           "feature_fraction": 0.8}
ROUNDS = 8


@pytest.fixture(scope="module")
def higgs():
    return make_higgs_like(3000, 28, seed=3)


# ---- feature_fraction masks --------------------------------------------------


def test_feature_masks_equal_jax(higgs):
    X, y = higgs
    params = dict(SAMPLED, feature_fraction=0.6, feature_fraction_seed=11)
    jg = jlgb.Booster(dict(params), jlgb.Dataset(X, label=y))._gbdt
    tg = tlgb.Booster(dict(params), tlgb.Dataset(X, label=y), device="cpu")._gbdt
    assert tg.train_set.num_features == jg.train_set.num_features == 28
    for _ in range(3):  # one an iteration
        want = np.asarray(jg._sample_features())
        got = tg._sample_feature_masks(1)
        np.testing.assert_array_equal(got, want[None])
        assert got.sum() == int(0.6 * 28)
    for n in (4, 1, 5):  # a chunk's at once, [n, K, F] in the JAX package
        np.testing.assert_array_equal(tg._sample_feature_masks(n),
                                      np.asarray(jg._sample_feature_masks(n))[:, 0])


def test_no_feature_fraction_draws_nothing(higgs):
    X, y = higgs
    g = tlgb.Booster(dict(SAMPLED, feature_fraction=1.0), tlgb.Dataset(X, label=y), device="cpu")._gbdt
    assert g._sample_feature_masks(3) is None
    assert g._feature_masks is None


# ---- the bag -----------------------------------------------------------------


@pytest.mark.parametrize("n,fraction", [(1, 0.5), (7, 0.6), (3000, 0.8), (100_003, 0.37)])
def test_bag_has_exactly_bag_cnt_rows(n, fraction):
    cnt = int(fraction * n)
    bag = draw_bag(3, 5, n, cnt, "cpu")
    assert bag.dtype == torch.float32 and bag.shape == (n,)
    assert int((bag == 1).sum()) == cnt and int((bag == 0).sum()) == n - cnt


def test_bag_is_a_function_of_seed_and_iteration():
    n, cnt = 5000, 4000
    a = draw_bag(3, 7, n, cnt, "cpu")
    assert torch.equal(a, draw_bag(3, 7, n, cnt, "cpu"))
    out = torch.full((n,), 9.0)
    assert draw_bag(3, 7, n, cnt, "cpu", out=out) is out and torch.equal(out, a)
    others = [draw_bag(3, 8, n, cnt, "cpu"), draw_bag(4, 7, n, cnt, "cpu"),
              draw_bag(3, 7 + 2 ** 32, n, cnt, "cpu")]
    assert not torch.equal(others[0], a) and not torch.equal(others[1], a)
    # only the low 32 bits of the iteration and seed enter the hash
    assert torch.equal(others[2], a)
    # the rows out of the bag spread over the whole range
    out_rows = torch.nonzero(a == 0)[:, 0].float()
    assert 0.4 * n < float(out_rows.mean()) < 0.6 * n


def _jax_bag(seed, iteration, n, cnt):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), iteration)
    return np.asarray(jgbdt._device_bag_mask(key, n, cnt))


@pytest.mark.parametrize("n", [1, 2, 1000, 1625, 1626, 100_000])
@pytest.mark.parametrize("iteration", [0, 1, 7, 1000])
@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 31 - 1])
def test_bag_equals_jax_draw(seed, iteration, n):
    """Bit for bit the JAX package's ``_device_bag_mask(fold_in(PRNGKey(seed),
    iteration), n, cnt)``: 0 shuffle rounds at n = 1, 1 up to n = 1625, 2
    from n = 1626."""
    cnt = max(1, int(0.8 * n))
    np.testing.assert_array_equal(draw_bag(seed, iteration, n, cnt, "cpu").numpy(),
                                  _jax_bag(seed, iteration, n, cnt))


def test_bag_equals_jax_draw_at_1m():
    n, cnt = 1_000_000, 800_000
    np.testing.assert_array_equal(draw_bag(7, 3, n, cnt, "cpu").numpy(), _jax_bag(7, 3, n, cnt))


@pytest.mark.parametrize("freq", [1, 3])
def test_bag_follows_bagging_freq(higgs, freq):
    X, y = higgs
    g = tlgb.Booster(dict(SAMPLED, bagging_freq=freq, bagging_seed=5),
                     tlgb.Dataset(X, label=y), device="cpu")._gbdt
    cnt = int(0.8 * g.num_data)
    seen = []
    for it in range(7):
        g._prepare_bag(it)
        want = draw_bag(5, it - it % freq, g.num_data, cnt, "cpu")
        assert torch.equal(g._bag, want), it
        seen.append(g._bag.clone())
    for it in range(1, 7):
        assert torch.equal(seen[it], seen[it - 1]) == (it % freq != 0), it
    g._prepare_bag(2)  # back to an earlier iteration: the same draw
    assert torch.equal(g._bag, seen[2])


# ---- the split loops with a bag, against the JAX grow_tree ---------------------


def _dyadic_case(seed, N=2001, F=6, B=63):
    rng = np.random.RandomState(seed)
    num_bin = rng.randint(3, B + 1, F).astype(np.int32)
    num_bin[0] = B
    bins = np.stack([rng.randint(0, nb, N) for nb in num_bin]).astype(np.uint8)
    meta = {"num_bin": num_bin, "missing_type": (np.arange(F) % 3).astype(np.int32),
            "default_bin": rng.randint(0, 3, F).astype(np.int32), "monotone": np.zeros(F, np.int8)}
    grad = (rng.randint(-64, 65, N) / 64.0).astype(np.float32)
    hess = (rng.randint(1, 65, N) / 64.0).astype(np.float32)
    return bins, meta, grad, hess


PARAMS = (0.0, 1.0, 0.0, 5, 1e-3, 0.0)


def _grow_all(bins, meta, grad, hess, bag, M, fmask=None):
    """The JAX grow_tree's, the host loop's and the device loop's tree."""
    F = bins.shape[0]
    B = int(meta["num_bin"].max())
    fmask = np.ones(F, bool) if fmask is None else fmask
    want, want_leaf = jax_grow_tree(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess), jnp.asarray(bag),
        jnp.asarray(fmask), {k: jnp.asarray(v) for k, v in meta.items()},
        num_leaves=M, max_depth=-1, num_bins=B, params=JaxSplitParams(*PARAMS), two_way=True,
    )
    ds = convert.binned_from_numpy(bins, meta)
    args = (torch.from_numpy(ds.bins), torch.from_numpy(grad), torch.from_numpy(hess),
            torch.from_numpy(fmask), convert.meta_tensors(ds.feature_meta_arrays()), M, -1, B,
            SplitParams(*PARAMS), True)
    nf = torch.from_numpy(np.ascontiguousarray(bins.T))
    host = grow_tree(*args, bins_nf=nf, bag=torch.from_numpy(bag))
    dev_tree, dev_leaf, _ = grow_tree_device(*args, bins_nf=nf, bag=torch.from_numpy(bag))
    want = {k: np.asarray(v) for k, v in want._asdict().items()}
    return want, np.asarray(want_leaf), [host, (dev_tree, dev_leaf)]


def _exact_gains(want, want_leaf, grad, hess, bag):
    """Each node's gain in f64 from the bagged dyadic sums (exact) of the
    rows under its two children: G_l^2 / (H_l + l2) + G_r^2 / (H_r + l2)
    - G^2 / (H + l2), PARAMS' lambda_l2 and no l1."""
    lc, rc = want["left_child"], want["right_child"]
    g, h = grad.astype(np.float64) * bag, hess.astype(np.float64) * bag
    l2 = PARAMS[1]

    def rows(child):
        leaves, stack = [], [child]
        while stack:
            c = stack.pop()
            if c < 0:
                leaves.append(-c - 1)
            else:
                stack.extend((lc[c], rc[c]))
        return np.isin(want_leaf, leaves)

    def leaf_gain(m):
        return g[m].sum() ** 2 / (h[m].sum() + l2)

    out = []
    for k in range(int(want["num_leaves"]) - 1):
        left, right = rows(lc[k]), rows(rc[k])
        out.append(leaf_gain(left) + leaf_gain(right) - leaf_gain(left | right))
    return np.asarray(out)


def _assert_equal(got, got_leaf, want, want_leaf, exact_gain):
    """Every field bit for bit but the gain, which f32 rounding moves with
    the summation and XLA's fused multiply-adds (tests/test_torch_split.py):
    the port's and the JAX package's each within rtol 1e-6 of the exact f64
    gain of the same splits."""
    for name in TreeArrays._fields:
        a, b = want[name], getattr(got, name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name == "split_gain":
            n = len(exact_gain)
            for gain in (b, a):
                np.testing.assert_allclose(gain[:n], exact_gain, rtol=1e-6, atol=0)
            np.testing.assert_array_equal(b[n:], a[n:])
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
    np.testing.assert_array_equal(got_leaf.numpy(), want_leaf)


@pytest.mark.parametrize("seed", [0, 1])
def test_bagged_loops_equal_jax_grow_tree(seed):
    bins, meta, grad, hess = _dyadic_case(seed)
    bag = draw_bag(seed, 3, len(grad), int(0.7 * len(grad)), "cpu").numpy()
    fmask = np.ones(bins.shape[0], bool)
    fmask[seed + 1] = False  # and a feature_fraction mask with a zero
    want, want_leaf, runs = _grow_all(bins, meta, grad, hess, bag, 15, fmask)
    exact = _exact_gains(want, want_leaf, grad, hess, bag)
    for got, got_leaf in runs:
        _assert_equal(got, got_leaf, want, want_leaf, exact)
    assert int(want["num_leaves"]) == 15
    assert not np.any(want["split_feature"][:14] == seed + 1)
    # the counts are the bag's: the root's children hold the bagged rows
    root_children = want["leaf_count"][want["leaf_parent"] == 0].sum()
    assert want["internal_count"][0] == bag.sum() and root_children <= bag.sum()


def test_bagged_smaller_child_is_built_from_its_rows(monkeypatch):
    """A root split whose physically larger child is the bagged smaller one:
    the host loop builds that child's histogram from its segment, and the
    device loop names it SMALL; both trees equal the JAX package's."""
    N, F = 4000, 3
    rng = np.random.RandomState(2)
    bins = rng.randint(0, 8, (F, N)).astype(np.uint8)
    x = rng.randint(0, 8, N)
    bins[0] = x
    left = x <= 4  # 5/8 of the rows go left
    grad = np.where(left, -1.0, 1.0).astype(np.float32) + (rng.randint(-8, 9, N) / 64.0).astype(np.float32)
    hess = np.ones(N, np.float32)
    bag = np.where(left, rng.rand(N) < 0.3, True).astype(np.float32)
    meta = {"num_bin": np.full(F, 8, np.int32), "missing_type": np.zeros(F, np.int32),
            "default_bin": np.zeros(F, np.int32), "monotone": np.zeros(F, np.int8)}
    assert left.sum() > (~left).sum() and bag[left].sum() < bag[~left].sum()

    seg_rows = []
    routed = hist_kernel.routed_histogram

    def record(bins_, values, num_bins, rows=None, **kw):
        if rows is not None:
            seg_rows.append(int(rows.numel()))
        return routed(bins_, values, num_bins, rows=rows, **kw)

    monkeypatch.setattr(hist_kernel, "routed_histogram", record)
    want, want_leaf, runs = _grow_all(bins, meta, grad, hess, bag, 4)
    exact = _exact_gains(want, want_leaf, grad, hess, bag)
    for got, got_leaf in runs:
        _assert_equal(got, got_leaf, want, want_leaf, exact)
    assert want["split_feature"][0] == 0 and want["threshold_bin"][0] == 4
    assert seg_rows[0] == int(left.sum())  # the host loop's first segment: the left child

    ds = convert.binned_from_numpy(bins, meta)
    s = gs.GrowState(torch.device("cpu"), N, F, 8, 4)
    start_tree(s, torch.from_numpy(ds.bins), torch.from_numpy(grad), torch.from_numpy(hess),
               torch.ones(F, dtype=torch.bool), convert.meta_tensors(ds.feature_meta_arrays()), -1,
               SplitParams(*PARAMS), True, torch.from_numpy(np.ascontiguousarray(bins.T)),
               bag=torch.from_numpy(bag))
    run_step(s)
    small, large = int(s.ctl[gs.SMALL]), int(s.ctl[gs.LARGE])
    assert small == 0 and large == 1  # the left child (leaf 0) is the bagged smaller
    assert int(s.leaf_count[small]) > int(s.leaf_count[large])  # and the physically larger


# ---- whole trainings ----------------------------------------------------------


@pytest.fixture(scope="module")
def against_jax(higgs):
    """The JAX package's training with its bag draw replaced by the port's."""
    X, y = higgs
    seed = jlgb.Config.from_params(dict(SAMPLED)).bagging_seed & 0x7FFFFFFF
    base = jax.random.PRNGKey(seed)
    by_key = {np.asarray(jax.random.fold_in(base, it)).tobytes(): it for it in range(ROUNDS)}

    def port_bag(key, n, bag_cnt):
        it = by_key[np.asarray(key).tobytes()]
        return jnp.asarray(draw_bag(seed, it, n, bag_cnt, "cpu").numpy())

    mp = pytest.MonkeyPatch()
    mp.setattr(jgbdt, "_device_bag_mask", port_bag)
    try:
        jb = jlgb.train(dict(SAMPLED), jlgb.Dataset(X, label=y), ROUNDS)
    finally:
        mp.undo()
    return X, y, jb


@pytest.mark.parametrize("loop", ["host", "device"])
def test_training_with_bag_and_feature_fraction_agrees_with_jax(against_jax, monkeypatch, loop):
    """tests/test_torch_train.py's rule: the same trees unless a split is an
    f32 near-tie, leaf values and raw scores within rtol 1e-4 / atol 1e-5."""
    X, y, jb = against_jax
    if loop == "device":
        monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")
    tb = tlgb.train(dict(SAMPLED), tlgb.Dataset(X, label=y), ROUNDS, device="cpu")
    assert tb._gbdt.grow_loop == loop
    jt, tt = jb._gbdt.trees(), tb._gbdt.trees()
    assert len(jt) == len(tt) == ROUNDS
    for a, b in zip(jt, tt):
        same = (a.num_leaves == b.num_leaves and np.array_equal(a.split_feature, b.split_feature)
                and np.array_equal(a.threshold_bin, b.threshold_bin)
                and np.array_equal(a.left_child, b.left_child))
        if not same:
            k = int(np.argmax(a.split_feature != b.split_feature))
            np.testing.assert_allclose(b.split_gain[k], a.split_gain[k], rtol=1e-5)
            return
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(b.internal_count, a.internal_count)
    np.testing.assert_allclose(tb.predict(X, raw_score=True), jb.predict(X, raw_score=True),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("loop", ["host", "device"])
def test_bagged_training_equals_jax_without_patch(higgs, monkeypatch, loop):
    """The JAX package's own bag draw, untouched: the same bags, so the same
    trees under tests/test_torch_train.py's rule."""
    X, y = higgs
    params = dict(SAMPLED, feature_fraction=1.0)
    jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y), ROUNDS)
    if loop == "device":
        monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")
    tb = tlgb.train(dict(params), tlgb.Dataset(X, label=y), ROUNDS, device="cpu")
    assert tb._gbdt.grow_loop == loop
    seed = tb._gbdt.config.bagging_seed
    assert torch.equal(tb._gbdt._bag, draw_bag(seed, tb._gbdt._bag_iter, len(y),
                                               int(0.8 * len(y)), "cpu"))
    np.testing.assert_array_equal(tb._gbdt._bag.numpy(), np.asarray(jb._gbdt._bag_mask))
    jt, tt = jb._gbdt.trees(), tb._gbdt.trees()
    assert len(jt) == len(tt) == ROUNDS
    for i, (a, b) in enumerate(zip(jt, tt)):
        assert a.num_leaves == b.num_leaves, ("a different tree", i)
        np.testing.assert_array_equal(b.split_feature, a.split_feature)
        np.testing.assert_array_equal(b.threshold_bin, a.threshold_bin)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(b.internal_count, a.internal_count)
    np.testing.assert_allclose(tb.predict(X, raw_score=True), jb.predict(X, raw_score=True),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("params", [
    {"bagging_fraction": 0.5, "bagging_freq": 1},
    {"feature_fraction": 0.5},
])
def test_sampling_params_train(higgs, params):
    """bagging and feature_fraction train (they were refused before the
    port had them): a sampled model differs from the unsampled one and still
    learns."""
    X, y = higgs
    base = {"objective": "binary", "metric": "auc", "num_leaves": 15, "verbose": -1}
    plain = tlgb.train(dict(base), tlgb.Dataset(X, label=y), 5, device="cpu")
    sampled = tlgb.train(dict(base, **params), tlgb.Dataset(X, label=y), 5, device="cpu")
    assert sampled.num_trees() == 5
    assert not np.array_equal(sampled.predict(X), plain.predict(X))
    (_, _, auc, _), = sampled.eval_train()
    assert auc > 0.7


# ---- chunks --------------------------------------------------------------------

CHUNK_ROWS, CHUNK_FEAT = 500, 5
CHUNKED = {"objective": "binary", "num_leaves": 6, "min_data_in_leaf": 5, "verbosity": -1,
           "bagging_fraction": 0.6, "bagging_freq": 1, "feature_fraction": 0.6}


def _chunk_data(seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(CHUNK_ROWS, CHUNK_FEAT)
    return X, (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)


def _chunk_run(params, chunk, rounds, seed):
    X, y = _chunk_data(seed)
    Xv, yv = _chunk_data(seed + 100)
    ds = tlgb.Dataset(X, label=y)
    return tlgb.train(dict(params, device_chunk_size=chunk), ds, rounds,
                      valid_sets=[tlgb.Dataset(Xv, label=yv, reference=ds)], verbose_eval=False,
                      device="cpu")


@pytest.mark.parametrize("min_gain,rounds", [(0.0, 9), (18.0, 24)])
def test_chunk_4_equals_chunk_1_with_sampling_and_valid(monkeypatch, min_gain, rounds):
    """Model text, train scores and validation scores byte-equal; at
    min_gain_to_split 18 training stops in the middle of a chunk."""
    monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")
    params = dict(CHUNKED, min_gain_to_split=min_gain)
    ref = _chunk_run(params, 1, rounds, 10)
    got = _chunk_run(params, 4, rounds, 10)
    assert got._gbdt.grow_loop == "device" and got._gbdt.device_chunk_fallback_reason() is None
    if min_gain:
        assert 1 < ref.num_trees() < rounds, "the configuration no longer stops mid-training"
        assert ref.num_trees() % 4 != 0, "the stop is not inside a chunk"
    else:
        assert ref.num_trees() == rounds
    assert got.num_trees() == ref.num_trees()
    assert got.model_to_string().split("parameters:")[0] == ref.model_to_string().split("parameters:")[0]
    assert got._gbdt.train_score().tobytes() == ref._gbdt.train_score().tobytes()
    assert got._gbdt._valid_score_np(0).tobytes() == ref._gbdt._valid_score_np(0).tobytes()


@pytest.mark.parametrize("loop", ["host", "device"])
def test_sampling_turned_off_mid_training(higgs, monkeypatch, loop):
    """reset_parameter turning bagging and feature_fraction off: the next
    iterations train on every row and feature, as a fresh booster's
    iteration on the same scores would."""
    X, y = higgs
    if loop == "device":
        monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")
    b = tlgb.Booster(dict(SAMPLED), tlgb.Dataset(X, label=y), device="cpu")
    for _ in range(3):
        b.update()
    assert not bool(b._gbdt.feature_mask.all()) and b._gbdt._bag is not None
    b.reset_parameter({"bagging_fraction": 1.0, "feature_fraction": 1.0})
    key = b._gbdt._iteration_key()
    b.update()
    g = b._gbdt
    assert bool(g.feature_mask.all()) and g._bag is None and g._feature_masks is None
    assert g._iteration_key() == key
    assert int(g._tree_arrays[-1].internal_count[0]) == len(y)
