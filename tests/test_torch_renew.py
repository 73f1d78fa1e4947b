"""The port's leaf-renewing objectives ``regression_l1``, ``quantile`` and
``mape`` (lightgbm_tpu_torch/objective.py: ``segment_percentile``,
RenewTreeOutput in both split loops of models/gbdt.py)
on the CPU, against the JAX package.

 * ``percentile`` and ``weighted_percentile`` (host, numpy) equal the JAX
   package's; ``segment_percentile`` equals the JAX one on the same
   residuals, leaves, bag and weights: unweighted, the same order
   statistics and f32 ops, equal or within 4 f32 ulps where XLA contracts
   ``v1 - (v1 - v2) * bias`` into a fused multiply-add; within 1e-5 weighted (its cumulative
   weights are one f32 cumsum whose summation order differs: torch's CPU
   cumsum carries a double), with empty leaves, one-row leaves, ties and a
   bag that empties a leaf;
 * the device loop's rows' leaves (``leaf_ids`` over its state) are the
   tree's, and its renewal call equals the JAX package's device renewal;
 * the objectives' gradients, ``boost_from_score``, MAPE's label weights;
 * whole trainings with bagging against ``lightgbm_tpu.train``: L1, and
   quantile at alpha 0.75, have dyadic gradients, so their trees are equal
   (each package's split gains within the f32 bound of the exact gain; XLA
   contracts the gain's multiply-adds) and their renewed leaf values within
   4 f32 ulps; MAPE and weighted quantile (real-valued gradients and a
   weighted renewal) hold raw scores within rtol 1e-4 / atol 1e-5;
 * the device loop equals the host loop, and chunks of 4 equal chunk 1
   byte for byte; model text goes both ways;
 * a boosting mode with a renewing objective raises naming the pair.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu import objective as jobj
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.dataset import Metadata as JMetadata
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import objective as tobj
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.ops import grow as grow_mod
from lightgbm_tpu_torch.ops import grow_step_kernel
from lightgbm_tpu_torch.ops import hist_kernel
from lightgbm_tpu_torch.ops.split import SplitParams
from test_torch_boosting import _record_gradients
from test_torch_categorical import _exact_gains, _gains_apart


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N, F, ROUNDS = 2000, 6, 5
TRAIN = {"num_leaves": 15, "learning_rate": 0.25, "min_data_in_leaf": 10, "verbose": -1,
         "bagging_fraction": 0.8, "bagging_freq": 1}


def _data(seed=0, n=N):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    y = 3.0 * X[:, 0] + X[:, 1] ** 2 + rng.randn(n) + 5.0
    return X, y, rng.uniform(0.5, 2.0, n)


# ---- the percentile helpers --------------------------------------------------------


@pytest.mark.parametrize("alpha", [0.5, 0.9, 0.25])
def test_host_percentiles_match_jax(alpha):
    rng = np.random.RandomState(int(alpha * 100))
    for n in (0, 1, 2, 5, 17, 400):
        data = (rng.randn(n) * 3).astype(np.float32)
        data[::3] = 1.5  # ties
        w = rng.uniform(0.1, 2.0, n).astype(np.float32)
        assert tobj.percentile(data, alpha) == jobj.percentile(data, alpha)
        assert tobj.weighted_percentile(data, w, alpha) == jobj.weighted_percentile(data, w, alpha)


def _segment_case(seed, N_=3000, M=15):
    """Residuals with ties, leaves 0..M-3 with leaf 3 empty and leaf 12 of
    one row, a bag of 80% that leaves leaf 11 without a bagged row, MAPE-
    like weights and old outputs."""
    rng = np.random.RandomState(seed)
    v = (rng.randn(N_) * 3).astype(np.float32)
    v[::7] = 1.0
    v[1::11] = -0.0
    v[2::11] = 0.0
    lid = rng.randint(0, M - 2, N_).astype(np.int32)
    lid[lid == 3] = 4
    lid[0] = 12
    sel = rng.rand(N_) < 0.8
    sel[lid == 11] = False
    w = (1.0 / np.maximum(1.0, np.abs(rng.randn(N_) * 5 + 10))).astype(np.float32)
    old = rng.randn(M).astype(np.float32)
    return v, lid, sel, w, old


@pytest.mark.parametrize("bagged", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("alpha", [0.5, 0.9, 0.25])
def test_segment_percentile_matches_jax(alpha, weighted, bagged):
    for seed in range(3):
        v, lid, sel, w, old = _segment_case(seed)
        M = len(old)
        want = np.asarray(jobj.segment_percentile(
            jnp.asarray(v), jnp.asarray(lid), jnp.asarray(sel if bagged else np.ones_like(sel)),
            jnp.asarray(w) if weighted else None, jnp.asarray(old), num_leaves=M, alpha=alpha,
            weighted=weighted))
        got = tobj.segment_percentile(
            torch.from_numpy(v), torch.from_numpy(lid), torch.from_numpy(sel) if bagged else None,
            torch.from_numpy(w) if weighted else None, torch.from_numpy(old), M, alpha).numpy()
        assert got[3] == old[3] and (not bagged or got[11] == old[11])  # no (bagged) row: kept
        if weighted:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        else:
            assert _ulps(got, want).max() <= 4, (got, want)


def _grown_state(seed=0, n=3000, M=15):
    """A device-loop state after one tree on the CPU, and the rows' leaves."""
    X, y, _ = _data(seed, n)
    ds = tlgb.Dataset(X, label=y).construct()._binned
    bins = torch.from_numpy(np.ascontiguousarray(ds.bins, dtype=np.uint8))
    meta = ds.feature_meta_arrays()
    fm = {k: torch.as_tensor(meta[k].astype(np.int32)) for k in
          ("num_bin", "missing_type", "default_bin", "monotone")}
    g = torch.from_numpy(np.sign(5.0 - y).astype(np.float32))
    tree, leaf_id, state = grow_mod.grow_tree_device(
        bins, g, torch.ones(n), torch.ones(ds.num_features, dtype=torch.bool), fm,
        num_leaves=M, max_depth=-1, num_bins=int(ds.max_num_bin),
        params=SplitParams(0.0, 0.0, 0.0, 5, 1e-3, 0.0), two_way=False,
        bins_nf=bins.t().contiguous())
    return state, leaf_id, y


def test_loop_leaf_ids_are_the_rows_leaves():
    """The device loop's renewal reads each row's leaf from the ``leaf_ids``
    wrapper over its state (its plain version here): the tree's own leaves."""
    s, leaf_id, _ = _grown_state()
    assert torch.equal(grow_step_kernel.leaf_ids(s), leaf_id)
    assert len(torch.unique(leaf_id)) == s.M


@pytest.mark.parametrize("name", ["regression_l1", "quantile", "mape"])
@pytest.mark.parametrize("bagged", [False, True])
def test_device_loop_renewal_matches_jax(name, bagged):
    """The renewal as the device loop calls it (the rows' leaves from the
    loop's state, ``s.M`` leaves, the tree's values kept where a leaf has no
    bagged row) against the JAX package's ``renew_leaf_outputs_device`` on
    the same scores, leaves and bag: within 4 f32 ulps unweighted, 1e-5
    weighted (MAPE)."""
    s, leaf_id, y = _grown_state(1)
    n = len(y)
    params = {"objective": name, "alpha": 0.75, "verbose": -1}
    obj = tobj.create_objective(TConfig.from_params(dict(params)))
    obj.init(TMetadata(n, label=y), n, torch.device("cpu"))
    j = jobj.create_objective(JConfig.from_params(dict(params)))
    j.init(JMetadata(n, label=y), n)
    score = (np.random.RandomState(2).randn(n) + 5.0).astype(np.float32)
    bag = (np.random.RandomState(3).rand(n) < 0.7).astype(np.float32) if bagged else None
    old = s.leaf_f[:, 0].clone()
    got = obj.renew_leaf_outputs(torch.from_numpy(score), grow_step_kernel.leaf_ids(s),
                                 None if bag is None else torch.from_numpy(bag), s.M, old).numpy()
    want = np.asarray(j.renew_leaf_outputs_device(
        jnp.asarray(score), jnp.asarray(leaf_id.numpy().astype(np.int32)),
        None if bag is None else jnp.asarray(bag), s.M, jnp.asarray(old.numpy())))
    assert not np.array_equal(got, old.numpy())
    if name == "mape":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert _ulps(got, want).max() <= 4, (got, want)


# ---- the objectives ------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", ["regression_l1", "quantile", "mape"])
def test_gradients_and_init_scores_match_jax(name, weighted):
    X, y, w = _data(4)
    w = w if weighted else None
    params = {"objective": name, "alpha": 0.75, "verbose": -1}
    j = jobj.create_objective(JConfig.from_params(dict(params)))
    j.init(JMetadata(N, label=y, weight=w), N)
    t = tobj.create_objective(TConfig.from_params(dict(params)))
    t.init(TMetadata(N, label=y, weight=w), N, torch.device("cpu"))
    assert t.is_renew_tree_output and j.is_renew_tree_output
    score = (np.random.RandomState(5).randn(N) + 5.0).astype(np.float32)
    score[:50] = np.float32(y[:50])  # a zero residual: sign 0, quantile's delta >= 0
    jg, jh = j.get_gradients(jnp.asarray(score))
    tg, th = t.get_gradients(torch.from_numpy(score))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert t.boost_from_score() == j.boost_from_score()
    if name == "mape":
        np.testing.assert_array_equal(t.label_weight, j.label_weight)
    assert t.to_string() == j.to_string() == name


def _train(pkg, params, X, y, w=None, rounds=ROUNDS, **kw):
    return pkg.train(dict(params), pkg.Dataset(X, label=y, weight=w), rounds, **kw)


def _leaves_apart(text):
    """Model text without its leaf_value lines, and the leaf values (f32)."""
    keep, leaves = [], []
    for line in text.splitlines():
        if line.startswith("leaf_value="):
            leaves.extend(float(v) for v in line.split("=", 1)[1].split())
        else:
            keep.append(line)
    return "\n".join(keep), np.asarray(leaves, np.float32)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("loop", ["host", "device"])
@pytest.mark.parametrize("name", ["regression_l1", "quantile"])
def test_dyadic_training_equals_jax(monkeypatch, name, loop):
    """L1's gradients are -1, 0 or 1 and quantile's at alpha 0.75 are 0.25 or
    -0.75: every histogram sum is exact, so both packages grow the same
    trees; the renewal picks the same order statistics."""
    params = dict(TRAIN, objective=name, alpha=0.75)
    X, y, _ = _data(6)
    jb = _train(jlgb, params, X, y)
    grads = _record_gradients(monkeypatch)
    if loop == "device":
        monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")
    tb = _train(tlgb, params, X, y, device="cpu")
    assert tb._gbdt.grow_loop == loop and tb.num_trees() == jb.num_trees() == ROUNDS
    (jbody, jgains), (tbody, tgains) = _gains_apart(jb.model_to_string()), \
        _gains_apart(tb.model_to_string())
    (jbody, jleaves), (tbody, tleaves) = _leaves_apart(jbody), _leaves_apart(tbody)
    assert tbody == jbody
    assert _ulps(tleaves, jleaves).max() <= 4, (tleaves, jleaves)
    bound = np.concatenate([b_ for _, b_ in _exact_gains(tb, params, grads)])
    assert (np.abs(tgains - jgains) <= 2 * bound + 1e-7 * np.abs(jgains)).all()
    np.testing.assert_allclose(tb._gbdt.train_score(), jb._gbdt._train_score_np(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("loop", ["host", "device"])
@pytest.mark.parametrize("case", ["mape", "mape_weighted", "quantile_weighted", "l1_weighted"])
def test_weighted_training_equals_jax(monkeypatch, case, loop):
    """Real-valued gradients or a weighted renewal: raw scores within rtol
    1e-4 / atol 1e-5, and a validation set's metric close."""
    name = {"mape": "mape", "mape_weighted": "mape", "quantile_weighted": "quantile",
            "l1_weighted": "regression_l1"}[case]
    params = dict(TRAIN, objective=name, alpha=0.6)
    X, y, w = _data(7)
    w = w if case.endswith("weighted") else None
    Xv, yv, _ = _data(8, 500)
    res = {}
    jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y, weight=w), ROUNDS, evals_result=res,
                    valid_sets=[jlgb.Dataset(Xv, label=yv)], verbose_eval=False)
    if loop == "device":
        monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")
    tres = {}
    tb = tlgb.train(dict(params), tlgb.Dataset(X, label=y, weight=w), ROUNDS, evals_result=tres,
                    valid_sets=[tlgb.Dataset(Xv, label=yv)], verbose_eval=False, device="cpu")
    assert tb._gbdt.grow_loop == loop and tb.num_trees() == jb.num_trees()
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tb.predict(Xv), jb.predict(Xv), rtol=1e-4, atol=1e-5)
    metric = {"mape": "mape", "quantile": "quantile", "regression_l1": "l1"}[name]
    np.testing.assert_allclose(tres["valid_0"][metric], res["valid_0"][metric], rtol=1e-4)


@pytest.mark.parametrize("name", ["regression_l1", "quantile", "mape"])
def test_device_loop_chunks_and_host_loop_agree(monkeypatch, name):
    params = dict(TRAIN, objective=name, alpha=0.75)
    X, y, _ = _data(9)
    host = _train(tlgb, params, X, y, rounds=9, device="cpu")
    monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")
    one = _train(tlgb, params, X, y, rounds=9, device="cpu")
    four = _train(tlgb, dict(params, device_chunk_size=4), X, y, rounds=9, device="cpu")
    assert host._gbdt.grow_loop == "host" and one._gbdt.grow_loop == "device"
    assert four._gbdt.device_chunk_fallback_reason() is None
    text = one.model_to_string().split("parameters:")[0]
    assert four.model_to_string().split("parameters:")[0] == text
    assert four._gbdt.train_score().tobytes() == one._gbdt.train_score().tobytes()
    assert host.model_to_string().split("parameters:")[0] == text
    assert host._gbdt.train_score().tobytes() == one._gbdt.train_score().tobytes()


@pytest.mark.parametrize("name", ["regression_l1", "quantile", "mape"])
def test_model_text_both_ways(name):
    params = dict(TRAIN, objective=name, alpha=0.75)
    X, y, _ = _data(10)
    jb, tb = _train(jlgb, params, X, y), _train(tlgb, params, X, y, device="cpu")
    t_from_j = tlgb.Booster(model_str=jb.model_to_string(), device="cpu")
    j_from_t = jlgb.Booster(model_str=tb.model_to_string())
    assert t_from_j._gbdt.objective.name == name
    np.testing.assert_array_equal(t_from_j.predict(X, raw_score=True), jb.predict(X, raw_score=True))
    np.testing.assert_array_equal(j_from_t.predict(X, raw_score=True), tb.predict(X, raw_score=True))
    np.testing.assert_array_equal(t_from_j.predict(X), jb.predict(X))


@pytest.mark.parametrize("boosting", ["goss", "dart", "rf"])
def test_boosting_modes_refuse_renewal_by_name(boosting):
    """The name is historical: each mode trains with a renewing objective
    now (tests/test_torch_mode_objectives.py holds the pairs to the JAX
    package)."""
    X, y, _ = _data(11, 200)
    params = {"objective": "quantile", "boosting": boosting, "verbose": -1}
    if boosting == "rf":
        params.update(bagging_fraction=0.8, bagging_freq=1)
    bst = tlgb.train(params, tlgb.Dataset(X, label=y), 2, device="cpu")
    assert bst.num_trees() == 2 and bst._gbdt._renew
    assert np.isfinite(bst.predict(X)).all()
