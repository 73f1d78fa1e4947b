"""Five binary boosting iterations on a small ``make_higgs_like`` through
the port (device="cpu", the plain versions) and through the JAX package.

 * Bin matrices and bin bounds are identical (same host binning code).
 * Dense Gaussian data makes no EFB groups on the JAX side.
 * Trees are identical in structure unless a split is an f32 near-tie;
   leaf values and raw scores agree to rtol 1e-4 / atol 1e-5 — gradients
   differ by an ulp between XLA's and PyTorch's ``exp``, and the root sums
   are added in different orders, so exact equality is not expected on real
   data.
 * Model text written by either package loads in the other and predicts
   the same raw scores bit for bit (same trees, f64 sums in the same order).

The narrow widths of measured routing (max_bin 15 and 63) are held to the
JAX package the same way, and on the port alone: every histogram impl
forced through LIGHTGBM_TPU_HIST_IMPL, and a hand-built route sending
alternating row classes to the kernels, grow the default route's trees bit
for bit (on the CPU each kernel's wrapper runs the same plain f32 sums), and
``cuda_packed4`` reads the packed copy made at set-up, never calling
``pack4``;
bf16 operands with ``cuda_onehot`` forced train to an AUC within 0.01 of
f32's.

The JAX trainings are shared by the module through fixtures: their compiles
dominate the file's time.
"""
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from helpers.bench_data import make_higgs_like
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.obs import tune as ttune
from lightgbm_tpu_torch.ops import hist_kernel as hk

PARAMS = {
    "objective": "binary", "metric": "auc", "num_leaves": 15,
    "learning_rate": 0.1, "max_bin": 255, "verbose": -1,
}
ROUNDS = 5


@pytest.fixture(scope="module")
def trained():
    X, y = make_higgs_like(3000, 28, seed=3)
    jb = jlgb.train(dict(PARAMS), jlgb.Dataset(X, label=y), num_boost_round=ROUNDS)
    tb = tlgb.train(dict(PARAMS), tlgb.Dataset(X, label=y), ROUNDS, device="cpu")
    return X, y, jb, tb


def test_binning_identical_and_unbundled(trained):
    _, _, jb, tb = trained
    jd, td = jb._gbdt.train_set, tb._gbdt.train_set
    assert not jd.is_bundled
    assert "group_id" not in jd.feature_meta_arrays()
    np.testing.assert_array_equal(td.bins, jd.bins)
    assert td.used_feature_idx == jd.used_feature_idx
    for tm, jm in zip(td.mappers, jd.mappers):
        assert tm.to_dict() == jm.to_dict()


def test_trees_and_scores_agree(trained):
    X, _, jb, tb = trained
    _assert_agree(X, jb, tb)


def _assert_agree(X, jb, tb):
    jt, tt = jb._gbdt.trees(), tb._gbdt.trees()
    assert len(jt) == len(tt) == ROUNDS
    for i, (a, b) in enumerate(zip(jt, tt)):
        same = (
            a.num_leaves == b.num_leaves
            and np.array_equal(a.split_feature, b.split_feature)
            and np.array_equal(a.threshold_bin, b.threshold_bin)
            and np.array_equal(a.left_child, b.left_child)
        )
        if not same:
            # a legitimate divergence is a near-tie: the first differing
            # node's gains agree to f32 rounding, and later trees may differ
            k = int(np.argmax(a.split_feature != b.split_feature))
            np.testing.assert_allclose(b.split_gain[k], a.split_gain[k], rtol=1e-5)
            return
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(b.split_gain, a.split_gain, rtol=1e-4)
    np.testing.assert_allclose(
        tb.predict(X, raw_score=True), jb.predict(X, raw_score=True), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        tb._gbdt.train_score(), np.asarray(jb._gbdt.scores)[0], rtol=1e-4, atol=1e-5
    )
    (_, name, auc, _), = tb.eval_train()
    assert name == "auc" and auc > 0.6


def test_model_text_loads_both_ways(trained):
    X, _, jb, tb = trained
    port_text = tb.model_to_string()
    in_jax = jlgb.Booster(model_str=port_text)
    np.testing.assert_array_equal(
        in_jax.predict(X, raw_score=True), tb.predict(X, raw_score=True)
    )
    jax_text = jb.model_to_string()
    in_port = convert.booster_from_model_string(jax_text, device="cpu")
    np.testing.assert_array_equal(
        in_port.predict(X, raw_score=True), jb.predict(X, raw_score=True)
    )
    np.testing.assert_array_equal(in_port.predict(X[:50]), jb.predict(X[:50]))
    # a loaded model writes its trees back unchanged
    assert in_port.model_to_string().split("end of trees")[0] == jax_text.split("end of trees")[0]


NARROW = (15, 63)


@pytest.fixture(scope="module")
def narrow():
    X, y = make_higgs_like(2000, 28, seed=5)
    runs = {}
    for mb in NARROW:
        p = dict(PARAMS, max_bin=mb)
        jb = jlgb.train(dict(p), jlgb.Dataset(X, label=y), num_boost_round=ROUNDS)
        tb = tlgb.train(dict(p), tlgb.Dataset(X, label=y), ROUNDS, device="cpu")
        runs[mb] = (jb, tb)
    return X, y, runs


@pytest.mark.parametrize("max_bin", NARROW)
def test_narrow_bins_agree_with_jax(narrow, max_bin):
    X, _, runs = narrow
    jb, tb = runs[max_bin]
    np.testing.assert_array_equal(tb._gbdt.train_set.bins, jb._gbdt.train_set.bins)
    # the NaN-free data keeps max_bin=15 within cuda_packed4's 16 bins
    assert tb._gbdt.num_bins <= max_bin + 1
    _assert_agree(X, jb, tb)


def _spy(monkeypatch):
    """Count the wrapper calls the router makes."""
    calls = {}
    for name in ("histogram", "hist_onehot", "hist_bitplane", "hist_packed4", "hist_packed4_rows"):
        real = getattr(hk, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)

        monkeypatch.setattr(hk, name, spy)
    return calls


@pytest.mark.parametrize("max_bin", NARROW)
def test_forced_impls_and_routes_grow_the_default_trees(narrow, monkeypatch, tmp_path, max_bin):
    X, y, runs = narrow
    want = runs[max_bin][1].model_to_string()
    params = dict(PARAMS, max_bin=max_bin)
    B = runs[max_bin][1]._gbdt.num_bins
    kernels = ["cuda", "cuda_onehot", "cuda_bitplane"] + (["cuda_packed4"] if B <= 16 else [])
    calls = _spy(monkeypatch)

    def no_pack4(*a, **kw):
        raise AssertionError("the grower packs on a call; it must read the set-up copy")

    # cuda_packed4 reads the nibble-packed copy made at set-up, by row
    monkeypatch.setattr(hk, "pack4", no_pack4)
    for impl in kernels:
        monkeypatch.setattr(hk, "_ENV_IMPL", impl)
        got = tlgb.train(dict(params), tlgb.Dataset(X, label=y), ROUNDS, device="cpu")
        assert got.model_to_string() == want, impl
    monkeypatch.setattr(hk, "_ENV_IMPL", "")

    # a hand-built route: alternate row classes to each kernel
    classes = sorted({hk.rows_bucket(s) for s in hk.bucket_sizes(len(y))})
    route = hk.HistRoute(
        [((B, 3, "float32", r), kernels[i % len(kernels)]) for i, r in enumerate(classes)]
    )
    calls.clear()
    booster = tlgb.Booster(dict(params), tlgb.Dataset(X, label=y), device="cpu")
    booster._gbdt.hist_route = route
    for _ in range(ROUNDS):
        booster.update()
    assert booster.model_to_string() == want
    wrapper = {"cuda": "histogram", "cuda_onehot": "hist_onehot",
               "cuda_bitplane": "hist_bitplane", "cuda_packed4": "hist_packed4_rows"}
    assert set(calls) == {wrapper[k] for k in kernels}, calls

    # a table file through hist_tune: on the CPU only its scatter entries route
    path = str(tmp_path / "cpu.json")
    ents = [{"B": B, "K": 3, "hist_dtype": "float32", "rows_bucket": r,
             "impl": "scatter" if i % 2 else "cuda_onehot"} for i, r in enumerate(classes)]
    ttune.save_table(ttune.build_table(ents, backend="cpu", device_family="cpu"), path)
    tabled = tlgb.train(dict(params, hist_tune=path), tlgb.Dataset(X, label=y), ROUNDS, device="cpu")
    assert {impl for _, impl in tabled._gbdt.hist_route.entries} == {"scatter"}
    assert tabled.model_to_string() == want
    assert "hist_tune" not in tabled.model_to_string()


def test_bf16_operands_train_close_to_f32(monkeypatch):
    # 10k rows: at 2k a 15-leaf tree's training AUC moves by 0.01 between
    # runs that differ in the last bits of one split
    X, y = make_higgs_like(10_000, 28, seed=5)
    params = dict(PARAMS, max_bin=63)
    monkeypatch.setattr(hk, "_ENV_IMPL", "cuda_onehot")
    calls = _spy(monkeypatch)
    aucs = {}
    for dtype in ("float32", "bfloat16"):
        b = tlgb.train(dict(params, tpu_hist_dtype=dtype), tlgb.Dataset(X, label=y), ROUNDS,
                       device="cpu")
        assert b.num_trees() == ROUNDS
        (_, _, aucs[dtype], _), = b.eval_train()
    assert calls["hist_onehot"] > 0
    assert aucs["float32"] > 0.65 and abs(aucs["bfloat16"] - aucs["float32"]) <= 0.01, aucs
