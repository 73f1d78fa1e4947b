"""EFB groups wider than 256 bins in the port, on the CPU, against the JAX
package.

A feature of more than 256 bins in a bundled sparse table takes a group of
its own wider than 256 bins: the JAX package stores such a table's groups
as int32 (lightgbm_tpu/efb.py ``build_bundled_matrix``), the port keeps
them so on the host and as int16 on the training device
(models/gbdt.py ``device_bin_dtype``). The fixture: a CSR table of one
column of about 1,000 values (half of its rows at 0) beside 8 one-hot
columns, at ``max_bin`` 400 and 1024.

 * Binning equals the JAX package's, and the device copy holds the same
   group bins as int16.
 * The plain remap (ops/remap.py, the plain version of csrc/efb_remap.cu's
   wide instantiation, a 1024-slot tree) equals the densified table's
   feature histogram bit for bit on dyadic values; its order is the
   kernel's four slots a thread, then the 256-slot tree.
 * Trainings through the host loop and the device loop (its plain
   versions: the remap, the bundled pick of int16 groups, the bundled
   predict of the validation set) on dyadic gradients: the TreeArrays equal
   the JAX package's node for node, the model text but its gains, the gains
   within 8 ulps of the exact gain, the validation scores bit for bit.
 * The bundled predict over the ``[N, G]`` int16 bins gives the JAX
   ``tree_predict_leaf``'s leaves over the int32 ones.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu.objective as jobj
import lightgbm_tpu_torch as tlgb
import lightgbm_tpu_torch.objective as tobj
from lightgbm_tpu.ops import predict as jpredict
from lightgbm_tpu_torch.ops import hist_kernel, predict_kernel, remap
from lightgbm_tpu_torch.ops.grow import TreeArrays
from lightgbm_tpu_torch.ops.histogram import leaf_histogram
from test_torch_categorical import _exact_gains, _gains_apart
from test_torch_efb import _binned, _same_binned
from test_torch_widebin import _jax_dyadic, _torch_dyadic
from torch_forced_cegb_helpers import one_torch_thread  # noqa: F401

PARAMS = {"objective": "binary", "verbose": -1, "min_data_in_bin": 1, "num_leaves": 15,
          "min_data_in_leaf": 20, "learning_rate": 0.25}
WIDTHS = [400, 1024]


def wide_table(seed, n=3000):
    """One column of about 1,000 values, zero in half of its rows, beside 8
    one-hot columns, as CSR; a noisy binary label of both."""
    rng = np.random.RandomState(seed)
    hot = np.zeros((n, 8))
    hot[np.arange(n), rng.randint(0, 8, n)] = 1.0
    wide_col = np.where(rng.rand(n) < 0.5, 0.0, rng.randint(0, 1000, n) + 1.0)
    X = sp.csr_matrix(np.c_[wide_col, hot])
    y = (hot[:, 0] - hot[:, 3] + (wide_col > 500) + 0.7 * rng.randn(n) > 0.5).astype(np.float64)
    return X, y


@pytest.mark.parametrize("max_bin", WIDTHS)
def test_binning_and_device_bins(max_bin):
    X, y = wide_table(0)
    params = dict(PARAMS, max_bin=max_bin)
    _, jb = _binned(jlgb, X, y, params)
    _, tb = _binned(tlgb, X, y, params)
    _same_binned(tb, jb)
    assert tb.is_bundled and 256 < tb.max_group_bins <= 1024 and tb.bins.dtype == np.int32
    booster = tlgb.Booster(params, tlgb.Dataset(X, label=y), device="cpu")
    g = booster._gbdt
    assert g.bins_dev.dtype == torch.int16 and g.hist_width == tb.max_group_bins
    np.testing.assert_array_equal(g.bins_dev.numpy().astype(np.int32), tb.bins)


@pytest.mark.parametrize("max_bin", WIDTHS)
def test_plain_remap_equals_dense_histogram(max_bin):
    X, y = wide_table(1)
    params = dict(PARAMS, max_bin=max_bin)
    _, b = _binned(tlgb, X, y, params)
    _, d = _binned(tlgb, X.toarray(), y, params)
    assert b.max_num_bin > 256 and not d.is_bundled
    rng = np.random.RandomState(5)
    n = X.shape[0]
    v = np.stack([np.round(rng.randn(n) * 8) / 8, np.round(rng.rand(n) * 8) / 8, np.ones(n)], 1)
    v = torch.from_numpy(v.astype(np.float32))
    meta = {k: torch.from_numpy(np.asarray(a).astype(np.int32))
            for k, a in b.feature_meta_arrays().items()}
    B = b.max_num_bin
    groups = torch.from_numpy(b.bins.astype(np.int16))
    for rows in (None, torch.from_numpy(np.sort(rng.choice(n, 700, replace=False))).int()):
        vr = v if rows is None else v[rows.long()]
        gh = leaf_histogram(groups, v, b.max_group_bins, rows)
        got = remap.remap_hist(gh, vr.sum(0), meta, B)
        want = leaf_histogram(torch.from_numpy(d.bins), v, B, rows)
        assert got.numpy().tobytes() == want.numpy().tobytes()


def test_wide_pairwise_sum_is_the_kernels_order():
    """The 1024-slot tree equals csrc/efb_remap.cu's kWide order (thread s:
    (v[s] + v[s + 512]) + (v[s + 256] + v[s + 768]), then the 256-slot
    tree) bit for bit on real values, and a row of at most 256 bins sums
    alike over 256 and 1024 slots."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(3, 1000, 3).astype(np.float32))
    pad = torch.cat([x, torch.zeros(3, 24, 3)], 1)
    quads = (pad[:, :256] + pad[:, 512:768]) + (pad[:, 256:512] + pad[:, 768:])
    assert torch.equal(remap.pairwise_sum(x, remap.slots(1000)), remap.pairwise_sum(quads))
    assert remap.slots(256) == remap.SLOTS and remap.slots(257) == remap.WIDE_SLOTS
    y = x[:, :200] + 1.0
    assert torch.equal(remap.pairwise_sum(y, 1024), remap.pairwise_sum(y))


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's trainings with a bundled validation set, once."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jobj.BinaryLogloss, "get_gradients", _jax_dyadic)
        for max_bin in WIDTHS:
            out[max_bin] = _train(jlgb, dict(PARAMS, max_bin=max_bin))
    return out


def _train(pkg, params, **kw):
    X, y = wide_table(2)
    Xv, yv = wide_table(3, n=800)
    ds = pkg.Dataset(X, label=y)
    res = {}
    b = pkg.train(dict(params, metric="binary_logloss"), ds, 3, evals_result=res,
                  valid_sets=[pkg.Dataset(Xv, label=yv, reference=ds)], verbose_eval=False, **kw)
    return b, res


@pytest.mark.parametrize("loop", ["host", "device"])
@pytest.mark.parametrize("max_bin", WIDTHS)
def test_training_equals_jax(jax_runs, monkeypatch, max_bin, loop):
    jb, jres = jax_runs[max_bin]
    params = dict(PARAMS, max_bin=max_bin)
    monkeypatch.setattr(tobj.BinaryLogloss, "get_gradients", _torch_dyadic)
    monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda" if loop == "device" else None)
    tb, tres = _train(tlgb, params, device="cpu")
    g = tb._gbdt
    assert g.grow_loop == loop and g.hist_width > 256 and g.bins_dev.dtype == torch.int16
    assert g._valid_bins[0].dtype == torch.int16
    for i, ta in enumerate(g._tree_arrays):
        want = jb._gbdt._device_trees[i][0]
        for name in TreeArrays._fields:
            if name in ("split_gain", "leaf_value"):
                continue
            np.testing.assert_array_equal(getattr(ta, name).numpy(), np.asarray(getattr(want, name)),
                                          err_msg="tree %d %s" % (i, name))
    (jt, jg), (tt, tg) = (_gains_apart(b.model_to_string()) for b in (jb, tb))
    assert tt == jt
    exact = _exact_gains(tb, params)
    want = np.concatenate([e for e, _ in exact])
    bound = np.concatenate([b for _, b in exact])
    for gains in (tg, jg):
        assert (np.abs(gains - want) <= bound).all()
    np.testing.assert_array_equal(g.valid_scores[0].numpy(), np.asarray(jb._gbdt.valid_scores[0]))
    assert tres == jres


def test_bundled_predict_equals_jax(jax_runs):
    """The plain bundled predict (ops/predict.py, csrc/predict_bins.cu's
    int16 bundled instantiation) over ``[N, G]`` int16 group bins: every
    row's leaf of each of the JAX package's trees, against the JAX
    ``tree_predict_leaf`` over its int32 bins."""
    jb, _ = jax_runs[1024]
    X, y = wide_table(3, n=800)
    _, b = _binned(tlgb, X, y, dict(PARAMS, max_bin=1024))
    jmeta = jb._gbdt.feature_meta
    meta = {k: torch.from_numpy(np.asarray(v).astype(np.int32)) for k, v in jmeta.items()
            if k in ("num_bin", "missing_type", "default_bin", "group_id", "bin_offset")}
    bins16 = torch.from_numpy(np.ascontiguousarray(b.bins.T.astype(np.int16)))
    for tree, _ in jb._gbdt._device_trees:
        M = int(tree.num_leaves)
        node_i = torch.from_numpy(np.stack(
            [np.asarray(tree.split_feature), np.asarray(tree.threshold_bin),
             np.asarray(tree.left_child), np.asarray(tree.right_child),
             np.asarray(tree.default_left).astype(np.int32)], 1).astype(np.int32))
        leaf = torch.zeros(len(y), dtype=torch.int32)
        score = torch.zeros(len(y))
        predict_kernel.add_tree_value(bins16, node_i, torch.tensor([M], dtype=torch.int32), meta,
                                      torch.arange(node_i.shape[0] + 1, dtype=torch.float32),
                                      score, leaf_out=leaf)
        want = jpredict.tree_predict_leaf(jnp.asarray(np.ascontiguousarray(b.bins.T)),
                                          jpredict.make_predict_tree(tree, jmeta))
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want))
        np.testing.assert_array_equal(score.numpy(), leaf.numpy().astype(np.float32))
