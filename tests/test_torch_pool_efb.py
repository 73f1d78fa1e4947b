"""The histogram pool (``histogram_pool_size``) with an EFB-bundled table in
the port, on the CPU, against the JAX package.

On a step whose parent's histogram was evicted, the larger child is built
over the groups into a group scratch of its own (``large_g``) and remapped
into feature space with the larger child's record sums, as the smaller one
is (lightgbm_tpu/ops/grow.py:1455-1476; ops/remap.py ``remap_large``), so a
pooled bundled step is six launches on the card. The CPU's default run
takes the device loop for a pool, on the plain versions. Fixtures: the
two-dense-plus-12-one-hot CSR table of tests/torch_forced_cegb_helpers.py
(3 groups of 63 bins), and the wide table of tests/test_torch_efb_wide.py
(a group of more than 256 bins, int16 groups), both packages' gradients
through one dyadic rule.

 * Pooled trainings at 2 and 5 slots: the TreeArrays equal the JAX
   package's pooled ones and the port's unpooled ones, the model text but
   its gains equal the JAX package's, the gains within 8 ulps of the exact
   gain; the larger child's remap ran on misses.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu.objective as jobj
import lightgbm_tpu_torch as tlgb
import lightgbm_tpu_torch.objective as tobj
from lightgbm_tpu_torch.ops import grow_state as gs
from lightgbm_tpu_torch.ops import hist_kernel, remap
from lightgbm_tpu_torch.ops.grow import TreeArrays
from test_torch_categorical import _exact_gains, _gains_apart
from test_torch_efb_wide import wide_table
from test_torch_widebin import _jax_dyadic, _torch_dyadic
from torch_forced_cegb_helpers import BASE, efb_table, one_torch_thread  # noqa: F401

ROUNDS = 3
TABLES = {
    "narrow": (efb_table, dict(BASE, num_leaves=15)),
    "wide": (wide_table, dict(BASE, num_leaves=15, max_bin=1024, min_data_in_bin=1)),
}


def _pool_mb(slots, F, num_bins):
    """histogram_pool_size (MB) that gives ``slots`` slots of F·B·3·4 bytes."""
    return (slots + 0.5) * F * num_bins * 12 / (1024 * 1024)


@pytest.fixture(scope="module")
def runs():
    """Per table: the port's unpooled training and the JAX package's pooled
    ones at 2 and 5 slots, on dyadic gradients, once for the module."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jobj.BinaryLogloss, "get_gradients", _jax_dyadic)
        mp.setattr(tobj.BinaryLogloss, "get_gradients", _torch_dyadic)
        mp.setattr(hist_kernel, "_ENV_IMPL", None)
        for name, (table, params) in TABLES.items():
            X, y = table(0)
            free = tlgb.train(dict(params), tlgb.Dataset(X, label=y), ROUNDS, device="cpu")
            g = free._gbdt
            pooled = {}
            for slots in (2, 5):
                p = dict(params, histogram_pool_size=_pool_mb(
                    slots, g.train_set.num_features, g.num_bins))
                pooled[slots] = (p, jlgb.train(dict(p), jlgb.Dataset(X, label=y), ROUNDS))
            out[name] = (X, y, free, pooled)
    return out


@pytest.mark.parametrize("slots", [2, 5])
@pytest.mark.parametrize("table", sorted(TABLES))
def test_pooled_bundled_equals_jax_and_unpooled(runs, monkeypatch, table, slots):
    X, y, free, pooled = runs[table]
    params, jb = pooled[slots]
    monkeypatch.setattr(tobj.BinaryLogloss, "get_gradients", _torch_dyadic)
    monkeypatch.setattr(hist_kernel, "_ENV_IMPL", None)
    misses = []
    plain_large = remap.remap_large

    def counted(s, parity):
        if int(s.ctl[gs.ACTIVE]) and int(s.pool_ctl[gs.RUN]):
            misses.append(int(s.pool_ctl[gs.LEAF]))
        plain_large(s, parity)

    monkeypatch.setattr(remap, "remap_large", counted)
    tb = tlgb.train(dict(params), tlgb.Dataset(X, label=y), ROUNDS, device="cpu")
    g = tb._gbdt
    assert g.grow_loop == "device" and g.num_groups > 0
    assert g.hist_pool_slots == slots == jb._gbdt._hist_pool_slots()
    s = g._grow_state
    assert s.P == slots and s.G == g.num_groups and s.large_g.shape == (2, s.G, s.Bg, 3)
    assert misses  # the pool evicted parents: larger children built over the groups
    for i, ta in enumerate(g._tree_arrays):
        want = jb._gbdt._device_trees[i][0]
        other = free._gbdt._tree_arrays[i]
        for name in TreeArrays._fields:
            np.testing.assert_array_equal(getattr(ta, name).numpy(),
                                          getattr(other, name).numpy(), err_msg=name)
            if name not in ("split_gain", "leaf_value"):
                np.testing.assert_array_equal(getattr(ta, name).numpy(),
                                              np.asarray(getattr(want, name)),
                                              err_msg="tree %d %s" % (i, name))
    (jt, jg), (tt, tg) = (_gains_apart(b.model_to_string()) for b in (jb, tb))
    assert tt == jt
    exact = _exact_gains(tb, params)
    want = np.concatenate([e for e, _ in exact])
    bound = np.concatenate([b for _, b in exact])
    for gains in (tg, jg):
        assert (np.abs(gains - want) <= bound).all()
    np.testing.assert_array_equal(g.scores.numpy(), np.asarray(jb._gbdt.scores))
    assert torch.equal(g.scores, free._gbdt.scores)
