"""Helpers of the port's forced-split and CEGB tests on the CPU
(tests/test_torch_forced_cegb.py, test_torch_forced_root_cat.py,
test_torch_forced_pool.py, test_torch_forced_efb.py, test_torch_cegb.py,
test_torch_cegb_combined.py, test_torch_cegb_train.py): the grow-level
pair of the port's ``grow_tree_device`` and the JAX ``grow_tree`` on one
fixture, the training-level pair of ``lightgbm_tpu.train`` and the port's
``train`` with its comparisons, and the fixtures those files share.

The cases live in the file that parametrises them. Each case is a tuple
(forced, CEGB, pool slots, categorical, bag): ``forced`` a BFS table of
(leaf, used feature, threshold bin); CEGB None or (tradeoff,
penalty_split, coupled [F] or None, lazy [F] or None); pool slots None for
no pool; ``categorical`` features 3 and 4 one-hot categorical; ``bag`` a
fixed 70% bag. Every JAX compile of a forced preamble or a CEGB setting is
a compile of its own, so the cases are spread over files that each stay
under a minute under ``--dist loadfile``.
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
from lightgbm_tpu.ops.grow import grow_tree as jax_grow_tree
from lightgbm_tpu.ops.split import CegbParams as JaxCegb
from lightgbm_tpu.ops.split import SplitParams as JaxSplitParams
from lightgbm_tpu_torch.ops import grow_state as gs
from lightgbm_tpu_torch.ops import hist_kernel
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops.grow import TreeArrays, grow_tree_device
from test_torch_categorical import _gains_apart
from test_torch_grow_device import PARAMS, _case, _torch_args
from test_torch_widebin import _jax_dyadic, _torch_dyadic

N_ROWS, LEAVES = 500, 11

#: the training-level tests' parameters
BASE = {"objective": "binary", "verbosity": -1, "num_leaves": 15, "max_bin": 63,
        "min_data_in_leaf": 5}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def device_loop(monkeypatch):
    """The device loop on the CPU, both packages' binary gradients through
    one dyadic rule."""
    monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")
    monkeypatch.setattr(jobj.BinaryLogloss, "get_gradients", _jax_dyadic)
    monkeypatch.setattr(tobj.BinaryLogloss, "get_gradients", _torch_dyadic)


def dyadic_hist(rng, F, B):
    """A [F, B, 3] f32 histogram of dyadic sums and integer counts."""
    h = np.zeros((F, B, 3), np.float32)
    h[..., 0] = rng.randint(-64, 65, (F, B)) / 16.0
    h[..., 1] = rng.randint(1, 65, (F, B)) / 16.0
    h[..., 2] = rng.randint(1, 40, (F, B))
    return h


def _meta_cat(meta):
    out = dict(meta)
    out["is_categorical"] = np.zeros(len(meta["num_bin"]), bool)
    out["is_categorical"][[3, 4]] = True
    return out


def same_tree(got, got_leaf, want, want_leaf):
    """Every TreeArrays field and the per-row leaf equal, the gains within
    rtol 1e-6 plus 1e-6 of the tree's largest gain: XLA fuses the gain's
    multiply-adds, and a forced record's gain is a difference of two gains
    that cancel (its split's and its parent's)."""
    for name in TreeArrays._fields:
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name == "split_gain":
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6 * float(np.abs(a).max()))
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
    np.testing.assert_array_equal(np.asarray(got_leaf), np.asarray(want_leaf))


def grow_pair(spec, trees):
    """``grow_tree_device`` and the JAX ``grow_tree`` on the fixture, one
    tree after another with the CEGB state carried (each tree's gradients
    the fixture's times 1 + t / 4 for tree t): every tree and the state after each
    equal. Returns the port's last tree and state."""
    forced, cegb, slots, cat, with_bag = spec
    bins, meta, grad, hess = _case(3, N=N_ROWS)
    if cat:
        meta = _meta_cat(meta)
    N, F, M, B = len(grad), bins.shape[0], LEAVES, int(meta["num_bin"].max())
    bag = ((np.random.RandomState(5).rand(N) > 0.3).astype(np.float32) if with_bag
           else np.ones(N, np.float32))
    jmeta = {k: jnp.asarray(v) for k, v in meta.items()}
    jkw = dict(num_leaves=M, max_depth=-1, num_bins=B, params=JaxSplitParams(*PARAMS),
               two_way=True, forced_splits=tuple(forced), hist_pool_slots=slots)
    tcegb = None
    if cegb is not None:
        tradeoff, ps, coupled, lazy = cegb
        jkw["cegb"] = JaxCegb(tradeoff, ps, coupled is not None, lazy is not None)
        if coupled is not None:
            jmeta["cegb_coupled"] = jnp.asarray(np.float32(coupled))
        if lazy is not None:
            jmeta["cegb_lazy"] = jnp.asarray(np.float32(lazy))
        tcegb = gs.Cegb(tsplit.CegbParams(*jkw["cegb"]), F, N, coupled, lazy, torch.device("cpu"))
    args, nf = _torch_args(bins, meta, grad, hess, M, -1)
    jstate, state = None, None
    for t in range(trees):
        g = grad * np.float32(1 + t / 4)  # each tree its own dyadic gradients
        out = jax_grow_tree(jnp.asarray(bins), jnp.asarray(g), jnp.asarray(hess), jnp.asarray(bag),
                            jnp.ones(F, bool), jmeta, cegb_state=jstate, **jkw)
        want, want_leaf = out[:2]
        targs = (args[0], torch.from_numpy(g)) + args[2:]
        got, got_leaf, state = grow_tree_device(
            *targs, bins_nf=nf, bag=torch.from_numpy(bag), forced_splits=forced, cegb=tcegb,
            hist_pool_slots=slots, state=state)
        same_tree(got, got_leaf, want, want_leaf)
        if cegb is not None:
            jstate = out[2]
            np.testing.assert_array_equal(tcegb.feature_used.numpy(), np.asarray(jstate[0]))
            if tcegb.used_in_data is not None:
                np.testing.assert_array_equal(tcegb.used_in_data.numpy().T, np.asarray(jstate[1]))
    return got, state


def check_forced(case, spec):
    """One tree of ``spec`` equal in both packages, its forced splits its
    first nodes (or, for ``forced_abort_invalid``, only the first)."""
    forced = spec[0]
    got, state = grow_pair(spec, 1)
    nl = int(got.num_leaves)
    assert nl > 3, (case, nl)
    if case == "forced_abort_invalid":  # the first forced split, then the best-gain ones
        assert int(state.ctl[gs.ABORT]) == 1 and int(got.split_feature[0]) == 0
        assert (int(got.split_feature[1]), int(got.threshold_bin[1])) != (5, 20)
    elif forced:
        assert int(state.ctl[gs.ABORT]) == 0
        for node, (_, f, thr) in enumerate(forced):
            assert (int(got.split_feature[node]), int(got.threshold_bin[node])) == (f, thr)


# ---- training level ------------------------------------------------------------------

def efb_table(seed, n=1500):
    """A CSR table of two dense columns and 12 one-hot ones (which EFB
    bundles at ``max_conflict_rate`` 0) and its binary label."""
    rng = np.random.RandomState(seed)
    hot = np.zeros((n, 12))
    hot[np.arange(n), rng.randint(0, 12, n)] = 1.0
    dense = rng.randn(n, 2)
    X = sp.csr_matrix(np.c_[dense, hot])
    y = (hot[:, :4].sum(1) + dense[:, 0] + 0.3 * rng.randn(n) > 0.5).astype(np.float64)
    return X, y


def same_models(jb, tb, rtol=1e-5):
    (jt, jg), (tt, tg) = (_gains_apart(b.model_to_string()) for b in (jb, tb))
    assert tt == jt
    np.testing.assert_allclose(tg, jg, rtol=rtol)


def cegb_state(b):
    g = b._gbdt
    if hasattr(g, "_cegb_state"):  # the JAX package's
        fu, uid = g._cegb_state
        return np.asarray(fu), (np.asarray(uid) if uid.shape != (1, 1) else None)
    c = g._cegb
    return c.feature_used.numpy(), (None if c.used_in_data is None else c.used_in_data.numpy().T)


def same_state(jb, tb):
    (jf, ju), (tf, tu) = cegb_state(jb), cegb_state(tb)
    np.testing.assert_array_equal(tf, jf)
    assert (ju is None) == (tu is None)
    if ju is not None:
        np.testing.assert_array_equal(tu, ju)


def train_both(params, X, y, rounds):
    jb = jlgb.train(dict(params), jlgb.Dataset(X, label=y), rounds)
    tb = tlgb.train(dict(params), tlgb.Dataset(X, label=y), rounds, device="cpu")
    assert tb._gbdt.grow_loop == "device"
    return jb, tb
