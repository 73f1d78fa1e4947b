"""CEGB under a histogram pool in the port, on the CPU, against the JAX
package's pooled CEGB.

Under a pool the reference rescans only the leaves whose histograms are
resident after a split (``rescan_resident``, lightgbm_tpu/ops/grow.py:
1049-1108): an evicted leaf keeps its cached record, whose gain takes back
the coupled penalty of the feature the split paid first when the record is
on that feature (Split, serial_tree_learner.cpp:757-775). So pooled CEGB
trees may differ from unpooled ones, and the port is held to the pooled
reference. The port rescans the resident leaves only after a first
payment (a resident leaf's record changes only then) and patches the
evicted ones in the same launch (ops/split.py ``split_pair_all``, the plain
version of csrc/split_pair.cu's pooled all-leaves entry).

 * The grow-level pair of tests/torch_forced_cegb_helpers.py (the port's
   ``grow_tree_device`` and the JAX ``grow_tree``, three trees with the
   CEGB state carried) at 3 and 4 slots with coupled penalties, and at 4
   with all three penalties and a bag: every tree and the state equal, and
   the patch fired on the coupled cases: evicted leaves whose cached best
   was on a feature a later split paid first. At 3 slots the pooled trees
   differ from the unpooled ones, so the pooled reference is the one
   held.
 * Whole trainings with CEGB and a pool on the CPU's default run: the
   model text equal to ``lightgbm_tpu.train``'s but for the gains, the
   CEGB state equal.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu.objective as jobj
import lightgbm_tpu_torch.objective as tobj
from lightgbm_tpu_torch.ops import grow_state as gs
from lightgbm_tpu_torch.ops import hist_kernel
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops.grow import grow_tree_device
from test_torch_grow_device import _case, _torch_args
from test_torch_widebin import _jax_dyadic, _torch_dyadic
from torch_forced_cegb_helpers import BASE, LEAVES, N_ROWS, grow_pair  # noqa: F401
from torch_forced_cegb_helpers import one_torch_thread, same_models, same_state, train_both  # noqa: F401

F = _case(3, N=N_ROWS)[0].shape[0]
COUPLED = list(np.linspace(0.5, 3.0, F))
CASES = {
    "coupled_3_slots": ([], (1.0, 0.0, [3.0] * F, None), 3, False, False),
    "coupled_4_slots": ([], (1.0, 0.0, COUPLED, None), 4, False, False),
    "all_penalties_bag": ([], (1.0, 0.05, COUPLED, [0.01] * F), 4, False, True),
}


@pytest.fixture
def patches(monkeypatch):
    """The evicted records each step's pooled rescan patched."""
    out = []
    plain = tsplit.split_pair_all

    def counted(s):
        n = plain(s)
        out.append(n)
        return n

    monkeypatch.setattr(tsplit, "split_pair_all", counted)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_pooled_cegb_grows_the_jax_pooled_trees(patches, case):
    spec = CASES[case]
    _, state = grow_pair(spec, 3)
    assert state.P == spec[2] and state.cegb_on
    if spec[4]:
        return  # with the bag and lazy penalties the trees equal, no patch needed here
    assert sum(patches) > 0, patches  # an evicted leaf's record on a newly paid feature
    if case == "coupled_3_slots":  # the stale records move the trees: unpooled ones differ
        pooled, unpooled = (_port_trees(spec, slots) for slots in (spec[2], None))
        assert any(not torch.equal(getattr(a, name), getattr(b, name))
                   for a, b in zip(pooled, unpooled)
                   for name in ("split_feature", "threshold_bin", "leaf_count"))


def _port_trees(spec, slots, trees=3):
    """The port's trees of the pair's fixture (grow_pair's gradients) with
    ``slots`` pool slots (None: no pool), the CEGB state carried."""
    _, (tradeoff, penalty_split, coupled, lazy), _, _, _ = spec
    bins, meta, grad, hess = _case(3, N=N_ROWS)
    args, nf = _torch_args(bins, meta, grad, hess, LEAVES, -1)
    cegb = gs.Cegb(tsplit.CegbParams(tradeoff, penalty_split, coupled is not None,
                                     lazy is not None), F, len(grad), coupled, lazy,
                   torch.device("cpu"))
    out, state = [], None
    for t in range(trees):
        g = torch.from_numpy(grad * np.float32(1 + t / 4))
        tree, _, state = grow_tree_device(args[0], g, *args[2:], bins_nf=nf, cegb=cegb,
                                          hist_pool_slots=slots, state=state)
        out.append(tree)
    return out


def test_pooled_cegb_training_equals_jax(monkeypatch):
    monkeypatch.setattr(jobj.BinaryLogloss, "get_gradients", _jax_dyadic)
    monkeypatch.setattr(tobj.BinaryLogloss, "get_gradients", _torch_dyadic)
    monkeypatch.setattr(hist_kernel, "_ENV_IMPL", None)
    rng = np.random.RandomState(7)
    X = rng.randn(1500, 6)
    y = (X[:, 0] + 0.8 * X[:, 1] + 0.6 * X[:, 2] + 0.3 * rng.randn(1500) > 0).astype(np.float64)
    params = dict(BASE, cegb_penalty_feature_coupled=[1.5] * 6, cegb_penalty_split=0.01,
                  histogram_pool_size=3.5 * 6 * 63 * 12 / (1024 * 1024))
    jb, tb = train_both(params, X, y, 3)
    assert tb._gbdt.hist_pool_slots == 3 == jb._gbdt._hist_pool_slots()
    same_models(jb, tb)
    same_state(jb, tb)
