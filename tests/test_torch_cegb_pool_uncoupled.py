"""CEGB without coupled penalties under a histogram pool in the port, on
the CPU, against the JAX package's pooled CEGB.

A pooled step's folded scan is the pool's unpenalised one, and the pooled
all-leaves rescan (ops/split.py ``split_pair_all``, the plain version of
csrc/split_pair.cu's pooled all-leaves entry) scans the step's children
under the penalties at every step. With only a split or a lazy penalty no
step pays a coupled feature first, so the rescan scans the children alone
and patches nothing. Split from test_torch_cegb_pool.py to stay under a
minute.

 * The grow-level pair of tests/torch_forced_cegb_helpers.py (the port's
   ``grow_tree_device`` and the JAX ``grow_tree``, three trees with the
   CEGB state carried) at 3 slots with a split penalty only and with a
   lazy penalty only: every tree and the state equal, the rescan ran at
   every step, and the penalty moved the trees (the trees without CEGB
   differ), so an unpenalised pooled tree cannot pass.
 * A training with ``cegb_penalty_split`` and a pool on the CPU's default
   run: the model text equal to ``lightgbm_tpu.train``'s but for the
   gains, and not the model text of the same training without the
   penalty.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu.objective as jobj
import lightgbm_tpu_torch.objective as tobj
from lightgbm_tpu_torch.ops import hist_kernel
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops.grow import grow_tree_device
from test_torch_categorical import _gains_apart
from test_torch_grow_device import _case, _torch_args
from test_torch_widebin import _jax_dyadic, _torch_dyadic
from torch_forced_cegb_helpers import BASE, LEAVES, N_ROWS, grow_pair  # noqa: F401
from torch_forced_cegb_helpers import one_torch_thread, same_models, same_state, train_both  # noqa: F401

F = _case(3, N=N_ROWS)[0].shape[0]
CASES = {
    "split_only_3_slots": ([], (1.0, 0.05, None, None), 3, False, False),
    "lazy_only_3_slots": ([], (1.0, 0.0, None, [0.01] * F), 3, False, False),
}


@pytest.fixture
def rescans(monkeypatch):
    """The records each step's pooled rescan patched, one entry a step."""
    out = []
    plain = tsplit.split_pair_all

    def counted(s):
        n = plain(s)
        out.append(n)
        return n

    monkeypatch.setattr(tsplit, "split_pair_all", counted)
    return out


def _plain_trees(slots, trees=3):
    """The port's trees of the pair's fixture without CEGB, ``slots`` pool slots."""
    bins, meta, grad, hess = _case(3, N=N_ROWS)
    args, nf = _torch_args(bins, meta, grad, hess, LEAVES, -1)
    out, state = [], None
    for t in range(trees):
        g = torch.from_numpy(grad * np.float32(1 + t / 4))
        tree, _, state = grow_tree_device(args[0], g, *args[2:], bins_nf=nf,
                                          hist_pool_slots=slots, state=state)
        out.append(tree)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_pooled_uncoupled_cegb_grows_the_jax_pooled_trees(rescans, case):
    spec = CASES[case]
    got, state = grow_pair(spec, 3)
    assert state.P == spec[2] and state.cegb_on and state.cegb.coupled_t is None
    steps = int(got.num_leaves) - 1
    assert len(rescans) >= steps and not any(rescans), rescans  # every step, nothing patched
    plain = _plain_trees(spec[2])[-1]
    assert any(not torch.equal(getattr(got, name), getattr(plain, name))
               for name in ("split_feature", "threshold_bin", "leaf_count"))


def test_pooled_split_penalty_training_equals_jax(monkeypatch):
    monkeypatch.setattr(jobj.BinaryLogloss, "get_gradients", _jax_dyadic)
    monkeypatch.setattr(tobj.BinaryLogloss, "get_gradients", _torch_dyadic)
    monkeypatch.setattr(hist_kernel, "_ENV_IMPL", None)
    rng = np.random.RandomState(7)
    X = rng.randn(1500, 6)
    y = (X[:, 0] + 0.8 * X[:, 1] + 0.6 * X[:, 2] + 0.3 * rng.randn(1500) > 0).astype(np.float64)
    pool = dict(BASE, histogram_pool_size=3.5 * 6 * 63 * 12 / (1024 * 1024))
    jb, tb = train_both(dict(pool, cegb_penalty_split=0.02), X, y, 3)
    assert tb._gbdt.hist_pool_slots == 3 == jb._gbdt._hist_pool_slots()
    same_models(jb, tb)
    same_state(jb, tb)
    _, unpenalised = train_both(pool, X, y, 3)
    assert _gains_apart(tb.model_to_string())[0] != _gains_apart(unpenalised.model_to_string())[0]
