"""CEGB (cost-effective gradient boosting, ``cegb_*``) in the port's device
loop, on the CPU, against the JAX package (lightgbm_tpu/ops/grow.py:1010-
1047 and 1392-1420, lightgbm_tpu/ops/split.py:649-653).

 * The plain penalised scan against the JAX ``find_best_split`` with a
   penalty, on dyadic histograms; the penalty against the reference's f32
   formula, operation by operation.
 * Bitwise tier, three trees in a row carrying one CEGB state, on dyadic
   gradients (tests/torch_forced_cegb_helpers.py ``grow_pair``): the split,
   coupled and lazy penalties each alone (together, with a bag and with a
   forced split on categorical features: tests/test_torch_cegb_combined.py):
   every TreeArrays field, the per-row leaf, the paid features and the paid
   rows equal after each tree, the gains as the helpers' ``same_tree``
   holds them. The combined cases are a file of their own so that each
   file stays under a minute (every CEGB setting is a JAX compile of its
   own).
 * The all-leaves rescan's design: on a step that paid no coupled feature
   first, a full rescan of every other leaf changes no record.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.split import SplitParams as JaxSplitParams
from lightgbm_tpu.ops.split import find_best_split as jax_find_best_split
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.ops import grow_state as gs
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops.grow import grow_tree_device
from test_torch_grow_device import _case, _torch_args
from torch_forced_cegb_helpers import dyadic_hist, grow_pair, one_torch_thread  # noqa: F401


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_penalised_scan_matches_jax(seed):
    rng = np.random.RandomState(seed)
    F, B = 6, 24
    h = dyadic_hist(rng, F, B)
    meta = {"num_bin": rng.randint(3, B + 1, F).astype(np.int32),
            "missing_type": (np.arange(F) % 3).astype(np.int32),
            "default_bin": np.ones(F, np.int32), "monotone": np.zeros(F, np.int8)}
    sg, sh, n = (float(v) for v in h[0].sum(axis=0))
    pen = (rng.randint(0, 64, F) / 4.0).astype(np.float32)
    fmask = np.ones(F, bool)
    params = (0.0, 1.0, 0.0, 5, 1e-3, 0.0)
    want = jax_find_best_split(
        jnp.asarray(h), jnp.float32(sg), jnp.float32(sh), jnp.float32(n), jnp.float32(-np.inf),
        jnp.float32(np.inf), {k: jnp.asarray(v) for k, v in meta.items()}, jnp.asarray(fmask),
        JaxSplitParams(*params), jnp.asarray(pen))
    got = tsplit.find_best_split(
        torch.from_numpy(h), sg, sh, n, -np.inf, np.inf, convert.meta_tensors(meta),
        torch.from_numpy(fmask), tsplit.SplitParams(*params), torch.from_numpy(pen))
    for name in ("feature", "threshold", "default_left", "left_count", "right_count",
                 "left_sum_grad", "left_sum_hess"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.gain.numpy(), np.asarray(want.gain), rtol=1e-6)


def test_penalty_is_the_reference_formula():
    """split * count + coupled * !paid + lazy * unpaid, f32, in that order."""
    cegb = tsplit.CegbParams(tradeoff=2.5, penalty_split=0.3, has_coupled=True, has_lazy=True)
    count = torch.tensor([100.0, 7.0])
    used = torch.tensor([True, False, False])
    unused = torch.tensor([[3.0, 0.0, 9.0], [1.0, 2.0, 0.0]])
    c = gs.Cegb(cegb, 3, 10, np.array([1.0, 2.0, 0.5]), np.array([0.1, 0.2, 0.4]),
                torch.device("cpu"))
    got = tsplit.cegb_penalty(cegb, count, used, unused, c.coupled_t, c.lazy_t).numpy()
    f = np.float32
    for i in range(2):
        for j in range(3):
            want = f(f(2.5 * 0.3) * f(count[i]))
            want = f(want + f(f(2.5) * f([1.0, 2.0, 0.5][j])) * f(not used[j]))
            want = f(want + f(f(2.5) * f([0.1, 0.2, 0.4][j])) * f(unused[i, j]))
            assert got[i, j] == want, (i, j)


#: (forced, (tradeoff, penalty_split, coupled, lazy), pool slots, categorical, bag)
CEGB_CASES = {
    "penalty_split": ((), (1.0, 0.008, None, None), None, False, False),
    "coupled": ((), (1.0, 0.0, [0.9, 0.0, 12.0, 1.5, 0.3, 0.6], None), None, False, False),
    "lazy": ((), (1.0, 0.0, None, [0.02, 0.05, 0.01, 0.0, 0.1, 0.03]), None, False, False),
}


@pytest.mark.parametrize("case", sorted(CEGB_CASES))
def test_grow_matches_jax(case):
    got, _ = grow_pair(CEGB_CASES[case], 3)
    assert int(got.num_leaves) > 3, (case, int(got.num_leaves))


def test_all_leaves_scan_returns_unless_a_coupled_feature_was_paid_first():
    """The design of csrc/split_pair.cu's all-leaves entry: a step that paid
    no coupled feature first leaves every other leaf's record as a full
    rescan finds it."""
    bins, meta, grad, hess = _case(3, N=1500)
    F, N = bins.shape[0], len(grad)
    c = gs.Cegb(tsplit.CegbParams(1.0, 0.0, True, False), F, N, [3.0] * F, None,
                torch.device("cpu"))
    args, nf = _torch_args(bins, meta, grad, hess, 15, -1)
    _, _, s = grow_tree_device(*args, bins_nf=nf, cegb=c)
    nl = int(s.ctl[gs.NUM_LEAVES])
    assert nl > 3 and int(s.ctl[gs.NEWLY]) == 0  # the last step paid nothing new
    before = s.best_f.clone(), s.best_i.clone()
    s.ctl[gs.NEWLY] = 1  # as if it had: every other leaf rescanned
    tsplit.split_pair_all(s)
    assert torch.equal(s.best_f[:nl], before[0][:nl]) and torch.equal(s.best_i[:nl], before[1][:nl])
