"""Forced splits under a histogram pool in the port's device loop, on the
CPU, against the JAX ``grow_tree`` (tests/test_torch_forced_cegb.py's
bitwise tier, tests/torch_forced_cegb_helpers.py's pair; a file of its own
so that each file of the forced cases stays under a minute):

 * three forced splits under a pool of 5 slots (the preamble's K + 2);
 * a pool too small for the preamble raises ValueError in both packages.
"""
import jax.numpy as jnp
import pytest

from lightgbm_tpu.ops.grow import grow_tree as jax_grow_tree
from lightgbm_tpu.ops.split import SplitParams as JaxSplitParams
from lightgbm_tpu_torch.ops.grow import grow_tree_device
from test_torch_grow_device import PARAMS, _case, _torch_args
from torch_forced_cegb_helpers import check_forced, one_torch_thread  # noqa: F401

#: (forced, CEGB, pool slots, categorical, bag), as tests/torch_forced_cegb_helpers.py says
CASES = {
    "forced_pool": ([(0, 0, 30), (0, 1, 10), (1, 2, 20)], None, 5, False, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_grow_matches_jax(case):
    check_forced(case, CASES[case])


def test_pool_too_small_for_the_preamble():
    bins, meta, grad, hess = _case(3, N=600)
    args, nf = _torch_args(bins, meta, grad, hess, 15, -1)
    forced = [(0, 0, 30), (0, 5, 20), (1, 1, 25)]
    with pytest.raises(ValueError, match="too small for the forced-splits preamble"):
        grow_tree_device(*args, bins_nf=nf, forced_splits=forced, hist_pool_slots=4)
    with pytest.raises(ValueError, match="too small for the forced-splits preamble"):
        jax_grow_tree(jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
                      jnp.ones(len(grad)), jnp.ones(bins.shape[0], bool),
                      {k: jnp.asarray(v) for k, v in meta.items()}, num_leaves=15, max_depth=-1,
                      num_bins=int(meta["num_bin"].max()), params=JaxSplitParams(*PARAMS),
                      forced_splits=tuple(forced), hist_pool_slots=4)
