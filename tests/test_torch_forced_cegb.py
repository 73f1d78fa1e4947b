"""Forced splits (``forcedsplits_filename``) in the port, on the CPU,
against the JAX package (lightgbm_tpu/ops/grow.py's forced preamble,
tests/test_forced_cegb.py's serial fixtures). On the CPU the device loop
runs its kernels' plain versions (``LIGHTGBM_TPU_HIST_IMPL=cuda``). The
grow-level pair and the shared fixtures are tests/torch_forced_cegb_helpers.py's;
the cases are spread over this file, tests/test_torch_forced_root_cat.py
and tests/test_torch_forced_pool.py so that each stays under a minute
(every forced table is a JAX compile of its own). tests/test_torch_cegb.py
holds CEGB at the grow level and tests/test_torch_cegb_train.py both in
whole trainings.

 * The forced record's plain version against the JAX
   ``gather_info_for_threshold`` (numerical under each missing type,
   one-hot categorical, a threshold past the feature's bins) on dyadic
   histograms, every field equal.
 * Bitwise tier, on dyadic gradients (tests/test_torch_grow_device.py's
   fixture): ``grow_tree_device`` with forced splits (a BFS, an abort by an
   invalid split) against the JAX ``grow_tree``: every TreeArrays field and
   the per-row leaf equal, the gains as the helpers' ``same_tree`` holds
   them; the forced splits are the tree's first nodes unless the preamble
   aborted.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.split import SplitParams as JaxSplitParams
from lightgbm_tpu.ops.split import gather_info_for_threshold as jax_gather
from lightgbm_tpu_torch.ops import split as tsplit
from torch_forced_cegb_helpers import check_forced, dyadic_hist, one_torch_thread  # noqa: F401


@pytest.mark.parametrize("missing,thr,is_cat", [
    (0, 7, False), (1, 0, False), (1, 3, False), (2, 12, False), (2, 40, False),
    (0, 3, True), (2, 15, True), (0, 16, True)])
def test_gather_info_matches_jax(missing, thr, is_cat):
    rng = np.random.RandomState(thr + 10 * missing)
    B, num_bin, default_bin = 20, 16, 2
    h = dyadic_hist(rng, 1, B)[0]
    sg, sh, n = (np.float32(v) for v in h.sum(axis=0))
    params = (0.0, 1.0, 0.0, 5, 1e-3, 0.5)
    want = jax_gather(jnp.asarray(h), jnp.float32(sg), jnp.float32(sh), jnp.float32(n),
                      jnp.int32(thr), jnp.int32(num_bin), jnp.int32(missing),
                      jnp.int32(default_bin), jnp.asarray(is_cat), JaxSplitParams(*params))
    got = tsplit.gather_info_for_threshold(torch.from_numpy(h), sg, sh, n, thr, num_bin, missing,
                                           default_bin, is_cat, tsplit.SplitParams(*params))
    for name in want._fields:
        if name == "feature":
            continue
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        np.testing.assert_array_equal(b, a, err_msg=name)


#: (forced, CEGB, pool slots, categorical, bag), as tests/torch_forced_cegb_helpers.py says
FORCED_CASES = {
    "forced_bfs": ([(0, 0, 30), (0, 1, 10), (1, 2, 20)], None, None, False, False),
    "forced_abort_invalid": ([(0, 0, 30), (0, 5, 20), (1, 1, 10)], None, None, False, False),
}


@pytest.mark.parametrize("case", sorted(FORCED_CASES))
def test_grow_matches_jax(case):
    check_forced(case, FORCED_CASES[case])
