"""CEGB's three penalties together in the port's device loop, on the CPU,
against the JAX ``grow_tree`` (tests/test_torch_cegb.py's bitwise tier,
tests/torch_forced_cegb_helpers.py ``grow_pair``): three trees in a row
carrying one CEGB state on dyadic gradients,

 * with a bag (the lazy counts and paid rows are the bag's), at penalties
   under which the first tree does not split and the later ones do;
 * with a forced split on a table with categorical features;

every TreeArrays field, the per-row leaf, the paid features and the paid
rows equal after each tree. A file of its own so that each file of the CEGB
cases stays under a minute.
"""
import pytest

from torch_forced_cegb_helpers import grow_pair, one_torch_thread  # noqa: F401

#: (forced, (tradeoff, penalty_split, coupled, lazy), pool slots, categorical, bag)
CASES = {
    "combined_bag": ((), (2.0, 0.001, [0.6] * 6, [0.0015] * 6), None, False, True),
    "forced_categorical": ([(0, 5, 2)], (1.0, 0.003, [1.5] * 6, [0.004] * 6), None, True, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_grow_matches_jax(case):
    got, _ = grow_pair(CASES[case], 3)
    assert int(got.num_leaves) > 3, (case, int(got.num_leaves))
