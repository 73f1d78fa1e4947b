"""A lone forced root, and forced splits on a table with categorical
features, in the port's device loop, on the CPU, against the JAX
``grow_tree`` (tests/test_torch_forced_cegb.py's bitwise tier,
tests/torch_forced_cegb_helpers.py's pair; a file of its own so that each
file of the forced cases stays under a minute):

 * one forced split, at the root;
 * a forced one-hot split of a categorical feature, then a numerical one.
"""
import pytest

from torch_forced_cegb_helpers import check_forced, one_torch_thread  # noqa: F401

#: (forced, CEGB, pool slots, categorical, bag), as tests/torch_forced_cegb_helpers.py says
CASES = {
    "forced_root": ([(0, 5, 2)], None, None, False, False),
    "forced_categorical": ([(0, 4, 2), (1, 0, 30)], None, None, True, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_grow_matches_jax(case):
    check_forced(case, CASES[case])
