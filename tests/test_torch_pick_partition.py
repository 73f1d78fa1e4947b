"""The split loop's fused step, pick and partition (csrc/partition.cu,
ops/partition_kernel.py ``pick_partition``), on the CPU.

A CUDA kernel does not run here, so its block decomposition is replayed on
the host (``partition_kernel.block_mirror``: each block's contiguous chunk,
its left count, the scan of the block totals that every block makes itself,
and the warp-ballot ranks tile by tile) and held to the plain version
(ops/grow_step.py ``pick``, then ops/partition.py ``partition``) in every
state tensor, at grids of 1, 2, 7 and 264 blocks, on segments of 0 to 100k
rows, for each missing type and both default_left. On CPU tensors the
wrapper runs the plain version, which the device loop's tests hold to the
JAX package's trees (tests/test_torch_grow_device.py).
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import grow as grow_mod
from lightgbm_tpu_torch.ops import grow_state as gs
from lightgbm_tpu_torch.ops import grow_step as grow_step_plain
from lightgbm_tpu_torch.ops import hist_kernel, partition_kernel, split_kernel
from lightgbm_tpu_torch.ops import partition as partition_plain
from lightgbm_tpu_torch.ops.split import SplitParams

PARAMS = SplitParams(0.0, 1.0, 0.0, 5, 1e-3, 0.0)
N = 102_001
BEGIN = 1000  # the picked leaf's segment starts here: rows before and after it stay
GRIDS = (1, 2, 7, 264)
SEGMENTS = (0, 1, 31, 33, 1023, 1025, 100_000)
# feature by missing type: 0 none (bins 1-8), 1 zero (default bin 1), 2 nan (bin 8)
MISSING = {"none": (0, 4), "zero": (1, 3), "nan": (2, 5)}


def _state(count, missing, default_left, seed=0):
    """A CPU state of 4 leaves whose pick is leaf 2 (the one gain > 0), its
    segment ``count`` ascending rows at BEGIN, split on the feature of
    ``missing`` type with ``default_left``."""
    rng = np.random.RandomState(seed)
    bins = torch.from_numpy(rng.randint(0, 9, (3, N)).astype(np.uint8))
    bins[0] = torch.from_numpy(rng.randint(1, 9, N).astype(np.uint8))
    meta = {k: torch.tensor(v, dtype=torch.int32) for k, v in (
        ("num_bin", [9, 9, 9]), ("missing_type", [0, 1, 2]), ("default_bin", [0, 1, 1]),
        ("monotone", [0, 1, -1]))}
    s = gs.GrowState(torch.device("cpu"), N, 3, 9, 4)
    s.bind(bins, bins, torch.zeros((N, 3)), meta, torch.ones(3, dtype=torch.bool), PARAMS, True,
           -1, "float32")
    s.reset()
    order = torch.from_numpy(rng.permutation(N).astype(np.int32))
    order[BEGIN:BEGIN + count] = order[BEGIN:BEGIN + count].sort().values  # a leaf's rows ascend
    s.order.copy_(order)
    f, thr = MISSING[missing]
    s.ctl[gs.NUM_LEAVES], s.ctl[gs.STEP] = 3, 1
    s.leaf_begin[2], s.leaf_count[2] = BEGIN, count
    s.best_i[2] = torch.tensor([f, thr, 0, int(default_left)], dtype=torch.int32)
    s.best_f[2] = torch.tensor([2.5, -1.0, 3.0, 40.0, 1.0, 5.0, 60.0, 0.25, -0.125])
    s.leaf_i[2] = torch.tensor([0, 1], dtype=torch.int32)
    s.laux[2] = torch.tensor([0.0, 8.0, 100.0, -1.0, 1.0])
    s.node_i[0] = torch.tensor([0, 3, -1, -3, 0], dtype=torch.int32)
    return s


def _plain(s):
    grow_step_plain.pick(s)
    partition_plain.partition(s)


def _same_state(a, b, what):
    for k in gs.GrowState.STATE:
        assert torch.equal(getattr(a, k), getattr(b, k)), (what, k)


@pytest.mark.parametrize("default_left", [0, 1])
@pytest.mark.parametrize("missing", sorted(MISSING))
@pytest.mark.parametrize("count", SEGMENTS)
@pytest.mark.parametrize("grid", GRIDS)
def test_block_mirror_matches_plain(grid, count, missing, default_left):
    s = _state(count, missing, default_left, seed=count % 7)
    other = s.clone()
    got = partition_kernel.block_mirror(s, grid)
    _plain(other)
    _same_state(s, other, (grid, count, missing, default_left))
    left = int(other.leaf_count[2])
    assert int(other.ctl[gs.BEST]) == 2 and int(other.ctl[gs.NEW]) == 3
    assert int(other.ctl[gs.LEFT]) == left and int(other.leaf_begin[3]) == BEGIN + left
    # the decomposition: chunks of at least a block's threads, at most grid of them
    chunk, nb = got["chunk"], got["blocks"]
    assert chunk == max(partition_kernel.THREADS, -(-count // grid))
    assert 1 <= nb <= grid and (nb - 1) * chunk < max(count, 1) <= nb * chunk or count == 0
    assert sum(got["block_left"]) == left
    assert got["before"] == [sum(got["block_left"][:b]) for b in range(nb)]
    rows = [max(min(count - b * chunk, chunk), 0) for b in range(nb)]
    assert got["staged"] == ["shared" if n <= partition_kernel.CAP else "scratch" for n in rows]


@pytest.mark.parametrize("why", ["gain_zero", "gain_negative", "last_step"])
def test_pick_partition_stops(why):
    """A best gain not > 0, or M - 1 splits done: ACTIVE is cleared and
    nothing else changes, in the mirror and through the wrapper."""
    s = _state(5000, "zero", 0)
    if why == "last_step":
        s.ctl[gs.STEP] = s.M - 1
    else:
        s.best_f[2, 0] = 0.0 if why == "gain_zero" else -1.0
    before = s.clone()
    mirror = s.clone()
    assert partition_kernel.block_mirror(mirror, 7) == {"stopped": True}
    partition_kernel.pick_partition(s)
    before.ctl[gs.ACTIVE] = 0
    _same_state(s, before, why)
    _same_state(mirror, before, why)
    partition_kernel.pick_partition(s)  # a stopped loop's step changes nothing
    _same_state(s, before, why)


def test_pick_partition_on_the_cpu_is_the_plain_version():
    s = _state(33_333, "none", 0)
    other = s.clone()
    partition_kernel.reset_launches()
    partition_kernel.pick_partition(s)
    _plain(other)
    _same_state(s, other, "cpu")
    assert not any(partition_kernel.launches.values())


def test_pick_partition_raises_on_another_device():
    s = gs.GrowState(torch.device("meta"), 64, 3, 9, 4)
    with pytest.raises(ValueError):
        partition_kernel.pick_partition(s)


@pytest.mark.parametrize("grid", GRIDS)
def test_block_mirror_grows_the_plain_tree(grid):
    """A 63-leaf tree on dyadic gradients, step by step: the mirror's step on
    a copy of the state equals the wrapper's (the plain version) at every
    step, and the tree grown through the mirror equals the plain one."""
    rng = np.random.RandomState(grid)
    n, F, B = 20_000, 4, 31
    bins = torch.from_numpy(rng.randint(0, B, (F, n)).astype(np.uint8))
    meta = {"num_bin": torch.full((F,), B, dtype=torch.int32),
            "missing_type": torch.tensor([0, 1, 2, 0], dtype=torch.int32),
            "default_bin": torch.tensor([0, 2, 0, 0], dtype=torch.int32),
            "monotone": torch.tensor([0, 1, 0, -1], dtype=torch.int32)}
    grad = torch.from_numpy((rng.randint(-64, 65, n) / 64.0).astype(np.float32))
    hess = torch.from_numpy((rng.randint(1, 65, n) / 64.0).astype(np.float32))
    s = gs.GrowState(torch.device("cpu"), n, F, B, 63)
    args = (bins, grad, hess, torch.ones(F, dtype=torch.bool), meta, -1, PARAMS, True)
    grow_mod.launch_tree(s, *args)
    want = s.clone()
    grow_mod.start_tree(s, *args)
    for step in range(s.M - 1):  # launch_tree's steps
        other = s.clone()
        partition_kernel.block_mirror(s, grid)
        partition_kernel.pick_partition(other)
        _same_state(s, other, (grid, step))
        hist_kernel.histogram_segment(s, step % 2)
        split_kernel.split_pair_fold(s, step % 2)
    _same_state(s, want, grid)
    assert int(s.ctl[gs.NUM_LEAVES]) > 10
