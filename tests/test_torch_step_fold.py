"""The device loop's folded split scan and its leaf lookup, on the CPU
through host mirrors of the kernels' block decompositions.

 * ``split_kernel.fold_mirror`` (csrc/split_pair.cu's folded entry: which
   block reads and writes which histogram rows, the scratch buffer of each
   step parity, the clearing of the other) against the plain subtraction
   and split scan (ops/grow_step.py ``split_pair_fold``), step by step over
   whole trees on dyadic gradients (multiples of 1/64, so every histogram
   sum is exact): the whole state equal bit for bit after every step, in
   three block orders, with the smaller child in the parent's slot and in
   the new one, segments of one chunk (stored outright) and of several
   (added into the scratch, as csrc/histogram.cu's segment entry does), and
   a loop that stops early. The tree is held to the JAX package's
   ``grow_tree`` as tests/test_torch_grow_device.py holds it.
 * ``grow_step_kernel.tile_mirror`` (csrc/grow_step.cu's tiles, each
   listing its leaves sorted by begin) against the plain ``leaf_ids``:
   empty leaves, a leaf spanning many tiles, a tile meeting every leaf, and
   N not a multiple of the tile; and the score update's plain version
   against the per-row f32 adds of today's ``add_(value[leaf_ids])``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.grow import grow_tree as jax_grow_tree
from lightgbm_tpu.ops.split import SplitParams as JaxSplitParams
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.ops import grow as grow_mod
from lightgbm_tpu_torch.ops import grow_state as gs
from lightgbm_tpu_torch.ops import grow_step as plain
from lightgbm_tpu_torch.ops import grow_step_kernel, hist_kernel, partition_kernel, split_kernel
from lightgbm_tpu_torch.ops.grow import TreeArrays
from lightgbm_tpu_torch.ops.histogram import leaf_histogram
from lightgbm_tpu_torch.ops.split import SplitParams

# (rows, features, max bin, leaves, min_data_in_leaf); "stops_early" runs
# out of gains before its last leaf
FOLD_CASES = {
    "b15_f6_2k": (2000, 6, 15, 7, 5),
    "b63_f12_5k": (5000, 12, 63, 15, 5),
    "b255_f28_20k": (20_000, 28, 255, 31, 5),
    "stops_early": (5000, 12, 63, 31, 250),
}
SMS = 132  # the H100's: the segment entry chunks a segment of over 1024 rows
JAX_CASES = ("stops_early",)
ORDERS = ("large_first", "small_first", "by_feature")


def _data(N, F, B, seed):
    """Binned features of 3..B bins with missing types none / zero / nan by
    feature, a +1 and a -1 monotone feature, dyadic gradients and hessians."""
    rng = np.random.RandomState(seed)
    num_bin = rng.randint(3, B + 1, F).astype(np.int32)
    num_bin[0] = B
    bins = np.stack([rng.randint(0, nb, N) for nb in num_bin]).astype(np.uint8)
    meta = {"num_bin": num_bin, "missing_type": (np.arange(F) % 3).astype(np.int32),
            "default_bin": rng.randint(0, 3, F).astype(np.int32), "monotone": np.zeros(F, np.int8)}
    meta["monotone"][1], meta["monotone"][2] = 1, -1
    grad = (rng.randint(-64, 65, N) / 64.0).astype(np.float32)
    hess = (rng.randint(1, 65, N) / 64.0).astype(np.float32)
    return bins, meta, grad, hess


def _start(case, seed=0):
    N, F, B, M, min_data = FOLD_CASES[case]
    bins, meta, grad, hess = _data(N, F, B, seed)
    ds = convert.binned_from_numpy(bins, meta)
    params = SplitParams(0.0, 1.0, 0.0, min_data, 1e-3, 0.0)
    args = (torch.from_numpy(ds.bins), torch.from_numpy(grad), torch.from_numpy(hess),
            torch.ones(F, dtype=torch.bool), convert.meta_tensors(ds.feature_meta_arrays()), -1,
            params, True, torch.from_numpy(np.ascontiguousarray(bins.T)))
    s = gs.GrowState(torch.device("cpu"), N, F, B, M)
    grow_mod.start_tree(s, *args)
    return s, args, (bins, meta, grad, hess, params)


def _segment_as_the_kernel(s, parity, num_sms=SMS):
    """csrc/histogram.cu's segment entry on the CPU: the smaller child's
    rows cut into the chunks its grid gives them on ``num_sms`` SMs; one
    chunk stores its histogram into ``small[parity]``, more add theirs in
    one by one (so a scratch left unzeroed shows). Returns the chunks."""
    if not int(s.ctl[gs.ACTIVE]):
        return 0
    leaf = int(s.ctl[gs.SMALL])
    b0, n = int(s.leaf_begin[leaf]), int(s.leaf_count[leaf])
    _, chunks, per = hist_kernel.histogram_grid(n, s.F, num_sms)
    rows = s.order[b0:b0 + n]
    if chunks == 1:
        s.small[parity] = leaf_histogram(s.hist_bins, s.values, s.B, rows, s.hist_dtype)
    for c in range(chunks if chunks > 1 else 0):
        s.small[parity] += leaf_histogram(s.hist_bins, s.values, s.B, rows[c * per:(c + 1) * per],
                                          s.hist_dtype)
    return chunks


def _same_state(a, b, what):
    for k in gs.GrowState.STATE:
        assert torch.equal(getattr(a, k), getattr(b, k)), (what, k)


@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_fold_mirror_grows_the_plain_tree(case):
    """Step by step: the pick and partition, the segment histogram into the
    step's scratch as the kernel chunks it, then the folded scan's mirror
    on the state and the plain subtraction and scan on a copy: every state
    tensor equal, the other scratch cleared, and the whole tree equal to
    launch_tree's."""
    s, args, _ = _start(case)
    want = gs.GrowState(s.device, s.N, s.F, s.B, s.M)
    grow_mod.launch_tree(want, *args)
    seen = {"small_is_best": 0, "small_is_new": 0, "multi_chunk": 0, "one_chunk": 0, "stopped": 0}
    for step in range(s.M - 1):
        parity = step % 2
        partition_kernel.pick_partition(s)
        chunks = _segment_as_the_kernel(s, parity)
        other = s.clone()
        access = split_kernel.fold_mirror(s, parity, ORDERS[step % 3])
        plain.split_pair_fold(other, parity)
        _same_state(s, other, (case, step))
        if not access:
            seen["stopped"] += 1
            continue
        assert not s.small[1 - parity].any(), (case, step)
        small = int(s.ctl[gs.SMALL])
        seen["small_is_best" if small == int(s.ctl[gs.BEST]) else "small_is_new"] += 1
        seen["multi_chunk" if chunks > 1 else "one_chunk"] += 1
        # every (feature, child) block; only the larger child's blocks touch hist
        assert len(access) == 2 * s.F
        assert sum(any(w[0] == "hist" for w in writes) for _, writes in access.values()) == s.F
    _same_state(s, want, case)
    assert torch.equal(grow_step_kernel.leaf_ids(s), grow_step_kernel.leaf_ids(want))
    assert seen["small_is_best"] > 0 and seen["small_is_new"] > 0, seen
    if case == "stops_early":
        assert seen["stopped"] > 0 and 2 < int(s.ctl[gs.NUM_LEAVES]) < s.M, seen
    else:
        assert seen["stopped"] == 0 and int(s.ctl[gs.NUM_LEAVES]) == s.M, seen
    assert seen["one_chunk"] > 0, seen
    if s.N >= 5000:  # a smaller child of over 1024 rows
        assert seen["multi_chunk"] > 0, seen


@pytest.mark.parametrize("case", JAX_CASES)
def test_fold_mirror_tree_matches_jax(case):
    """The tree grown through the mirrors (pick_partition's, the segment's
    chunks, the folded scan's) against the JAX package's grow_tree: every
    field bit for bit but split_gain (rtol 1e-6: XLA contracts the gain's
    multiply-adds, tests/test_torch_split.py), and the leaf index."""
    s, _, (bins, meta, grad, hess, params) = _start(case, seed=3)
    for step in range(s.M - 1):
        partition_kernel.block_mirror(s, 3)
        _segment_as_the_kernel(s, step % 2)
        split_kernel.fold_mirror(s, step % 2, ORDERS[step % 3])
    got = grow_mod.read_tree(s)
    got_leaf = grow_step_kernel.tile_mirror(s)["leaf_id"]
    want, want_leaf = jax_grow_tree(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess), jnp.ones(len(grad), jnp.float32),
        jnp.ones(bins.shape[0], bool), {k: jnp.asarray(v) for k, v in meta.items()},
        num_leaves=s.M, max_depth=-1, num_bins=s.B, params=JaxSplitParams(*params), two_way=True)
    for name in TreeArrays._fields:
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name == "split_gain":
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
    np.testing.assert_array_equal(got_leaf.numpy(), np.asarray(want_leaf))


def test_fold_mirror_checks_its_children_and_stops():
    """A state whose smaller and larger child are not the split's two
    children raises in the mirror; a stopped loop's fold changes nothing;
    the wrapper takes parity 0 or 1 only."""
    s, _, _ = _start("b15_f6_2k")
    partition_kernel.pick_partition(s)
    hist_kernel.histogram_segment(s, 0)
    bad = s.clone()
    bad.ctl[gs.LARGE] = bad.ctl[gs.SMALL]
    with pytest.raises(AssertionError):
        split_kernel.fold_mirror(bad, 0)
    s.ctl[gs.ACTIVE] = 0
    before = s.clone()
    assert split_kernel.fold_mirror(s, 0) == {}
    _same_state(s, before, "stopped")
    with pytest.raises(ValueError):
        split_kernel.split_pair_fold(s, 2)


# ---- the leaf lookup of csrc/grow_step.cu ---------------------------------------


def _layout(counts, seed, reverse=False):
    """A state of len(counts) leaves whose segments tile [0, sum(counts)) in
    leaf order (or in reverse), over a random row order."""
    counts = np.asarray(counts, np.int64)
    N, M = int(counts.sum()), len(counts)
    s = gs.GrowState(torch.device("cpu"), N, 1, 4, M)
    c = counts[::-1] if reverse else counts
    begins = np.concatenate([[0], np.cumsum(c)[:-1]])
    s.leaf_begin.copy_(torch.from_numpy((begins[::-1] if reverse else begins).astype(np.int32)))
    s.leaf_count.copy_(torch.from_numpy(counts.astype(np.int32)))
    s.order.copy_(torch.from_numpy(np.random.RandomState(seed).permutation(N).astype(np.int32)))
    s.ctl[gs.NUM_LEAVES] = M
    return s


T = grow_step_kernel.TILE
LAYOUTS = {  # (each leaf's rows, segments in reverse order of leaf index)
    # empty leaves between and at the ends, N (4096) a multiple of the tile
    "empty_leaves": ([0, 3000, 0, 0, 5, 1091, 0], False),
    # one leaf over many tiles
    "spanning": ([7, 9 * T + 3, 1, 0, 500], True),
    # one tile meets every leaf: 254 one- to three-row leaves, then the rest
    "tile_meets_every_leaf": ([1 + i % 3 for i in range(254)] + [3 * T], False),
    # N not a multiple of the tile: the last tile ragged
    "ragged": ([T - 1, 2, T + 17, 33, 19], False),
    # a single leaf (a tree that did not split)
    "one_leaf": ([5 * T + 7], False),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_tile_mirror_equals_plain_leaf_ids(layout):
    counts, reverse = LAYOUTS[layout]
    s = _layout(counts, len(layout), reverse)
    N = s.N
    got = grow_step_kernel.tile_mirror(s)
    want = plain.leaf_ids(s)
    assert torch.equal(got["leaf_id"], want)
    assert torch.equal(grow_step_kernel.leaf_ids(s), want)  # the wrapper on the CPU: plain
    assert torch.equal(torch.bincount(want, minlength=len(counts)), torch.tensor(counts))
    listed = got["listed"]
    assert len(listed) == -(-N // T)
    nonempty = [l for l, c in enumerate(counts) if c]
    # every tile lists its leaves once, in begin order, and no empty leaf
    for tile in listed:
        assert tile and all(counts[l] for l in tile)
        b = [int(s.leaf_begin[l]) for l in tile]
        assert b == sorted(b) and len(set(tile)) == len(tile)
    assert sorted({l for tile in listed for l in tile}) == nonempty
    if layout == "tile_meets_every_leaf":
        assert listed[0] == nonempty
    if layout == "spanning":
        assert sum(1 in tile for tile in listed) >= 9


@pytest.mark.parametrize("layout", ["grown", "ragged", "empty_leaves"])
def test_score_update_equals_add_of_leaf_values(layout):
    """The score update's plain version, through the wrapper on the CPU,
    against today's ``score.add_(value[leaf_ids])``, and the kernels' two
    passes mirrored (the tile mirror's leaves, then one numpy f32 add a row
    in row order), on real values: bit for bit."""
    if layout == "grown":
        s, args, _ = _start("b63_f12_5k", seed=5)
        grow_mod.launch_tree(s, *args)
    else:
        counts, reverse = LAYOUTS[layout]
        s = _layout(counts, 1, reverse)
    rng = np.random.RandomState(len(layout))
    value = torch.from_numpy(rng.randn(s.M).astype(np.float32))
    score0 = torch.from_numpy(rng.randn(s.N).astype(np.float32) * 3)
    today = score0.clone().add_(value[plain.leaf_ids(s)])
    fused = score0.clone()
    grow_step_kernel.score_update(s, value, fused)
    assert torch.equal(fused, today)
    leaf = grow_step_kernel.tile_mirror(s)["leaf_id"].numpy()
    rows = np.float32(score0.numpy()) + value.numpy()[leaf]  # one f32 add a row
    assert fused.numpy().tobytes() == rows.astype(np.float32).tobytes()
    with pytest.raises(ValueError):
        grow_step_kernel.score_update(s, value[:-1], fused)
    with pytest.raises(ValueError):
        grow_step_kernel.score_update(s, value, fused.double())


def test_kernel_name_of_type_templates():
    """The ptxas report names grow_step.cu's instances by their builtin type
    argument (chip_smoke.py checks the set)."""
    from lightgbm_tpu_torch.ops import cuda_build

    assert cuda_build.kernel_name(
        "_ZN12_GLOBAL__N_116leaf_tile_kernelIxEEvPKiS2_S2_S2_ixPT_") == "leaf_tile_kernel<int64>"
    assert cuda_build.kernel_name(
        "_ZN12_GLOBAL__N_116add_value_kernelIhEEvPKT_PKfxPf") == "add_value_kernel<uint8>"
    assert cuda_build.kernel_name(
        "_ZN12_GLOBAL__N_116leaf_tile_kernelIiEEvPKiS2_S2_S2_ixPT_") == "leaf_tile_kernel<int32>"
    assert cuda_build.kernel_name(
        "_ZN12_GLOBAL__N_117split_pair_kernelILb1ELb1EEEvPfiiPKfS3_") == "split_pair_kernel<1,1>"
