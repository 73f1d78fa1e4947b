"""The device-resident split loop (lightgbm_tpu_torch/ops/grow.py
``grow_tree_device``), run on the CPU through its kernels' plain versions,
against the host loop and its own pieces (the other half of
tests/test_torch_grow_device.py, whose fixtures it takes):

 * Against the host loop (``grow_tree``): every field equal, on dyadic and
   on real-valued gradients, bf16 operands, and a reused state.
 * The stable partition's plain version against a numpy stable partition,
   the steps of a stopped loop, which must change nothing, and the pick's
   stop at zero gain.
 * Which loop a run takes on its route, and the CPU path's launch counts.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import grow_state as gs
from lightgbm_tpu_torch.ops import cuda_graph, hist_kernel, partition_kernel, split_kernel
from lightgbm_tpu_torch.ops.grow import device_loop_routable, grow_tree, grow_tree_device, launch_tree
from lightgbm_tpu_torch.ops.partition import stable_partition
from test_torch_grow_device import PARAMS, _assert_trees_equal, _case, _torch_args


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors (the workers of a
    parallel run share the machine's cores). Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("seed", [0, 11, 12])
@pytest.mark.parametrize("values", ["dyadic", "real"])
@pytest.mark.parametrize("max_depth", [-1, 4])
def test_device_loop_matches_host_loop(seed, values, max_depth):
    bins, meta, grad, hess = _case(seed)
    if values == "real":
        rng = np.random.RandomState(seed + 100)
        grad = rng.randn(len(grad)).astype(np.float32)
        hess = (rng.rand(len(grad)) + 0.01).astype(np.float32)
    args, nf = _torch_args(bins, meta, grad, hess, 31, max_depth)
    want, want_leaf = grow_tree(*args, bins_nf=nf)
    got, got_leaf, state = grow_tree_device(*args, bins_nf=nf)
    _assert_trees_equal(got, got_leaf, want, want_leaf)
    # a second tree on the same state, from other gradients
    args2 = (args[0], -args[1], args[2] * 2) + args[3:]
    want2, want2_leaf = grow_tree(*args2, bins_nf=nf)
    got2, got2_leaf, state2 = grow_tree_device(*args2, bins_nf=nf, state=state)
    assert state2 is state
    _assert_trees_equal(got2, got2_leaf, want2, want2_leaf)
    _assert_trees_equal(got, got_leaf, want, want_leaf)  # the first tree's arrays are its own


def test_device_loop_bf16_operands_match_host_loop(monkeypatch):
    monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")  # scatter would ignore bf16
    bins, meta, grad, hess = _case(3)
    rng = np.random.RandomState(9)
    grad = rng.randn(len(grad)).astype(np.float32)
    args, nf = _torch_args(bins, meta, grad, hess, 15, -1)
    want, want_leaf = grow_tree(*args, bins_nf=nf, hist_dtype="bfloat16", route=None)
    got, got_leaf, _ = grow_tree_device(*args, bins_nf=nf, hist_dtype="bfloat16")
    _assert_trees_equal(got, got_leaf, want, want_leaf)


def test_stopped_loop_steps_change_nothing():
    """Once the best gain is not > 0 the pick clears ACTIVE, and every step
    function then leaves the whole state as it was."""
    bins, meta, grad, hess = _case(7, N=300)
    args, nf = _torch_args(bins, meta, grad, hess, 63, -1, PARAMS[:3] + (20,) + PARAMS[4:])
    (bins_t, g, h, mask, meta_t, M, max_depth, B, params, two_way) = args
    s = gs.GrowState(bins_t.device, bins_t.shape[1], bins_t.shape[0], B, M)
    launch_tree(s, bins_t, g, h, mask, meta_t, max_depth, params, two_way, nf)
    assert int(s.ctl[gs.ACTIVE]) == 0 and int(s.ctl[gs.NUM_LEAVES]) < M
    before = {k: getattr(s, k).clone() for k in gs.GrowState.STATE}
    for step in (partition_kernel.pick_partition, hist_kernel.histogram_segment,
                 lambda st: hist_kernel.histogram_segment(st, 1),
                 lambda st: split_kernel.split_pair_fold(st, 0),
                 lambda st: split_kernel.split_pair_fold(st, 1),
                 lambda st: split_kernel.split_pair_step(st, 2)):
        step(s)
        for k, v in before.items():
            assert torch.equal(getattr(s, k), v), (step, k)


def test_pick_stops_at_zero_gain_and_takes_the_first_maximum():
    bins, meta, grad, hess = _case(0, N=500)
    args, nf = _torch_args(bins, meta, grad, hess, 7, -1)
    bins_t, g, h, mask, meta_t, M, max_depth, B, params, two_way = args
    s = gs.GrowState(bins_t.device, bins_t.shape[1], bins_t.shape[0], B, M)
    s.bind(bins_t, nf.t(), torch.zeros((500, 3)), meta_t, mask, params, two_way, max_depth, "float32")
    s.reset()
    s.best_f[:, 0] = torch.tensor([1.0, 3.0, 3.0, 2.0, 0.0, 0.0, 0.0])
    s.ctl[gs.NUM_LEAVES] = 4
    partition_kernel.pick_partition(s)
    assert int(s.ctl[gs.BEST]) == 1 and int(s.ctl[gs.NEW]) == 4 and int(s.ctl[gs.STEP]) == 1
    s.best_f[:, 0] = torch.tensor([0.0, -1.0, float("-inf"), 0.0, 0.0, 0.0, 0.0])
    partition_kernel.pick_partition(s)
    assert int(s.ctl[gs.ACTIVE]) == 0 and int(s.ctl[gs.STEP]) == 1


def _numpy_partition(order, bins, begin, count, f, thr, dl, meta):
    seg = order[begin:begin + count].copy()
    col = bins[f, seg].astype(np.int64)
    gl = col <= thr
    if meta["missing_type"][f] == 1:
        gl = np.where(col == meta["default_bin"][f], dl, gl)
    elif meta["missing_type"][f] == 2:
        gl = np.where(col == meta["num_bin"][f] - 1, dl, gl)
    out = order.copy()
    out[begin:begin + count] = np.concatenate([seg[gl], seg[~gl]])
    return out, int(gl.sum())


# (begin, count, feature, threshold, default_left): feature 0 (bins 1-8) has
# no missing type, 1 the zero bin, 2 the nan bin (default bin 1, 9 bins)
PARTITION_CASES = {
    "empty_left": (100, 2500, 0, 0, 0),
    "empty_right": (100, 2500, 0, 8, 0),
    "one_row": (777, 1, 0, 4, 0),
    "whole": (0, 5000, 0, 4, 0),
    "mid_tile": (1000, 3100, 0, 3, 0),
    "mid_tile_zero_left": (1500, 2100, 1, 3, 1),
    "mid_tile_zero_right": (1500, 2100, 1, 0, 0),
    "nan_left": (3, 4990, 2, 2, 1),
    "nan_right": (3, 4990, 2, 6, 0),
    "empty": (2000, 0, 0, 4, 0),
}


@pytest.mark.parametrize("case", sorted(PARTITION_CASES))
def test_stable_partition_matches_numpy(case):
    begin, count, f, thr, dl = PARTITION_CASES[case]
    N = 5000
    rng = np.random.RandomState(len(case))
    bins = rng.randint(0, 9, (3, N)).astype(np.uint8)
    bins[0] = rng.randint(1, 9, N)
    meta = {"missing_type": np.array([0, 1, 2]), "default_bin": np.array([0, 1, 1]),
            "num_bin": np.array([9, 9, 9])}
    order = rng.permutation(N).astype(np.int32)
    order[begin:begin + count] = np.sort(order[begin:begin + count])  # a leaf's rows ascend
    want, want_left = _numpy_partition(order, bins, begin, count, f, thr, bool(dl), meta)
    got = torch.from_numpy(order.copy())
    left = stable_partition(got, torch.from_numpy(bins), begin, count, f, thr, dl,
                            {k: torch.from_numpy(v) for k, v in meta.items()})
    assert left == want_left
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "empty_left":
        assert left == 0
    if case == "empty_right":
        assert left == count


def test_device_loop_routable():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    N, B = 100_000, 255
    assert device_loop_routable(N, B, "float32", None, cuda)
    assert not device_loop_routable(N, B, "float32", None, cpu)
    classes = sorted({hist_kernel.rows_bucket(s) for s in hist_kernel.bucket_sizes(N)})
    all_cuda = hist_kernel.HistRoute([((B, 3, "bfloat16", r), "cuda") for r in classes])
    assert device_loop_routable(N, B, "bfloat16", all_cuda, cuda)
    one_off = hist_kernel.HistRoute(
        [((B, 3, "bfloat16", r), "cuda_onehot" if i == 3 else "cuda") for i, r in enumerate(classes)])
    assert not device_loop_routable(N, B, "bfloat16", one_off, cuda)
    # an entry for another width or operand type does not route this run
    assert device_loop_routable(N, B, "float32", one_off, cuda)


def test_gbdt_picks_the_loop_on_the_route(monkeypatch):
    import lightgbm_tpu_torch as tlgb
    from helpers.bench_data import make_higgs_like

    X, y = make_higgs_like(1500, 8, seed=1)
    params = {"objective": "binary", "num_leaves": 7, "max_bin": 31, "verbose": -1}
    default = tlgb.train(dict(params), tlgb.Dataset(X, label=y), 3, device="cpu")
    assert default._gbdt.grow_loop == "host"
    monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")  # the plain version of cuda on the CPU
    forced = tlgb.train(dict(params), tlgb.Dataset(X, label=y), 3, device="cpu")
    assert forced._gbdt.grow_loop == "device"
    assert forced.model_to_string() == default.model_to_string()


def test_cpu_device_loop_launches_no_kernel():
    """On CPU tensors every step runs its plain version: no launch counted."""
    cuda_graph.reset_launches()
    bins, meta, grad, hess = _case(8, N=600)
    args, nf = _torch_args(bins, meta, grad, hess, 7, -1)
    tree, _, _ = grow_tree_device(*args, bins_nf=nf)
    assert int(tree.num_leaves) == 7
    assert not any(cuda_graph.launch_counts().values())


def test_bench_prints_one_line_on_the_cpu(capsys):
    """``python -m lightgbm_tpu_torch.bench`` at a tiny size on the CPU: one
    JSON line with bench.py's keys, every booster timed, the same model."""
    import json
    import statistics

    from lightgbm_tpu_torch import bench

    assert bench.main(["--device", "cpu", "--rows", "1500", "--iters", "1", "--pairs", "1",
                       "--warmup", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert {"metric", "value", "unit", "vs_baseline"} <= set(line)
    assert line["value"] > 0 and line["device"] == "cpu"
    assert len(line["turns"]["device"]) == len(line["turns"]["host"]) == 2
    assert line["auc"]["device"] == line["auc"]["host"]
    assert len(line["turns"]["graph"]) == len(line["turns"]["chunk"]) == 2
    assert line["auc"]["graph"] == line["auc"]["chunk"] == line["auc"]["host"]
    assert line["value"] == statistics.median(line["turns"]["graph"])
