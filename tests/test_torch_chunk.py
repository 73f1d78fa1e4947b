"""Device-resident chunked boosting of the port (GBDT.train_chunk,
``device_chunk_size`` > 1) on the CPU, where the device loop runs its
kernels' plain versions (LIGHTGBM_TPU_HIST_IMPL=cuda forces it) and the
chunk's iterations run eagerly, with the device finish, the stop flag and
the ring readback of the captured iteration on CUDA.

 * chunk 2 and 4 against chunk 1: model text before ``parameters:`` and the
   train scores byte-equal, with no fallback reason; also across a stop in
   the middle of a chunk (the reference suite's configuration:
   min_gain_to_split=18, seed 6, 24 rounds), which must really stop, with
   chunks of 3 one iteration before the end of a chunk;
 * chunk 4 against the JAX package's ``device_chunk_size=4`` training of
   the same data, under tests/test_torch_train.py's rule: the same trees
   unless a split is an f32 near-tie, leaf values and raw scores within
   rtol 1e-4 / atol 1e-5;
 * the engine steps by the reference's boundaries (first iteration alone,
   whole chunks, a per-iteration tail), and a run on the host split loop
   names its fallback reason and trains chunk-1 trees.

Sizes are those of tests/test_device_chunk.py (500 x 5, num_leaves 6,
min_data_in_leaf 5); the JAX trainings are shared through module fixtures.
"""
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.ops import hist_kernel
from test_device_chunk import _boundaries

N_ROWS, N_FEAT, ROUNDS = 500, 5, 9
BINARY = {"objective": "binary", "num_leaves": 6, "min_data_in_leaf": 5, "verbosity": -1}
STOP = dict(BINARY, min_gain_to_split=18.0)


@pytest.fixture(autouse=True)
def device_loop(monkeypatch):
    """The device loop on the CPU: the cuda impl forced (its plain version)."""
    monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda")


def _data(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(N_ROWS, N_FEAT)
    return X, (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)


def _train(params, X, y, chunk, rounds):
    return tlgb.train(dict(params, device_chunk_size=chunk), tlgb.Dataset(X, label=y), rounds,
                      device="cpu")


def _trees_text(bst):
    return bst.model_to_string().split("parameters:")[0]


def _assert_bitwise(params, chunks, rounds, seed):
    X, y = _data(seed)
    ref = _train(params, X, y, 1, rounds)
    assert ref._gbdt.grow_loop == "device"
    for c in chunks:
        got = _train(params, X, y, c, rounds)
        assert got._gbdt.device_chunk_fallback_reason() is None
        assert got.num_trees() == ref.num_trees(), c
        assert _trees_text(got) == _trees_text(ref), "chunk=%d trees differ" % c
        assert got._gbdt.train_score().tobytes() == ref._gbdt.train_score().tobytes(), c
    return ref


@pytest.mark.parametrize("seed", [0, 3])
def test_chunks_2_4_equal_chunk_1(seed):
    _assert_bitwise(BINARY, (2, 4), ROUNDS, seed)


def test_stop_mid_chunk_equals_chunk_1():
    """The gain threshold stops training inside a chunk: the chunked run
    keeps the trees up to the stop, and the scores took exact zeros from
    the iterations the chunk ran after it."""
    ref = _assert_bitwise(STOP, (3, 4), 24, 6)
    assert 1 <= ref.num_trees() < 24, "the configuration no longer stops mid-training"
    # with chunks of 3 the iteration that does not split is followed by
    # another of its chunk
    stop = ref.num_trees() + 1
    edges = [0] + _boundaries(24, 3)
    assert any(b - a == 3 and a < stop < b for a, b in zip(edges, edges[1:])), stop


def test_stopped_chunk_scores_equal_kept_trees():
    X, y = _data(6)
    bst = _train(STOP, X, y, 3, 24)
    np.testing.assert_allclose(bst.predict(X, raw_score=True), bst._gbdt.train_score(),
                               rtol=1e-6, atol=1e-6)
    assert bst.update_chunk(4) == (0, True)


@pytest.fixture(scope="module")
def against_jax():
    X, y = _data(0)
    p = dict(BINARY, device_chunk_size=4)
    jb = jlgb.train(dict(p), jlgb.Dataset(X, label=y), ROUNDS)
    mp = pytest.MonkeyPatch()
    mp.setattr(hist_kernel, "_ENV_IMPL", "cuda")
    try:
        tb = _train(BINARY, X, y, 4, ROUNDS)
    finally:
        mp.undo()
    return X, jb, tb


def test_chunk_4_agrees_with_jax_chunk_4(against_jax):
    """tests/test_torch_train.py's rule for real-valued data."""
    X, jb, tb = against_jax
    assert jb._gbdt.device_chunk_fallback_reason() is None
    assert tb._gbdt.device_chunk_fallback_reason() is None
    jt, tt = jb._gbdt.trees(), tb._gbdt.trees()
    assert len(jt) == len(tt) == ROUNDS
    for a, b in zip(jt, tt):
        same = (
            a.num_leaves == b.num_leaves
            and np.array_equal(a.split_feature, b.split_feature)
            and np.array_equal(a.threshold_bin, b.threshold_bin)
            and np.array_equal(a.left_child, b.left_child)
        )
        if not same:
            # a near-tie: the first differing node's gains agree to f32 rounding
            k = int(np.argmax(a.split_feature != b.split_feature))
            np.testing.assert_allclose(b.split_gain[k], a.split_gain[k], rtol=1e-5)
            return
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(b.split_gain, a.split_gain, rtol=1e-4)
    np.testing.assert_allclose(
        tb.predict(X, raw_score=True), jb.predict(X, raw_score=True), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        tb._gbdt.train_score(), np.asarray(jb._gbdt.scores)[0], rtol=1e-4, atol=1e-5
    )


@pytest.mark.parametrize("total,chunk", [(9, 4), (8, 4), (3, 4), (12, 3), (5, 1)])
def test_engine_steps_by_the_reference_boundaries(monkeypatch, total, chunk):
    """The iteration count after each of ``train``'s own update /
    update_chunk calls (not update_chunk's call of update)."""
    steps, kinds, depth = [], [], [0]

    def record(kind, fn):
        def call(self, *args, **kwargs):
            depth[0] += 1
            try:
                out = fn(self, *args, **kwargs)
            finally:
                depth[0] -= 1
            if not depth[0]:
                steps.append(self.current_iteration)
                kinds.append(kind)
            return out
        return call

    monkeypatch.setattr(tlgb.Booster, "update", record("update", tlgb.Booster.update))
    monkeypatch.setattr(tlgb.Booster, "update_chunk", record("chunk", tlgb.Booster.update_chunk))
    X, y = _data(1)
    bst = _train(BINARY, X, y, chunk, total)
    assert steps == _boundaries(total, chunk)
    assert ("chunk" in kinds) == (1 < chunk <= total)
    assert bst.num_trees() == total


def test_host_loop_falls_back_to_one_iteration_at_a_time(monkeypatch):
    """A route that sends a row class to a kernel the device loop does not
    launch takes the host loop: chunking names why it cannot run, and the
    chunked run trains the trees of chunk 1."""
    monkeypatch.setattr(hist_kernel, "_ENV_IMPL", "cuda_onehot")
    X, y = _data(2)
    ref = _train(BINARY, X, y, 1, 6)
    got = _train(BINARY, X, y, 4, 6)
    assert got._gbdt.grow_loop == "host"
    reason = got._gbdt.device_chunk_fallback_reason()
    assert reason is not None and "host split loop" in reason
    assert got._gbdt.device_chunk() == 1
    assert ref._gbdt.device_chunk_fallback_reason() == "device_chunk_size <= 1"
    assert _trees_text(got) == _trees_text(ref)
    assert got.update_chunk(4)[0] == 1
