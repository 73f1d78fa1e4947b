"""csrc/hist_v1.cu's contract on the CPU: its grid, its block constants and
the order it sums in.

 * ``v1_grid`` tiles 0..n exactly with chunks of a multiple of 512 rows,
   none empty, in one wave of two blocks an SM where the chunk is not at
   its cap; two blocks' shared memory fits an SM at every B the wrapper
   takes; the launcher's constants are the kernel's.
 * The kernel runs only on the card; the order it sums in does not.
   ``kernel_order`` below walks that order literally in numpy f32: a block
   owns 16 features and a chunk of rows and takes the chunk in tiles of 512
   rows; warp w folds features w and w + 8, 32 rows a step, steps
   ascending; the lanes whose bins match form a peer set, whose lowest lane
   adds its own and then its peers' values to the cell in lane order; a
   lane past the tile or with a bin >= B adds nothing; one chunk stores its
   cells, more store partials that are summed in chunk order from 0. It
   equals ``hist_kernel.hist_v1_mirror`` (the fast mirror that chip_smoke.py
   and the card tests hold the kernel to) bit for bit on real values.
 * The mirror equals the JAX package's ``histogram_reference`` and its
   ``histogram_pallas_v1`` in interpret mode on dyadic values (every order
   exact), and the plain ``leaf_histogram`` on real values where the grid
   has one chunk: that CPU ``index_add_`` adds in row order, as a Python
   loop shows.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import hist_pallas as hp
from lightgbm_tpu.ops.histogram import histogram_reference
from lightgbm_tpu_torch.ops import cuda_build
from lightgbm_tpu_torch.ops import hist_kernel as hk
from lightgbm_tpu_torch.ops.histogram import leaf_histogram, leaf_values, operands

# the row counts tests/test_torch_hist_grid.py tiles, and the tile's edges
SIZES = sorted(
    {1, 2, 3, 5, 255, 256, 257, 511, 512, 513, 1023, 1024, 1025, 4097, 4488, 7680, 65535,
     65536, 65537, 100_000, 131_073, 1_000_000, 3_000_000}
    | {k * 512 + d for k in (2, 15, 98, 131) for d in (-1, 0, 1)}
)


def _source():
    """The .cu's text, and its code with the comments taken out."""
    text = (cuda_build.CSRC / "hist_v1.cu").read_text()
    return text, re.sub(r"//[^\n]*", "", text)


def _constants():
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", _source()[0])}


@pytest.mark.parametrize("F", [1, 5, 16, 17, 28, 29])
@pytest.mark.parametrize("num_sms", [1, 132])
def test_grid_covers_every_row_once(F, num_sms):
    for n in SIZES:
        groups, chunks, rpb = hk.v1_grid(n, F, num_sms)
        assert groups == -(-F // 16)
        assert rpb % hk.V1_TILE == 0 and 512 <= rpb <= 65536, (n, rpb)
        assert (chunks - 1) * rpb < n <= chunks * rpb, (n, chunks, rpb)  # last chunk not empty
        assert groups * chunks < 2 ** 31
        # one wave of two blocks an SM, unless the chunk is at its cap
        if rpb < 65536 and groups <= 2 * num_sms:
            assert groups * chunks <= 2 * num_sms, (n, groups, chunks)


def test_grid_worked_numbers():
    """The root, a 100k segment and 256 rows at 1M x 28 on a 132-SM card."""
    assert hk.v1_grid(1_000_000, 28, 132) == (2, 131, 7680)
    assert hk.v1_grid(100_000, 28, 132) == (2, 98, 1024)
    assert hk.v1_grid(256, 28, 132) == (2, 1, 512)


def test_source_matches_the_launcher():
    """The kernel's group, tile, stage stride and block size, read from
    csrc/hist_v1.cu, are the launcher's; the code has no atomic, matches
    bins with __match_any_sync, stages with cp.async and opts in to more
    than 48 KB of shared memory."""
    c = _constants()
    assert (c["kG"], c["kT"], c["kBinWords"]) == (hk.V1_GROUP, hk.V1_TILE, hk.V1_BIN_WORDS)
    assert c["kThreads"] == 256 and c["kG"] == 2 * c["kThreads"] // 32  # two features a warp
    assert c["kMaxBins"] == 336
    _, code = _source()
    assert "atomic" not in code.lower()
    for needle in ("__match_any_sync", "cp.async", "cudaFuncAttributeMaxDynamicSharedMemorySize"):
        assert needle in code, needle


@pytest.mark.parametrize("B", [1, 2, 15, 63, 255, 336])
def test_shared_memory_fits_two_blocks(B):
    """A block's [16, B, 3] f32 cells and two stages of 512 rows x (5 bin
    words + 3 value words) fit 227 KB, and two blocks (with the 1 KB each
    reserves) fit an SM's 228 KB."""
    c = _constants()
    cells = c["kG"] * B * 3 * 4
    smem = cells + 2 * c["kT"] * (c["kBinWords"] + 3) * 4
    assert smem <= 227 * 1024 and 2 * (smem + 1024) <= 228 * 1024, smem
    if B in (255, 336):
        assert cells == {255: 48_960, 336: 64_512}[B]


def test_stage_stride_spreads_banks():
    """A warp reading one feature's bin byte of 32 consecutive staged rows
    (word 5 i + g / 4 of the stage) hits 32 different banks, and so does one
    reading their 3-word values."""
    for first in range(0, 512, 32):
        i = first + np.arange(32)
        for g in range(16):
            assert len(set((hk.V1_BIN_WORDS * i + g // 4) % 32)) == 32
        for k in range(3):
            assert len(set((3 * i + k) % 32)) == 32


def kernel_order(bins, vals, B, rows, num_sms):
    """csrc/hist_v1.cu's order, step by step, in numpy f32 (module
    docstring). ``vals`` are the operands, already rounded."""
    F = bins.shape[0]
    order = np.arange(bins.shape[1]) if rows is None else rows
    n = len(order)
    groups, chunks, rpb = hk.v1_grid(n, F, num_sms)
    lanes = np.arange(32)
    parts = np.zeros((chunks, F, B, 3), np.float32)
    for block in range(groups * chunks):
        group, chunk = block % groups, block // groups
        f0 = group * 16
        nf = min(16, F - f0)
        cells = parts[chunk, f0:f0 + nf]
        seg = order[chunk * rpb:(chunk + 1) * rpb]
        for t0 in range(0, len(seg), 512):  # a tile, staged once for the group
            tile = seg[t0:t0 + 512]
            stage_b, stage_v = bins[f0:f0 + nf, tile], vals[tile]
            for warp in range(8):
                for g in (warp, warp + 8):
                    if g >= nf:
                        continue
                    for s in range(0, len(tile), 32):
                        ok = s + lanes < len(tile)
                        b = np.zeros(32, np.int64)
                        b[ok] = stage_b[g, s + lanes[ok]]
                        live = ok & (b < B)
                        key = np.where(live, b, 256 + lanes)  # match_any's keys
                        for lane in np.flatnonzero(live):
                            peers = np.flatnonzero(key == key[lane])
                            if peers[0] != lane:  # not the peer set's lowest lane
                                continue
                            c = cells[g, b[lane]]
                            for p in peers:  # its own values, then its peers' in lane order
                                c = c + stage_v[s + p]
                            cells[g, b[lane]] = c
    if chunks == 1:
        return parts[0]
    out = np.zeros((F, B, 3), np.float32)
    for part in parts:
        out = out + part
    return out


def _real(seed, F, N, top):
    """Bins below ``top`` and real-valued rows, some masked out."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, top, (F, N)).astype(np.uint8)
    vals = leaf_values(torch.from_numpy(rng.randn(N).astype(np.float32)),
                       torch.from_numpy(rng.rand(N).astype(np.float32)),
                       torch.from_numpy(rng.rand(N) > 0.3)).numpy()
    return bins, vals, rng


def _segments(rng, N, n):
    return {"all": None,
            "sorted": np.sort(rng.permutation(N)[:n]).astype(np.int32),
            "unsorted": rng.randint(0, N, n).astype(np.int32)}


@pytest.mark.parametrize("F,B", [(1, 2), (17, 63), (29, 15)])
def test_kernel_order_equals_mirror(F, B):
    """Real values, bins >= B among them, three chunks (132 SMs) and one or
    two (1 SM), a ragged tile, rows none / sorted / unsorted with repeats, f32
    and bf16: the literal order equals the mirror bit for bit."""
    N = 1100
    bins, vals, rng = _real(F * 1000 + B, F, N, min(B + 3, 256))
    for name, rows in _segments(rng, N, 1050).items():
        for dtype in ("float32", "bfloat16"):
            ops = operands(torch.from_numpy(vals), dtype).numpy()
            for num_sms in (132, 1):
                want = kernel_order(bins, ops, B, rows, num_sms)
                got = hk.hist_v1_mirror(bins, vals, B, rows, dtype, num_sms)
                np.testing.assert_array_equal(got, want, err_msg="%s %s %d" % (name, dtype, num_sms))
    # one group on one SM takes two chunks, two groups one
    assert hk.v1_grid(1050, F, 132)[1] == 3 and hk.v1_grid(1050, F, 1)[1] == (2 if F <= 16 else 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mirror_dyadic_equals_reference(dtype):
    """Dyadic values (multiples of 2^-10 with small exponents) sum exactly in
    every order: with 10 chunks of 512 rows the mirror equals the JAX
    package's histogram_reference of the rounded values."""
    F, N, B = 29, 5000, 255
    rng = np.random.RandomState(5)
    bins = rng.randint(0, B, (F, N)).astype(np.uint8)
    vals = leaf_values(torch.tensor(rng.randint(-1024, 1025, N) / 1024.0, dtype=torch.float32),
                       torch.tensor(rng.randint(1, 65, N) / 1024.0, dtype=torch.float32),
                       torch.from_numpy(rng.rand(N) > 0.3)).numpy()
    ops = operands(torch.from_numpy(vals), dtype).numpy()
    for rows in _segments(rng, N, 4500).values():
        sel = slice(None) if rows is None else rows
        assert hk.v1_grid(N if rows is None else len(rows), F, 132)[1] >= 9
        np.testing.assert_array_equal(hk.hist_v1_mirror(bins, vals, B, rows, dtype),
                                      histogram_reference(bins[:, sel], ops[sel], B))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mirror_equals_plain_with_one_chunk(dtype):
    """Where the grid has one chunk the kernel's sums are the plain left
    fold in row order, which is what the plain version's CPU index_add_
    gives: bit for bit on real values."""
    F, N, B = 29, 3000, 63
    bins, vals, rng = _real(7, F, N, B)
    for rows in _segments(rng, N, 2900).values():
        n = N if rows is None else len(rows)
        assert hk.v1_grid(n, F, 1)[1] == 1
        want = leaf_histogram(torch.from_numpy(bins), torch.from_numpy(vals), B,
                              None if rows is None else torch.from_numpy(rows), dtype)
        np.testing.assert_array_equal(hk.hist_v1_mirror(bins, vals, B, rows, dtype, 1),
                                      want.numpy())


def test_plain_version_adds_in_row_order():
    """The plain version's index_add_ on the CPU is the left fold of each
    cell's rows in the order of ``rows``: a Python loop gives its bits."""
    F, N, B = 3, 700, 15
    bins, vals, rng = _real(11, F, N, B)
    rows = rng.randint(0, N, 900).astype(np.int32)
    want = np.zeros((F, B, 3), np.float32)
    for r in rows:
        for f in range(F):
            want[f, bins[f, r]] = want[f, bins[f, r]] + vals[r]
    got = leaf_histogram(torch.from_numpy(bins), torch.from_numpy(vals), B, torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B", [15, 63, 255])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mirror_matches_pallas_v1_interpret(B, dtype):
    """The JAX kernel the .cu replaces, in interpret mode, on dyadic values
    (multiples of 2^-6 in f32, 2^-10 in bf16), several chunks of 512 rows."""
    F, N = 5, 1500
    rng = np.random.RandomState(B)
    q = 64 if dtype == "float32" else 1024
    bins = rng.randint(0, B, (F, N)).astype(np.uint8)
    vals = leaf_values(torch.tensor(rng.randint(-q, q + 1, N) / q, dtype=torch.float32),
                       torch.tensor(rng.randint(1, q + 1, N) / q, dtype=torch.float32),
                       torch.from_numpy(rng.rand(N) > 0.3)).numpy()
    want = np.asarray(hp.histogram_pallas_v1(jnp.asarray(bins), jnp.asarray(vals), B, chunk=512,
                                             dtype_name=dtype, interpret=True))
    assert hk.v1_grid(N, F, 132)[1] == 3
    np.testing.assert_array_equal(hk.hist_v1_mirror(bins, vals, B, None, dtype), want)
