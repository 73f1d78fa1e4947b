"""The grid of csrc/histogram.cu (``hist_kernel.histogram_grid``) and a numpy
mirror of the kernel's decomposition, against the JAX package's
``histogram_reference``.

The kernel runs only on the card; what it does with the grid does not: a
block owns one group of 4 features and one chunk of rows, takes its chunk
1024 rows a step (thread t the rows base + t + 256 j, j < 4), and flushes
its sub-histogram with plain stores when the grid has one chunk and with
adds otherwise. The mirror does the same in numpy. Dyadic values (multiples
of 1/64 with small exponents) sum exactly in every order, so the mirror must
equal the reference bit for bit.
"""
import re

import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.histogram import histogram_reference
from lightgbm_tpu_torch.ops import cuda_build, hist_kernel
from lightgbm_tpu_torch.ops import histogram as thist

SIZES = sorted(
    {1, 2, 3, 5, 255, 256, 257, 1023, 1024, 1025, 4097, 4488, 65535, 65536, 65537, 100_000,
     131_073, 1_000_000, 3_000_000}
    | {k * 1024 + d for k in (2, 13, 14, 64) for d in (-1, 0, 1)}
)


@pytest.mark.parametrize("F", [1, 5, 28, 29])
@pytest.mark.parametrize("num_sms", [1, 132])
def test_grid_covers_every_row_once(F, num_sms):
    """Chunks of the grid tile 0..n exactly, none empty; the grid fits in a
    1-D launch; a chunk is a multiple of 1024 rows within [1024, 65536]."""
    for n in SIZES:
        groups, chunks, rpb = hist_kernel.histogram_grid(n, F, num_sms)
        assert groups == -(-F // 4)
        assert rpb % hist_kernel.HIST_STEP == 0 and 1024 <= rpb <= 65536, (n, rpb)
        assert (chunks - 1) * rpb < n <= chunks * rpb, (n, chunks, rpb)  # last chunk not empty
        assert groups * chunks < 2 ** 31
        # about four blocks per SM, unless the chunk is at its floor or cap
        if 1024 < rpb < 65536:
            assert groups * chunks <= 4 * num_sms + groups, (n, groups, chunks)


def test_grid_worked_numbers():
    """The sizes of one tree at 1M x 28 on a 132-SM card."""
    assert hist_kernel.histogram_grid(4488, 28, 132) == (7, 5, 1024)
    assert hist_kernel.histogram_grid(100_000, 28, 132) == (7, 49, 2048)
    assert hist_kernel.histogram_grid(1_000_000, 28, 132) == (7, 76, 13312)


@pytest.mark.parametrize("B", [1, 15, 63, 255, 336])
def test_grid_shared_memory_under_default(B):
    """The byte instantiations' static [kG, kMaxBins, 3] f32 block
    histogram, read from csrc/histogram.cu, fits the 48 KB default, so they
    need no opt-in attribute; every B the wrapper takes on uint8 bins fits
    in it; only the int16 instantiations' dynamic cells (up to 1024 bins)
    raise the limit, once, in one place; the launcher's group and step are
    the kernel's."""
    text = (cuda_build.CSRC / "histogram.cu").read_text()
    c = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    assert "__shared__ float byte_cells[kG * kMaxBins * 3];" in text
    assert text.count("cudaFuncSetAttribute") == 1 and "allow_wide_cells" in text
    assert B <= c["kMaxBins"] and c["kG"] * c["kMaxBins"] * 3 * 4 <= 48 * 1024
    assert c["kMaxBins"] == hist_kernel.MAX_BYTE_BINS
    assert c["kMaxWideBins"] == hist_kernel.MAX_WIDE_BINS
    assert c["kG"] * c["kMaxWideBins"] * 3 * 4 <= 227 * 1024
    assert hist_kernel.HIST_GROUP == c["kG"]
    assert hist_kernel.HIST_STEP == c["kThreads"] * c["kRows"]


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("n", [1, 700, 1024, 1025, 3000, 9999])
def test_block_steps_cover_chunk(n, grouped):
    """Inside a chunk, each thread's step loop covers each row once: the
    plain form's thread t steps while its own row base + t is in the chunk;
    the grouped form's while its warp's first row is (every lane of a warp
    takes every step), its rows past the chunk masked."""
    _, chunks, rpb = hist_kernel.histogram_grid(n, 28, 132)
    seen = np.zeros(n, np.int64)
    for c in range(chunks):
        begin, end = c * rpb, min((c + 1) * rpb, n)
        for t in range(256):
            lane = t & 31
            wbase = begin + (t - lane if grouped else t)
            while wbase < end:
                base = wbase + lane if grouped else wbase
                for j in range(4):
                    if base + 256 * j < end:
                        seen[base + 256 * j] += 1
                wbase += 1024
    assert (seen == 1).all()


def _crowded(share, num_bin, n=4096):
    """An n-row column of ``num_bin`` bins: bin 0 holds ``share`` of the
    rows, the rest spread evenly."""
    rest = np.arange(n) % (num_bin - 1) + 1 if num_bin > 1 else np.zeros(n, np.int64)
    col = np.where(np.arange(n) < int(share * n), 0, rest)
    return np.random.RandomState(0).permutation(col).astype(np.uint8)


@pytest.mark.parametrize("share, num_bin, want", [
    (1 / 255, 255, False),  # spread bins: chance 1/255
    (0.5, 2, True),  # a one-hot column at 1/2: chance 1/2
    (0.97, 2, True),  # a sparse one-hot column
    (0.25, 4, True),  # 4 even bins: chance exactly 1/4
    (0.2, 5, False),  # 5 even bins: 1/5
    (0.55, 255, True),  # one bin of 255 holding 55%: chance about 0.30
    (0.4, 255, False),  # 40%: chance about 0.16
])
def test_grouped_adds_picks_crowded_tables(share, num_bin, want):
    """``grouped_adds`` sends a table to the grouped form when some
    feature's two random rows share a bin with a chance of at least 1/4,
    whatever the other features."""
    spread = np.stack([_crowded(1 / 255, 255) for _ in range(3)])
    table = np.concatenate([spread, _crowded(share, num_bin)[None]])
    assert hist_kernel.grouped_adds(table) is want
    assert hist_kernel.grouped_adds(spread) is False


def mirror(bins, vals, B, rows, num_sms):
    """The kernel's decomposition in numpy: groups x chunks blocks, each
    summing its cells, then a store per cell (one chunk) or an add (more)."""
    F, N = bins.shape
    idx = np.arange(N) if rows is None else rows
    n = len(idx)
    groups, chunks, rpb = hist_kernel.histogram_grid(n, F, num_sms)
    out = np.zeros((F, B, 3), np.float32)
    for block in range(groups * chunks):
        group, chunk = block % groups, block // groups
        f0 = group * hist_kernel.HIST_GROUP
        nf = min(hist_kernel.HIST_GROUP, F - f0)
        r = idx[chunk * rpb:(chunk + 1) * rpb]
        cells = np.zeros((hist_kernel.HIST_GROUP, B, 3), np.float32)
        for g in range(nf):
            b = bins[f0 + g, r].astype(np.int64)
            keep = b < B
            np.add.at(cells[g], b[keep], vals[r][keep])
        if chunks == 1:
            out[f0:f0 + nf] = cells[:nf]
        else:
            nz = cells[:nf] != 0
            out[f0:f0 + nf][nz] += cells[:nf][nz]
    return out


def _dyadic(seed, F, N, B):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (F, N)).astype(np.uint8)
    vals = thist.leaf_values(
        torch.tensor(rng.randint(-64, 65, N) / 64.0, dtype=torch.float32),
        torch.tensor(rng.randint(1, 65, N) / 64.0, dtype=torch.float32),
        torch.from_numpy((rng.rand(N) > 0.3).astype(np.float32)),
    ).numpy()
    return bins, vals


@pytest.mark.parametrize("B", [15, 63, 255])
@pytest.mark.parametrize("segment", [False, True])
@pytest.mark.parametrize("n,num_sms", [(700, 132), (5003, 132), (5003, 1)])
def test_mirror_matches_reference(B, segment, n, num_sms):
    """One chunk (store flush) and several (add flush), F = 29 (a ragged last
    group), whole and on a sorted segment."""
    F = 29
    N = n + 301 if segment else n
    bins, vals = _dyadic(B + n, F, N, B)
    rows = np.sort(np.random.RandomState(n).permutation(N)[:n]).astype(np.int32) if segment else None
    got = mirror(bins, vals, B, rows, num_sms)
    want = histogram_reference(bins if rows is None else bins[:, rows],
                               vals if rows is None else vals[rows], B)
    np.testing.assert_array_equal(got, want)
    # the wrapper on CPU tensors (its plain version) agrees too
    port = hist_kernel.histogram(
        torch.from_numpy(bins), torch.from_numpy(vals), B,
        rows=None if rows is None else torch.from_numpy(rows),
    ).numpy()
    np.testing.assert_array_equal(port, want)
