"""csrc/hist_packed4.cu's contract on the CPU: its plain version, its grid and
a numpy mirror of its decomposition.

 * ``leaf_histogram_packed4_rows`` (the plain version, which the wrapper
   runs for CPU tensors) equals ``leaf_histogram`` on the unpacked bins bit
   for bit on real values: it unpacks each row's nibble and sums in the
   same row order (over all 16 nibbles, cut to B: a nibble >= B adds
   nothing). Rows None and rows, odd N, odd row indices, empty rows,
   B in {1, 2, 15, 16} with nibbles >= B, pack4's ``[F, N2]`` layout and the
   ``pack_bins`` set-up copy's ``[N2, F]`` one, f32 and bf16 operands.
 * ``packed4_grid`` tiles 0..n exactly with chunks of a multiple of 512
   rows, none empty, in one wave of two blocks an SM where the chunk is not
   at its floor or cap.
 * The kernel runs only on the card; what it does with the grid does not.
   The mirror does it in numpy f32: a block owns 4 features and a chunk of
   rows; each of its 128 threads adds 4 rows a step (2 row pairs when the
   rows are 0..n-1) into its own [4, 16, 3] copy; warp w reduces cells
   c = w (mod 4), lane l adding copies l, l+32, l+64, l+96 in that order
   and the lanes then summed by 5 xor-shuffle rounds; the block stores its
   cells (one chunk) or adds the non-zero ones (more). On dyadic values
   every order is exact, so the mirror equals ``histogram_reference``.
"""
import re

import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.histogram import histogram_reference
from lightgbm_tpu_torch.ops import cuda_build
from lightgbm_tpu_torch.ops import hist_kernel as hk
from lightgbm_tpu_torch.ops.histogram import (
    leaf_histogram, leaf_histogram_packed4_rows, leaf_values, operands,
)

# the row counts tests/test_torch_hist_grid.py tiles
SIZES = sorted(
    {1, 2, 3, 5, 255, 256, 257, 1023, 1024, 1025, 4097, 4488, 65535, 65536, 65537, 100_000,
     131_073, 1_000_000, 3_000_000}
    | {k * 1024 + d for k in (2, 13, 14, 64) for d in (-1, 0, 1)}
)


def _real(seed, F, N, B):
    """Bins up to 15 (nibbles >= B where B < 16) and real-valued rows."""
    rng = np.random.RandomState(seed)
    bins = torch.from_numpy(rng.randint(0, 16, (F, N)).astype(np.uint8))
    vals = leaf_values(torch.from_numpy(rng.randn(N).astype(np.float32)),
                       torch.from_numpy(rng.rand(N).astype(np.float32)),
                       torch.from_numpy(rng.rand(N) > 0.3))
    return bins, vals, rng


def _layouts(bins):
    """The same packed bytes as pack4's [F, N2] and as the set-up copy's
    [N2, F] (viewed [F, N2])."""
    return {"pack4": hk.pack4(bins, torch.zeros((bins.shape[1], 3)))[0],
            "setup": hk.pack_bins(bins.t()).t()}


@pytest.mark.parametrize("B", [1, 2, 15, 16])
@pytest.mark.parametrize("N", [1, 2, 777, 1000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_rows_version_equals_leaf_histogram(B, N, dtype):
    bins, vals, rng = _real(B * 1000 + N, 5, N, B)
    segments = {
        "all": None,
        "empty": torch.zeros(0, dtype=torch.int32),
        "sorted": torch.from_numpy(np.sort(rng.permutation(N)[: max(N // 3, 1)]).astype(np.int32)),
        "odd": torch.arange(1, N, 2, dtype=torch.int32),
        "unsorted": torch.from_numpy(rng.randint(0, N, 2 * N + 1).astype(np.int32)),
    }
    for name, packed in _layouts(bins).items():
        assert packed.shape == (5, (N + 1) // 2)
        for seg, rows in segments.items():
            # a nibble >= B adds nothing: the histogram over all 16, cut to B
            want = leaf_histogram(bins, vals, 16, rows, dtype)[:, :B]
            if B == 16:
                assert torch.equal(want, leaf_histogram(bins, vals, B, rows, dtype))
            got = leaf_histogram_packed4_rows(packed, vals, B, rows, dtype)
            assert torch.equal(got, want), (name, seg)
            # the wrapper runs the plain version on CPU tensors
            assert torch.equal(hk.hist_packed4_rows(packed, vals, B, rows, dtype), want), (name, seg)
    # the packed form: [N2, 6] values are [2 N2, 3] rows, the padding row adding 0
    bp, vp = hk.pack4(bins, vals)
    assert torch.equal(hk.hist_packed4(bp, vp, B, dtype),
                       leaf_histogram(bins, vals, 16, None, dtype)[:, :B])


def test_wrapper_refuses_what_the_kernel_does_not_take():
    packed = hk.pack_bins(torch.zeros((6, 3), dtype=torch.uint8)).t()
    with pytest.raises(ValueError, match=r"\[N2, 6\]"):
        hk.hist_packed4(packed, torch.zeros((3, 3)), 15)


@pytest.mark.parametrize("F", [1, 5, 28, 29])
@pytest.mark.parametrize("num_sms", [1, 132])
def test_grid_covers_every_row_once(F, num_sms):
    for n in SIZES:
        groups, chunks, rpb = hk.packed4_grid(n, F, num_sms)
        assert groups == -(-F // 4)
        assert rpb % hk.P4_STEP == 0 and 512 <= rpb <= 65536, (n, rpb)
        assert (chunks - 1) * rpb < n <= chunks * rpb, (n, chunks, rpb)  # last chunk not empty
        assert groups * chunks < 2 ** 31
        # one wave of two 96 KB blocks an SM, unless the chunk is at its cap
        if rpb < 65536 and groups <= 2 * num_sms:
            assert groups * chunks <= 2 * num_sms, (n, groups, chunks)


def test_grid_worked_numbers():
    """The root and a 100k segment at 1M x 28 on a 132-SM card."""
    assert hk.packed4_grid(1_000_000, 28, 132) == (7, 37, 27136)
    assert hk.packed4_grid(100_000, 28, 132) == (7, 33, 3072)
    assert hk.packed4_grid(256, 28, 132) == (7, 1, 512)


def test_source_matches_the_launcher():
    """The kernel's block constants, read from csrc/hist_packed4.cu, are the
    launcher's; its per-thread copies fill 96 KB, two blocks fit an SM's 228
    KB, and the only atomic is the flush's global add."""
    text = (cuda_build.CSRC / "hist_packed4.cu").read_text()
    c = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    assert hk.P4_GROUP == c["kG"] and hk.P4_STEP == c["kThreads"] * c["kRows"]
    smem = c["kG"] * c["kSlots"] * 3 * c["kThreads"] * 4
    assert smem == 96 * 1024 and 2 * (smem + 1024) <= 228 * 1024
    assert text.count("atomicAdd(") == 1 and "atomicAdd(o + c, " in text  # o: the output
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in text


def mirror(packed, vals, B, rows, num_sms):
    """csrc/hist_packed4.cu's decomposition in numpy f32 (module docstring)."""
    F, _ = packed.shape
    n = len(vals) if rows is None else len(rows)
    groups, chunks, rpb = hk.packed4_grid(n, F, num_sms)
    out = np.zeros((F, B, 3), np.float32)
    t = np.arange(128)
    for block in range(groups * chunks):
        group, chunk = block % groups, block // groups
        f0 = group * 4
        nf = min(4, F - f0)
        cells = np.zeros((128, 4, 16, 3), np.float32)  # a copy per thread
        begin, end = chunk * rpb, min((chunk + 1) * rpb, n)

        def add(thread, r):  # rows r of the threads ``thread``, one each
            for g in range(4):
                b = (packed[f0 + g, r >> 1] >> ((r & 1) * 4)) & 15 if g < nf else 0 * r
                cells[thread, g, b] += vals[r]

        if rows is None:  # row pairs: thread t takes pairs j0 + t + 128 q
            for j0 in range(begin // 2, (end + 1) // 2, 256):
                for q in range(2):
                    for half in range(2):
                        r = 2 * (j0 + t + 128 * q) + half
                        ok = r < end
                        add(t[ok], r[ok])
        else:  # single rows: thread t takes rows i0 + t + 128 jj
            for i0 in range(begin, end, 512):
                for jj in range(4):
                    i = i0 + t + 128 * jj
                    ok = i < end
                    add(t[ok], rows[i[ok]])
        copies = cells.reshape(128, -1)
        for c in range(nf * B * 3):  # cell c of the group's [nf, B, 3]
            g, rem = divmod(c, B * 3)
            x = copies[:, g * 48 + rem]
            lanes = ((x[:32] + x[32:64]) + x[64:96]) + x[96:]
            for m in (16, 8, 4, 2, 1):
                lanes = lanes + lanes[np.arange(32) ^ m]
            assert (lanes == lanes[0]).all()  # every lane holds the same sum
            cell = out[f0:f0 + nf].reshape(-1)
            if chunks == 1:
                cell[c] = lanes[0]
            elif lanes[0] != 0:
                cell[c] += lanes[0]
    return out


@pytest.mark.parametrize("B", [1, 2, 15, 16])
@pytest.mark.parametrize("segment", [False, True])
@pytest.mark.parametrize("n,num_sms", [(701, 1), (3001, 132)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mirror_matches_reference(B, segment, n, num_sms, dtype):
    """One chunk (store flush) and several (add flush), F = 5 (a ragged last
    group), odd n, on the set-up copy and a segment with odd row indices."""
    F = 5
    N = n + 300 if segment else n
    rng = np.random.RandomState(B + n)
    bins = rng.randint(0, 16, (F, N)).astype(np.uint8)  # nibbles >= B add nothing
    vals = leaf_values(
        torch.tensor(rng.randint(-1024, 1025, N) / 1024.0, dtype=torch.float32),
        torch.tensor(rng.randint(1, 65, N) / 1024.0, dtype=torch.float32),
        torch.from_numpy((rng.rand(N) > 0.3).astype(np.float32)),
    )
    vals = operands(vals, dtype).numpy()
    rows = np.sort(rng.permutation(N)[:n]).astype(np.int32) if segment else None
    if segment:
        assert (rows % 2).any() and not (rows % 2).all()
    packed = hk.pack_bins(torch.from_numpy(np.ascontiguousarray(bins.T))).t().numpy()
    got = mirror(packed, vals, B, rows, num_sms)
    sel = slice(None) if rows is None else rows
    # a nibble >= B adds nothing: the reference over all 16 nibbles, cut to B
    want = histogram_reference(bins[:, sel], vals[sel], 16)[:, :B]
    np.testing.assert_array_equal(got, want)
