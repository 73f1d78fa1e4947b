"""The port's histogram kernel family on the CPU against the JAX package.

Each JAX Pallas kernel (run in interpret mode) is held against the port's
wrapper of its counterpart, which on CPU tensors runs the plain version
(lightgbm_tpu_torch/ops/histogram.py), at B in {15, 63, 255} as the caps
allow and with f32 and bf16 operands:

 * dyadic inputs are equal bit for bit: multiples of 2^-6 in f32, and of
   2^-10 in bf16, so that the bf16 rounding really happens; the sums of
   such values are exact in every order;
 * real-valued f32 inputs agree to rtol 1e-5 / atol 1e-4 (the sums are
   added in other orders); in bf16 both sides are held, within the same
   bound, to the f64 oracle of the bf16-rounded values;
 * the ``rows=`` form equals the JAX kernel on the gathered segment
   (packed4 reads it by row out of a ``pack_bins`` copy, as the grower
   does).

Then the unit mirrors, each equal to the JAX package's: ``pack4`` and
``pack_bins`` (odd N),
``bitplane_split`` for every B in 2..256, the capability table for B in
1..300 through the name map, ``rows_bucket``, ``bucket_sizes`` and
``entries_digest``; and numpy mirrors of csrc/hist_bitplane.cu's exactness
claims, which no CPU run of the kernel can check: its mask-and-shift
factors equal the JAX kernel's AND over bit planes, the three-term bf16
split sums back exactly, masking a packed row pair zeroes exactly the off
rows, and its fragments hold every histogram cell once; and of
csrc/hist_onehot.cu's: the tile count it picks covers B, its bitmap-built
A words equal the compare-built one-hot words, its fragments hold every
cell once, and one warp's row steps, emulated register by register, give
the reference histogram.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.obs import tune as jtune
from lightgbm_tpu.ops import grow as jgrow
from lightgbm_tpu.ops import hist_pallas as hp
from lightgbm_tpu.ops import histogram as jhist
from lightgbm_tpu_torch.obs import tune as ttune
from lightgbm_tpu_torch.ops import hist_kernel as hk
from lightgbm_tpu_torch.ops.histogram import histogram_reference, leaf_values

F, N, ALL = 5, 999, 1500  # F not a multiple of 8, odd N; segments of N out of ALL rows

# (JAX kernel, port wrapper, widths its caps allow)
FAMILY = {
    "fb": (hp.histogram_pallas, hk.histogram, (15, 63, 255)),
    "v1": (hp.histogram_pallas_v1, hk.hist_v1, (15, 63, 255)),
    "onehot": (hp.histogram_pallas_onehot, hk.hist_onehot, (15, 63, 255)),
    "bitplane": (hp.histogram_pallas_bitplane, hk.hist_bitplane, (15, 63, 255)),
    "packed4": (hp.histogram_pallas_packed4, hk.hist_packed4, (15,)),
}
CASES = [(k, b, d) for k, (_, _, bs) in FAMILY.items() for b in bs for d in ("float32", "bfloat16")]


def _inputs(seed, B, dyadic, dtype):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (F, ALL)).astype(np.uint8)
    if dyadic:
        q = 64 if dtype == "float32" else 1024
        g = rng.randint(-q, q + 1, ALL) / q
        h = rng.randint(1, q + 1, ALL) / q
    else:
        g = rng.randn(ALL)
        h = rng.rand(ALL)
    mask = rng.rand(ALL) > 0.3  # rows outside the leaf
    vals = leaf_values(
        torch.tensor(g, dtype=torch.float32), torch.tensor(h, dtype=torch.float32),
        torch.from_numpy(mask),
    ).numpy()
    rows = np.sort(rng.permutation(ALL)[:N]).astype(np.int32)
    return bins, vals, rows


def _jax(kernel, bins, vals, B, dtype):
    if kernel == "packed4":
        bp, vp = hp.pack4(jnp.asarray(bins), jnp.asarray(vals))
        out = hp.histogram_pallas_packed4(bp, vp, B, chunk=512, dtype_name=dtype, interpret=True)
    else:
        out = FAMILY[kernel][0](
            jnp.asarray(bins), jnp.asarray(vals), B, chunk=512, dtype_name=dtype, interpret=True
        )
    return np.asarray(out)


def _port(kernel, bins, vals, B, dtype, rows=None):
    bins_t, vals_t = torch.from_numpy(bins), torch.from_numpy(vals)
    if kernel == "packed4":
        if rows is not None:  # by row from the set-up copy: no gather, no pack4
            packed = hk.pack_bins(bins_t.t())
            return hk.hist_packed4_rows(packed.t(), vals_t, B, torch.from_numpy(rows), dtype).numpy()
        return hk.hist_packed4(*hk.pack4(bins_t, vals_t), B, dtype).numpy()
    rows_t = None if rows is None else torch.from_numpy(rows)
    return FAMILY[kernel][1](bins_t, vals_t, B, rows_t, dtype).numpy()


def _bf16(vals):
    return torch.from_numpy(vals).to(torch.bfloat16).to(torch.float32).numpy()


@pytest.mark.parametrize("kernel,B,dtype", CASES)
def test_kernel_family_matches_jax(kernel, B, dtype):
    bins, vals, rows = _inputs(B + 7, B, True, dtype)
    head = slice(0, N)
    want = _jax(kernel, bins[:, head], vals[head], B, dtype)
    np.testing.assert_array_equal(_port(kernel, bins[:, head], vals[head], B, dtype), want)
    ref = histogram_reference(bins[:, head], _bf16(vals[head]) if dtype == "bfloat16" else vals[head], B)
    np.testing.assert_array_equal(want, ref)
    if dtype == "bfloat16":  # the rounding happened
        assert not np.array_equal(ref, histogram_reference(bins[:, head], vals[head], B))

    # the rows= form against the JAX kernel on the gathered segment
    seg = _jax(kernel, bins[:, rows], vals[rows], B, dtype)
    np.testing.assert_array_equal(_port(kernel, bins, vals, B, dtype, rows), seg)

    # real values: other summation orders
    bins, vals, _ = _inputs(B + 8, B, False, dtype)
    bins, vals = bins[:, head], vals[head]
    ref = histogram_reference(bins, _bf16(vals) if dtype == "bfloat16" else vals, B)
    for got in (_jax(kernel, bins, vals, B, dtype), _port(kernel, bins, vals, B, dtype)):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_routed_dispatch_reaches_each_wrapper():
    """routed_histogram with each impl forced equals the wrapper it names
    (packed4 through pack4, the segment gathered first, and by row from a
    packed copy); the packed copy changes nothing for the other impls."""
    bins, vals, rows = _inputs(3, 15, True, "bfloat16")
    bt, vt, rt = torch.from_numpy(bins), torch.from_numpy(vals), torch.from_numpy(rows)
    packed = hk.pack_bins(bt.t()).t()
    want = hk.hist_v1(bt, vt, 15, rt, "bfloat16")
    for impl in ("cuda", "cuda_onehot", "cuda_bitplane", "cuda_packed4"):
        got = hk.routed_histogram(bt, vt, 15, rows=rt, impl=impl, hist_dtype="bfloat16")
        assert torch.equal(got, want), impl
        got = hk.routed_histogram(bt, vt, 15, rows=rt, impl=impl, hist_dtype="bfloat16",
                                  bins_packed=packed)
        assert torch.equal(got, want), (impl, "packed copy")
    assert torch.equal(hk.hist_packed4_rows(packed, vt, 15, rt, "bfloat16"), want)
    # scatter ignores hist_dtype, as the JAX scatter does
    got = hk.routed_histogram(bt, vt, 15, rows=rt, impl="scatter", hist_dtype="bfloat16")
    assert torch.equal(got, hk.hist_v1(bt, vt, 15, rt, "float32"))


@pytest.mark.parametrize("n", [1, 2, 999, 1000])
def test_pack4_matches_jax(n):
    rng = np.random.RandomState(n)
    bins = rng.randint(0, 16, (3, n)).astype(np.uint8)
    vals = rng.randn(n, 3).astype(np.float32)
    jb, jv = hp.pack4(jnp.asarray(bins), jnp.asarray(vals))
    tb, tv = hk.pack4(torch.from_numpy(bins), torch.from_numpy(vals))
    assert tb.dtype == torch.uint8 and tb.is_contiguous() and tv.is_contiguous()
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the transposed [N, F] layout packs the same
    tb2, _ = hk.pack4(torch.from_numpy(np.ascontiguousarray(bins.T)).t(), torch.from_numpy(vals))
    np.testing.assert_array_equal(tb2.numpy(), np.asarray(jb))
    # the set-up copy, [ceil(N/2), F] row-pair-major, is the same bytes transposed
    tp = hk.pack_bins(torch.from_numpy(np.ascontiguousarray(bins.T)))
    assert tp.dtype == torch.uint8 and tp.is_contiguous() and tp.shape == (-(-n // 2), 3)
    np.testing.assert_array_equal(tp.t().numpy(), np.asarray(jb))


def test_bitplane_split_matches_jax():
    for b in range(2, 257):
        lob, hib = hk.bitplane_split(b)
        assert (lob, hib) == hp.bitplane_split(b), b
        assert lob * hib >= b


def _plane_and_factors(b, lob, hib):
    """The JAX kernel's one-hot factors of bins ``b``, built in numpy with
    the ops ``_kernel_bitplane`` uses: the AND over bit planes of one
    compare each; ``[len(b), lob]`` and ``[len(b), hib]``."""
    lo_bits, hi_bits = lob.bit_length() - 1, hib.bit_length() - 1
    lo_iota = np.arange(lob)[:, None]  # broadcasted_iota (lob, C), axis 0
    hi_iota = np.arange(hib)[None, :]  # broadcasted_iota (C, hib), axis 1
    oh_lo = (lo_iota & 1) == (b & 1)[None, :]
    for p in range(1, lo_bits):
        oh_lo = oh_lo & (((lo_iota >> p) & 1) == ((b >> p) & 1)[None, :])
    oh_hi = (hi_iota & 1) == ((b >> lo_bits) & 1)[:, None]
    for p in range(1, hi_bits):
        oh_hi = oh_hi & (((hi_iota >> p) & 1) == ((b >> (lo_bits + p)) & 1)[:, None])
    return oh_lo.T, oh_hi


def _cuda_plane_split(B):
    """(kLoBits, kHiBits) as lgbt_hist_bitplane (csrc/hist_bitplane.cu)
    picks its template instance: p = max(ceil(log2 B), 2), kLoBits = p / 2."""
    p = max(int(np.ceil(np.log2(B))), 2)
    return p // 2, p - p // 2


@pytest.mark.parametrize("planes", range(2, 9))
def test_bitplane_mask_and_shift_equals_plane_and(planes):
    """For every B whose factors take ``planes`` bit planes and every bin b
    in 0..B-1, the CUDA kernel's factors lo = b & (lob - 1), hi = b >> lo_bits
    equal the JAX kernel's AND over bit planes; a padding row (b = -1)
    matches no H column."""
    widths = [B for B in range(2, 257) if max((B - 1).bit_length(), 2) == planes]
    for B in widths:
        lo_bits, hi_bits = _cuda_plane_split(B)
        lob, hib = hp.bitplane_split(B)
        assert (1 << lo_bits, 1 << hi_bits) == (lob, hib), B
        b = np.arange(B)
        lo, hi = b & (lob - 1), b >> lo_bits
        oh_lo, oh_hi = _plane_and_factors(b, lob, hib)
        np.testing.assert_array_equal(lo[:, None] == np.arange(lob)[None, :], oh_lo)
        np.testing.assert_array_equal(hi[:, None] == np.arange(hib)[None, :], oh_hi)
        assert ((-1 >> lo_bits) == np.arange(hib)).sum() == 0
        assert hi.max() < hib


def _bf16_bits(x):
    """Round f32 to bf16 (RNE, as __float2bfloat16_rn); (bits, value)."""
    t = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16), t.to(torch.float32).numpy()


@pytest.mark.parametrize("kind", ["normal", "wide_exponents", "dyadic"])
def test_three_term_bf16_split_is_exact(kind):
    """t0 = bf16(v), t1 = bf16(v - t0), t2 = bf16(v - t0 - t1): each residual
    is exact in f32 and t0 + t1 + t2 == v, so the f32 operand mode's three
    products add up to the f32 product."""
    rng = np.random.RandomState(7)
    n = 100_000
    if kind == "normal":
        v = rng.randn(n)
    elif kind == "wide_exponents":
        v = np.sign(rng.randn(n)) * rng.rand(n) * 2.0 ** rng.randint(-60, 61, n)
    else:
        v = rng.randint(-2 ** 20, 2 ** 20, n) / 1024.0
    v = v.astype(np.float32)
    x = v.copy()
    total = np.zeros(n, np.float64)
    for _ in range(3):
        _, term = _bf16_bits(x)
        residual = x - term  # f32, as the kernel subtracts
        np.testing.assert_array_equal(residual.astype(np.float64), x.astype(np.float64) - term)
        total += term
        x = residual
    np.testing.assert_array_equal(x, 0.0)
    np.testing.assert_array_equal(total, v.astype(np.float64))


def _pair_mask(x0, x1, want):
    """pair_mask of csrc/hist_bitplane.cu: 0xffff in each half whose row's
    factor equals ``want``."""
    return np.where(x0 == want, 0x0000FFFF, 0).astype(np.uint32) | np.where(
        x1 == want, 0xFFFF0000, 0).astype(np.uint32)


@pytest.mark.parametrize("lo_bits", [1, 2, 3, 4])
def test_masked_pair_word_zeroes_exactly_the_off_rows(lo_bits):
    """A 32-bit word holds rows 2t (low half) and 2t+1 (high half) of one
    bf16 channel; ANDed with the mask of lo == lo_m it keeps exactly the
    rows whose lo matches and zeroes the others (a padding row, b = -1,
    carries value 0). The H word is bf16 1.0 where hi == hi_n."""
    lob = 1 << lo_bits
    rng = np.random.RandomState(lo_bits)
    n = 4096
    bits, _ = _bf16_bits(rng.randn(2 * n))
    b = rng.randint(-1, 2 * lob, 2 * n)  # -1: padding rows
    bits[b < 0] = 0
    word = bits[0::2].astype(np.uint32) | (bits[1::2].astype(np.uint32) << 16)
    lo = b & (lob - 1)
    hi = b >> lo_bits
    for lo_m in [-1] + list(range(lob)):  # -1: A rows at or above lob * 3
        got = word & _pair_mask(lo[0::2], lo[1::2], lo_m)
        on = lo == lo_m
        want = np.where(on, bits, 0).astype(np.uint16)
        np.testing.assert_array_equal((got & 0xFFFF).astype(np.uint16), want[0::2])
        np.testing.assert_array_equal((got >> 16).astype(np.uint16), want[1::2])
    for hi_n in range(8):
        h = _pair_mask(hi[0::2], hi[1::2], hi_n) & 0x3F803F80
        np.testing.assert_array_equal(h & 0xFFFF, np.where(hi[0::2] == hi_n, 0x3F80, 0))
        np.testing.assert_array_equal(h >> 16, np.where(hi[1::2] == hi_n, 0x3F80, 0))


@pytest.mark.parametrize("planes", range(2, 9))
def test_bitplane_fragments_hold_each_cell_once(planes):
    """The kernel's index maps for every B of one template instance: A row
    m = mt*16 + g + 8s reads channel (g + (mt + 2s) % 3) % 3 == m % 3 (the
    hoisted channel offsets), and the accumulator fragments of a warp
    (m16n8k16 C layout) hold every (slot < B, channel) cell exactly once,
    which lets the kernel store them into its shared histogram unzeroed."""
    lo_bits, hi_bits = planes // 2, planes - planes // 2
    lob, hib = 1 << lo_bits, 1 << hi_bits
    m_tiles, n_tiles = -(-lob * 3 // 16), -(-hib // 8)
    for g in range(8):
        for mt in range(m_tiles):
            for s in range(2):
                assert (g + (mt + 2 * s) % 3) % 3 == (mt * 16 + g + 8 * s) % 3
    for B in [B for B in range(2, 257) if max((B - 1).bit_length(), 2) == planes]:
        cells = []
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for mt in range(m_tiles):
                for nt in range(n_tiles):
                    for e in range(4):
                        m, h = mt * 16 + g + 8 * (e >> 1), nt * 8 + 2 * t + (e & 1)
                        if m < lob * 3 and h < hib and h * lob + m // 3 < B:
                            cells.append((h * lob + m // 3, m % 3))
        assert sorted(cells) == [(slot, k) for slot in range(B) for k in range(3)], B


def _onehot_m_tiles(B):
    """kMt as lgbt_hist_onehot (csrc/hist_onehot.cu) picks its template
    instance: ceil(B / 16) rounded up to a power of two."""
    for m_tiles in (1, 2, 4, 8):
        if B <= 16 * m_tiles:
            return m_tiles
    return 16


ONEHOT_M_TILES = (1, 2, 4, 8, 16)
_U32 = 0xFFFFFFFF


def _row_bit(b, g, span):
    """row_bit of csrc/hist_onehot.cu: bit (b - g) >> 3 where e = b - g lies
    in [0, span) and is a multiple of 8, else 0 (uint32 as int64)."""
    e = np.asarray(b, np.int64) - g
    hot = (e & (~(span - 1) | 7)) == 0
    return np.where(hot, np.left_shift(1, np.where(hot, e >> 3, 0)), 0).astype(np.int64)


def _bitmap_words(b0, b1, g, m_tiles):
    """The kernel's bitmap words of a row pair (first row b0, second b1):
    bit j / 16 + j for j < 16, and at kMt = 16 a second word for j >= 16."""
    m0, m1 = _row_bit(b0, g, 16 * m_tiles), _row_bit(b1, g, 16 * m_tiles)
    if m_tiles <= 8:
        return [(m0 | (m1 << 16)) & _U32]
    return [((m0 & 0xFFFF) | (m1 << 16)) & _U32, ((m0 >> 16) | (m1 & 0xFFFF0000)) & _U32]


def _hot_word(q, j):
    """hot_word of csrc/hist_onehot.cu, in its two-instruction form; equal
    to ((q >> j) & 0x00010001) * 0x3f80 for j < 16."""
    if j < 8:
        return ((q & (0x00010001 << j)) * (0x3F80 >> j)) & _U32
    return (((q >> 8) & (0x00010001 << (j - 8))) * (0x3F80 >> (j - 8))) & _U32


def _onehot2(b0, b1, m):
    """The compare-built A word: bf16 1.0 in the half whose row has bin m."""
    return np.where(b0 == m, 0x3F80, 0) | np.where(b1 == m, 0x3F800000, 0)


def test_onehot_m_tiles_cover_each_width():
    """The instance lgbt_hist_onehot picks covers B with the fewest 16-bin
    tiles a power of two allows (1 at B=15, 4 at B=63, 16 at B=255)."""
    for B in range(1, 257):
        m_tiles = _onehot_m_tiles(B)
        assert m_tiles in ONEHOT_M_TILES and 16 * m_tiles >= B, B
        assert m_tiles == 1 or 8 * m_tiles < B, B
    assert [_onehot_m_tiles(B) for B in (15, 63, 255)] == [1, 4, 16]


@pytest.mark.parametrize("m_tiles", ONEHOT_M_TILES)
def test_onehot_bitmap_word_equals_compare_word(m_tiles):
    """For every pair of bins b0, b1 in -1..255 (-1: padding), every lane row
    g and every A register (mt, s) the kernel indexes, the bitmap-built word
    hot_word(Q[(2 mt) >> 4], (2 mt) & 15 + s), in its two-instruction form
    and as ((Q >> j) & 0x00010001) * 0x3f80, equals the compare word of
    A row m = mt*16 + g + 8s: bins at or above 16 kMt are never hot, and at
    kMt = 16 the two bitmap words split j at 16."""
    b = np.arange(-1, 256)
    b0, b1 = np.repeat(b, b.size), np.tile(b, b.size)
    for g in range(8):
        words = _bitmap_words(b0, b1, g, m_tiles)
        assert len(words) == (2 if m_tiles == 16 else 1)
        for mt in range(m_tiles):
            for s in range(2):
                q, j = words[(2 * mt) >> 4], ((2 * mt) & 15) + s
                want = _onehot2(b0, b1, mt * 16 + g + 8 * s)
                np.testing.assert_array_equal(_hot_word(q, j), want, err_msg=str((g, mt, s)))
                np.testing.assert_array_equal(((q >> j) & 0x00010001) * 0x3F80, want)


@pytest.mark.parametrize("m_tiles", ONEHOT_M_TILES)
def test_onehot_fragments_hold_each_cell_once(m_tiles):
    """For every B of one instance, the accumulator fragments of a warp
    (element e of tile mt: bin mt*16 + g + 8(e >> 1), channel 2t + (e & 1))
    hold every (bin < B, channel < 3) cell exactly once, which lets the
    warps store into the shared histogram without zeroing it."""
    for B in [B for B in range(1, 257) if _onehot_m_tiles(B) == m_tiles]:
        cells = []
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for mt in range(m_tiles):
                for e in range(4):
                    bin_, ch = mt * 16 + g + 8 * (e >> 1), 2 * t + (e & 1)
                    if bin_ < B and ch < 3:
                        cells.append((bin_, ch))
        assert sorted(cells) == [(b, k) for b in range(B) for k in range(3)], B


def _bf16_of_half(half):
    return (np.asarray(half, np.uint32) << 16).view(np.float32).astype(np.float64)


@pytest.mark.parametrize("B,dtype", [(2, "float32"), (17, "bfloat16"), (63, "float32"),
                                     (129, "bfloat16"), (255, "float32")])
def test_onehot_warp_step_emulation_matches_reference(B, dtype):
    """One warp of csrc/hist_onehot.cu in numpy on 16-row steps of a
    ragged tile: bins staged as int16 row pairs (-1 past the end), values
    split into kTerms bf16 terms and staged [term][channel][row pair] with
    a zero channel 3, each lane's A registers from its bitmap words and its
    B registers from the staged words at channel min(g, 3), multiplied in
    the m16n8k16 fragment layouts and stored from the D fragments. The
    result equals the reference histogram of the (bf16-rounded) values."""
    rng = np.random.RandomState(B)
    n, m_tiles = 45, _onehot_m_tiles(B)  # 3 steps, the last one ragged
    terms = 3 if dtype == "float32" else 1
    steps = -(-n // 16)
    bins = np.full(steps * 16, -1, np.int64)
    bins[:n] = rng.randint(0, B, n)
    vals = np.zeros((steps * 16, 3), np.float32)
    vals[:n] = rng.randint(-2 ** 20, 2 ** 20, (n, 3)) / 1024.0  # 21 bits: three bf16 terms
    if dtype == "bfloat16":
        vals = _bf16_bits(vals)[1]
    # staged halves [term][channel][row]; channel 3 stays zero
    staged = np.zeros((terms, 4, steps * 16), np.uint16)
    x = vals.copy()
    for j in range(terms):
        staged[j, :3] = _bf16_bits(x)[0].T
        x = x - _bf16_bits(x)[1]
    d = np.zeros((m_tiles, 32, 4))
    for st in range(steps):
        A = np.zeros((m_tiles * 16, 16))
        Bm = np.zeros((terms, 16, 8))
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for h in range(2):
                r = st * 16 + 2 * t + 8 * h  # the pair's first row
                words = _bitmap_words(bins[r], bins[r + 1], g, m_tiles)
                for mt in range(m_tiles):
                    for s in range(2):
                        a = int(_hot_word(words[(2 * mt) >> 4], ((2 * mt) & 15) + s))
                        A[mt * 16 + g + 8 * s, 2 * t + 8 * h:2 * t + 8 * h + 2] = _bf16_of_half(
                            [a & 0xFFFF, a >> 16])
                for j in range(terms):
                    Bm[j, 2 * t + 8 * h:2 * t + 8 * h + 2, g] = _bf16_of_half(staged[j, min(g, 3), r:r + 2])
        for mt in range(m_tiles):
            D = sum(A[mt * 16:mt * 16 + 16] @ Bm[j] for j in range(terms))
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for e in range(4):
                    d[mt, lane, e] += D[g + 8 * (e >> 1), 2 * t + (e & 1)]
        assert not Bm[:, :, 3:].any()  # columns g >= 3 read the zero channel
    hist = np.zeros((B, 3))
    for mt in range(m_tiles):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for e in range(4):
                bin_, ch = mt * 16 + g + 8 * (e >> 1), 2 * t + (e & 1)
                if bin_ < B and ch < 3:
                    hist[bin_, ch] = d[mt, lane, e]
    want = histogram_reference(bins[None, :n].astype(np.uint8), vals[:n], B)[0]
    np.testing.assert_array_equal(hist, want)


def test_caps_match_jax_through_the_name_map():
    for jname, tname in hk.JAX_NAMES.items():
        for b in range(1, 301):
            assert hk.impl_supported(tname, b, "cuda", ignore_backend=True) == jhist.impl_supported(
                jname, b, "tpu", ignore_backend=True
            ), (jname, b)
    assert set(hk.KERNEL_CAPS) == {hk.JAX_NAMES[j] for j in hp.KERNEL_CAPS}
    # kernels route only on CUDA, the plain version only on the CPU
    assert hk.impl_supported("cuda_onehot", 255, "cuda")
    assert not hk.impl_supported("cuda_onehot", 255, "cpu")
    assert hk.impl_supported("scatter", 255, "cpu")
    assert not hk.impl_supported("scatter", 255, "cuda")
    assert hk.default_impl("cuda") == "cuda" and hk.default_impl("cpu") == "scatter"


def test_rows_bucket_and_bucket_sizes_match_jax():
    for n in list(range(1, 3000)) + [2 ** 20 - 1, 2 ** 20, 2 ** 20 + 1, 10 ** 6, 3 << 18]:
        assert hk.rows_bucket(n) == jhist.rows_bucket(n), n
    for n in (1, 255, 256, 1000, 4097, 100_000, 10 ** 6):
        assert hk.bucket_sizes(n) == jgrow.bucket_sizes(n), n


def test_entries_digest_matches_jax():
    ents = [
        {"B": 255, "K": 3, "hist_dtype": "float32", "rows_bucket": 1 << 20, "impl": "cuda"},
        {"B": 15, "K": 3, "hist_dtype": "bfloat16", "rows_bucket": 384, "impl": "cuda_packed4",
         "times_ms": {"cuda": 0.1}},
        {"B": 63, "K": 3, "hist_dtype": "float32", "rows_bucket": 256, "impl": "pallas"},
    ]
    assert ttune.entries_digest(ents) == jtune.entries_digest(ents)
    assert ttune.entries_digest(ents[::-1]) == ttune.entries_digest(ents)
    route = hk.HistRoute([((e["B"], e["K"], e["hist_dtype"], e["rows_bucket"]), e["impl"]) for e in ents])
    jroute = jhist.HistRoute([((e["B"], e["K"], e["hist_dtype"], e["rows_bucket"]), e["impl"]) for e in ents])
    assert route.digest == jroute.digest
