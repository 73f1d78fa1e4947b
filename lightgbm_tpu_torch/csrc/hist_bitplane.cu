// Bit-plane factored leaf histogram on Hopper tensor cores (sm_90a), B <= 256.
//
// Replaces the TPU kernel lightgbm_tpu/ops/hist_pallas.py:655
// histogram_pallas_bitplane (body _kernel_bitplane :605, factors from
// bitplane_split :574). A bin splits as bin = hi * lob + lo, lo its low
// kLoBits bits and hi the rest (16 x 16 at B=255, 8 x 8 at B=63, 4 x 4 at
// B=15), and per feature
//
//   D[lo * 3 + k, hi] = sum_r A[lo * 3 + k, r] * H[r, hi]
//   A[lo * 3 + k, r]  = (lo_r == lo) * values[r, k]   (lob * 3 rows)
//   H[r, hi]          = (hi_r == hi)                  (hib columns)
//
// so hist[f, hi * lob + lo, k] = D[lo * 3 + k, hi]. The TPU kernel builds
// each factor as the AND of one compare per bit plane, because one plane
// compare is one wide vector op there; on a CUDA thread the same 0/1 factor
// is lo_r = b & (lob - 1), hi_r = b >> kLoBits and one compare each.
// Padding rows carry b = -1 (hi = -1 matches no column) and value 0. The
// products run on mma.sync m16n8k16 (bf16 operands, f32 accumulate): A in
// kMt = ceil(lob * 3 / 16) row tiles (3 at B=255), H in kNt = ceil(hib / 8)
// column tiles (2 at B=255), rows in steps of 16.
//
// What bounds it on the card: the instructions the CUDA cores spend to
// build the factors, not bytes (a root pass at 1M rows x 28 features reads
// 40 MB, 12 us at 3.35 TB/s, H100 SXM data sheet) and not the tensor cores
// (f32 operands: 3 x 3 x 2 = 18 mma per 16 rows and feature at B=255,
// 129 GFLOP at the root). The design keeps that instruction count low:
//  - kLoBits and kHiBits are template parameters (one instance per plane
//    split of bitplane_split, both operand types), so every tile loop
//    unrolls and no loop runs over planes;
//  - a thread's A rows m = mt * 16 + g + 8 s have lo_m = m / 3 and channel
//    m % 3 = (g + mt + 2 s) % 3: lo_m and the word offsets of the channels
//    (g + c) % 3 are computed once, so the channel of each A register is a
//    compile-time index c = (mt + 2 s) % 3;
//  - a block owns a row slice and 8 features, one per warp. Per tile of 128
//    rows the block stages the 8 features' bins (any strides, the rows
//    gather included) and the rows' values, split once into kTerms bf16
//    terms and stored [term][channel][row] so that rows 2t, 2t + 1 are one
//    32-bit word: values are read and split ceil(F / 8) times per row, not
//    F times. Each thread loads its share of the next tile into registers
//    before the warps run this tile's mma and stores it into the second of
//    two buffers after, so one barrier per tile suffices and the loads are
//    in flight during the products;
//  - an A register is that word ANDed with a mask of 0xffff halves built
//    from the step's lo == lo_m compares, made once per step and reused by
//    every term; H registers are hi == hi_n ? bf16(1) : 0.
// Per 16 rows at B=255 in f32 a thread runs about 2 shared loads and ~8
// ALU ops for lo / hi, 8 compares for H, 24 for the 12 masks, 18 shared
// loads and 36 ANDs for A, and 18 mma. The masks and ANDs are most of that
// count, and what a faster version has to cut.
//
// Operand types, as in csrc/hist_onehot.cu: bf16 rounds each value once
// (RNE); float32 splits each value into three bf16 terms whose sum is the
// value exactly and runs three products into one accumulator (never TF32).
// The one-hot factor H is exact in bf16.
//
// Every warp keeps its at most 3 x 2 x 4 accumulators in registers for the
// block's whole slice, then stores them into the block's [8, B, 3] shared
// histogram (each cell lies in exactly one thread's fragment), and the
// block flushes the non-zero cells into the zeroed output with global
// atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                // features per block, one per warp
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 128;               // rows staged per tile
constexpr int kStep = 16;                // rows per mma
constexpr int kPairs = kTile / 2;        // 32-bit words (row pairs) per staged row
constexpr int kChanWords = kPairs + 8;   // padded: a warp's three channels hit distinct banks
constexpr int kFeatPerThread = kWarps * kTile / kThreads;  // bins a thread stages per tile
constexpr int kTargetBlocks = 1056;      // 8 blocks on each of 132 SMs
constexpr long long kMinSlice = 1024;

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 0xffff in each half of the word whose row's factor equals want
__device__ __forceinline__ uint32_t pair_mask(int x0, int x1, int want) {
  return (x0 == want ? 0x0000ffffu : 0u) | (x1 == want ? 0xffff0000u : 0u);
}

template <int kLoBits, int kHiBits, bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
bitplane_kernel(const uint8_t* __restrict__ bins, long long stride_f,
                long long stride_n, const float* __restrict__ values,
                const int* __restrict__ rows, long long n, int F, int B,
                long long slice_rows, float* __restrict__ out) {
  constexpr int kTerms = kBf16 ? 1 : 3;
  constexpr int kLob = 1 << kLoBits;
  constexpr int kHib = 1 << kHiBits;
  constexpr int kMRows = kLob * 3;
  constexpr int kMt = (kMRows + 15) / 16;
  constexpr int kNt = (kHib + 7) / 8;

  // two staging buffers: the next tile is stored while this one is read
  __shared__ uint32_t s_vals[2][kTerms * 3 * kChanWords];  // bf16 [term][channel][row]
  __shared__ uint32_t s_bins[2][kWarps * kPairs];          // int16 [feature][row], -1 pads
  extern __shared__ float s_hist[];                     // [kWarps, B, 3]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int f0 = blockIdx.x * kWarps;
  const bool active = f0 + warp < F;  // the last group is ragged
  const long long begin = (long long)blockIdx.y * slice_rows;
  const long long end = begin + slice_rows < n ? begin + slice_rows : n;

  // per-thread constants: lo_m of the A rows m = mt * 16 + g + 8 s (-1 for
  // rows at or above lob * 3), the word offset of channel (g + c) % 3, and
  // the H columns hi_n = nt * 8 + g
  int lo_m[kMt][2];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int m = mt * 16 + g + 8 * s;
      lo_m[mt][s] = m < kMRows ? m / 3 : -1;
    }
  int chan[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) chan[c] = ((g + c) % 3) * kChanWords + t;
  int hi_n[kNt];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) hi_n[nt] = nt * 8 + g;

  // staging: thread tid owns tile row tid % kTile, its values (tid < kTile)
  // and kFeatPerThread of the 8 features. fetch() loads a tile into registers, so
  // the next tile's loads are in flight while this one's mma run; stage()
  // splits the values and stores both into a buffer.
  const int srow = tid % kTile;
  const int sfeat = (tid / kTile) * kFeatPerThread;
  float v[3];
  int b[kFeatPerThread];
  auto fetch = [&](long long c0) {
    const long long i = c0 + srow;
    const long long r = i < end ? (rows != nullptr ? (long long)rows[i] : i) : -1;
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = (tid < kTile && r >= 0) ? values[r * 3 + k] : 0.0f;
#pragma unroll
    for (int q = 0; q < kFeatPerThread; ++q) {
      const int f = f0 + sfeat + q;
      b[q] = (r >= 0 && f < F) ? (int)bins[f * stride_f + r * stride_n] : -1;
    }
  };
  auto stage = [&](int buf) {
    if (tid < kTile) {
      __nv_bfloat16* s_vals16 = reinterpret_cast<__nv_bfloat16*>(s_vals[buf]);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float x = v[k];
#pragma unroll
        for (int j = 0; j < kTerms; ++j) {
          const __nv_bfloat16 term = __float2bfloat16_rn(x);
          s_vals16[(j * 3 + k) * 2 * kChanWords + srow] = term;
          x -= __bfloat162float(term);
        }
      }
    }
    short* s_bins16 = reinterpret_cast<short*>(s_bins[buf]);
#pragma unroll
    for (int q = 0; q < kFeatPerThread; ++q) s_bins16[(sfeat + q) * kTile + srow] = (short)b[q];
  };

  float d[kMt][kNt][4];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[mt][nt][e] = 0.0f;

  fetch(begin);
  stage(0);
  __syncthreads();
  int buf = 0;
  for (long long c0 = begin; c0 < end; c0 += kTile, buf ^= 1) {
    const bool more = c0 + kTile < end;
    if (more) fetch(c0 + kTile);
    if (active) {
      const uint32_t* sv = s_vals[buf];
      const uint32_t* sb = s_bins[buf] + warp * kPairs;
      const long long left = end - c0;
      const int steps = ((left < kTile ? (int)left : kTile) + kStep - 1) / kStep;
      for (int st = 0; st < steps; ++st) {
        // rows 2t, 2t+1 (h = 0) and 2t+8, 2t+9 (h = 1) of the step
        int lo[2][2], hi[2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t w = sb[st * 8 + t + 4 * h];
          const int b0 = (int)(w << 16) >> 16;
          const int b1 = (int)w >> 16;
          lo[h][0] = b0 & (kLob - 1);
          lo[h][1] = b1 & (kLob - 1);
          hi[h][0] = b0 >> kLoBits;
          hi[h][1] = b1 >> kLoBits;
        }
        uint32_t hf[kNt][2];
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            hf[nt][h] = pair_mask(hi[h][0], hi[h][1], hi_n[nt]) & 0x3f803f80u;
        uint32_t mask[kMt][2][2];
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
          for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int h = 0; h < 2; ++h) mask[mt][s][h] = pair_mask(lo[h][0], lo[h][1], lo_m[mt][s]);
#pragma unroll
        for (int j = 0; j < kTerms; ++j) {
          uint32_t word[3][2];
#pragma unroll
          for (int c = 0; c < 3; ++c)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              word[c][h] = sv[j * 3 * kChanWords + chan[c] + st * 8 + 4 * h];
#pragma unroll
          for (int mt = 0; mt < kMt; ++mt) {
            // rows m (s = 0) and m + 8 (s = 1): channels (g + mt) % 3, (g + mt + 2) % 3
            const int ca = mt % 3;
            const int cb = (mt + 2) % 3;
            const uint32_t a0 = word[ca][0] & mask[mt][0][0];
            const uint32_t a1 = word[cb][0] & mask[mt][1][0];
            const uint32_t a2 = word[ca][1] & mask[mt][0][1];
            const uint32_t a3 = word[cb][1] & mask[mt][1][1];
#pragma unroll
            for (int nt = 0; nt < kNt; ++nt) mma_bf16(d[mt][nt], a0, a1, a2, a3, hf[nt][0], hf[nt][1]);
          }
        }
      }
    }
    if (more) stage(buf ^ 1);
    __syncthreads();
  }

  // D element e of (mt, nt): row m = mt*16 + g + 8*(e >> 1), column
  // hi = nt*8 + 2t + (e & 1); slot hi * lob + m / 3, channel m % 3. Every
  // cell below B is stored by exactly one thread (idle warps store zeros).
  float* hist = s_hist + warp * B * 3;
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = mt * 16 + g + 8 * (e >> 1);
        const int hi = nt * 8 + 2 * t + (e & 1);
        const int slot = hi * kLob + m / 3;
        if (m < kMRows && hi < kHib && slot < B) hist[slot * 3 + m % 3] = d[mt][nt][e];
      }
  __syncthreads();

  const int feats = F - f0 < kWarps ? F - f0 : kWarps;
  float* o = out + (long long)f0 * B * 3;
  for (int c = tid; c < feats * B * 3; c += kThreads) {
    if (s_hist[c] != 0.0f) atomicAdd(o + c, s_hist[c]);
  }
}

template <int kLoBits, int kHiBits>
cudaError_t launch(const void* bins, long long stride_f, long long stride_n,
                   const void* values, const void* rows, long long n, int F,
                   int B, int bf16, void* out, cudaStream_t stream) {
  const long long groups = (F + kWarps - 1) / kWarps;
  long long slices = (kTargetBlocks + groups - 1) / groups;
  long long slice_rows = (n + slices - 1) / slices;
  slice_rows = (slice_rows + kTile - 1) / kTile * kTile;
  if (slice_rows < kMinSlice) slice_rows = kMinSlice;
  slices = (n + slice_rows - 1) / slice_rows;
  // x: the feature groups of one row slice run side by side and share its
  // rows in L2
  const dim3 grid((unsigned)groups, (unsigned)slices);
  const size_t smem = (size_t)kWarps * B * 3 * sizeof(float);
  decltype(&bitplane_kernel<kLoBits, kHiBits, false>) kern =
      bf16 ? &bitplane_kernel<kLoBits, kHiBits, true> : &bitplane_kernel<kLoBits, kHiBits, false>;
  kern<<<grid, kThreads, smem, stream>>>(
      (const uint8_t*)bins, stride_f, stride_n, (const float*)values, (const int*)rows, n,
      F, B, slice_rows, (float*)out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// hist[F, B, 3] (zeroed by the caller) += histogram of n rows; the same
// arguments as lgbt_histogram (csrc/histogram.cu). 2 <= B <= 256.
int lgbt_hist_bitplane(const void* bins, long long stride_f, long long stride_n,
                       const void* values, const void* rows, long long n, int F,
                       int B, int bf16, void* out, void* stream) {
  if (n <= 0 || F <= 0) return (int)cudaSuccess;
  if (B < 1 || B > 256) return (int)cudaErrorInvalidValue;
  // bitplane_split: p = max(ceil(log2 B), 2) planes, kLoBits = p / 2
  int p = 0;
  while ((1 << p) < B) ++p;
  if (p < 2) p = 2;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (p) {
    case 2: err = launch<1, 1>(bins, stride_f, stride_n, values, rows, n, F, B, bf16, out, s); break;
    case 3: err = launch<1, 2>(bins, stride_f, stride_n, values, rows, n, F, B, bf16, out, s); break;
    case 4: err = launch<2, 2>(bins, stride_f, stride_n, values, rows, n, F, B, bf16, out, s); break;
    case 5: err = launch<2, 3>(bins, stride_f, stride_n, values, rows, n, F, B, bf16, out, s); break;
    case 6: err = launch<3, 3>(bins, stride_f, stride_n, values, rows, n, F, B, bf16, out, s); break;
    case 7: err = launch<3, 4>(bins, stride_f, stride_n, values, rows, n, F, B, bf16, out, s); break;
    default: err = launch<4, 4>(bins, stride_f, stride_n, values, rows, n, F, B, bf16, out, s); break;
  }
  return (int)err;
}

}  // extern "C"
