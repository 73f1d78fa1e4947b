// One-hot leaf histogram on Hopper tensor cores (sm_90a), B <= 256.
//
// Replaces the TPU kernel lightgbm_tpu/ops/hist_pallas.py:524
// histogram_pallas_onehot (body _kernel_onehot :484):
// hist[f] = onehot(bins[f])^T @ values, contracted on the matrix unit. The
// same product runs here on mma.sync m16n8k16 with bf16 operands and f32
// accumulation:
//
//   A [16 bins x 16 rows]  one-hot: A[m, r] = (bins[f, r] == mt * 16 + m),
//                          in bf16, exact because it holds 0 and 1 only;
//   B [16 rows x 8]        the rows' values (grad, hess, count), lanes of
//                          the other five columns reading a zero channel;
//   D [16 bins x 8]        f32 accumulators in registers.
//
// What bounds it on the card: instructions, not bytes. A root pass at 1M
// rows x 28 features x 255 bins reads 40 MB (12 us at 3.35 TB/s, H100 SXM
// data sheet), but every 16 rows of a feature take one A fragment per
// 16-bin tile (16 tiles, 64 32-bit words a thread at B=255) and kTerms mma
// per tile (48 in f32, 16 in bf16: 84M mma.sync at the f32 root). The A
// words are most of the CUDA-core work, the mma the rest. The design:
//  - kMt, the number of 16-bin tiles, is a template parameter: ceil(B / 16)
//    rounded up to a power of two (1 at B=15, 4 at B=63, 16 at B=255), so a
//    narrow histogram builds and multiplies only the tiles it has. One warp
//    covers all of a feature's bins, so one row step serves every tile and
//    each row is read and split once per block, not once per bin tile;
//  - a block owns a row slice and 8 features, one per warp. Per tile of 128
//    rows the block stages the 8 features' bins (int16, -1 for padding; any
//    strides, the rows gather included) and the rows' values, split once
//    into kTerms bf16 terms and stored [term][channel][row] so that rows
//    2t, 2t + 1 are one 32-bit word, the B register. A fourth channel holds
//    zeros, and lanes of columns g >= 3 read it, so B needs no select.
//    Each thread loads its share of the next tile into registers before the
//    warps run this tile's mma and stores it into the second of two buffers
//    after, so one barrier per tile suffices and the loads are in flight
//    during the products;
//  - a thread's A rows are m = 8 j + g, j = 2 mt + s in [0, 2 kMt). A row
//    of bin b is hot at j exactly when e = b - g >= 0, e & 7 == 0 and
//    j = e >> 3. So each of a thread's four rows costs one bit, set once
//    per step in a bitmap word per row pair (bit j for the first row, bit
//    16 + j for the second; two words at kMt = 16), and every A register
//    is ((Q >> j) & 0x00010001) * 0x3f80, bf16 1.0 in each hot half, in
//    two instructions (hot_word). Rows past the slice's end carry b = -1
//    (never hot) and value 0.
// Per 16 rows at B=255 in f32 a thread runs about 2 shared loads and 4 ops
// to unpack the bins, ~24 for the row bits, ~8 to build the bitmaps, 128
// for the A words, 6 shared loads for B and 48 mma. The A words are 16x
// those of the factored form (csrc/hist_bitplane.cu): what a faster
// version has to cut.
//
// Operand types, as in csrc/hist_bitplane.cu: bf16 rounds each value once
// (RNE); float32 splits each value v into three bf16 terms t0 = bf16(v),
// t1 = bf16(v - t0), t2 = bf16(v - t0 - t1), whose sum is v exactly (each
// residual is exact in f32 and the last fits bf16's 8 bits), and runs the
// three products into one accumulator (never TF32): the counterpart of the
// TPU's HIGHEST precision, bf16 x 3. The tensor cores add in f32 in their
// own order and rounding, so real-valued sums differ from a sequential f32
// sum in the last bits; dyadic inputs with small exponents sum exactly in
// every order.
//
// Every warp keeps its kMt x 4 accumulators in registers for the block's
// whole slice, then stores them into the block's [8, B, 3] shared
// histogram (each cell lies in exactly one lane's fragment), and the block
// flushes the non-zero cells into the zeroed output with global atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                // features per block, one per warp
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 128;               // rows staged per tile
constexpr int kStep = 16;                // rows per mma
constexpr int kPairs = kTile / 2;        // 32-bit words (row pairs) per staged row
constexpr int kChanWords = kPairs + 8;   // padded: channels 0-3 of one load hit distinct banks
constexpr int kChans = 4;                // grad, hess, count, zeros
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

// bit j of a row of bin b in the A rows m = 8 j + g of a warp that covers
// kSpan bins: e = b - g must lie in [0, kSpan) and be a multiple of 8, one
// test of e against the bits outside (kSpan - 1) & ~7
template <int kSpan>
__device__ __forceinline__ uint32_t row_bit(int b, int g) {
  const int e = b - g;
  return (e & (~(kSpan - 1) | 7)) == 0 ? 1u << (e >> 3) : 0u;
}

// the A register of bitmap word q at bit j < 16: bf16 1.0 (0x3f80) in each
// half whose row's bit j is set. That is ((q >> j) & 0x00010001) * 0x3f80,
// in two instructions instead of three: the mask keeps bits j and 16 + j in
// place, and 0x3f80 = 0x7f << 7, so for j < 8 the product by 0x3f80 >> j
// moves each bit to 0x3f80 in its half; for j >= 8 the same runs on q >> 8,
// one shift shared by the eight registers of the word's upper byte
__device__ __forceinline__ uint32_t hot_word(uint32_t q, int j) {
  return j < 8 ? (q & (0x00010001u << j)) * (0x3f80u >> j)
               : ((q >> 8) & (0x00010001u << (j - 8))) * (0x3f80u >> (j - 8));
}

template <int kMt, bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
onehot_kernel(const uint8_t* __restrict__ bins, long long stride_f,
              long long stride_n, const float* __restrict__ values,
              const int* __restrict__ rows, long long n, int F, int B,
              long long slice_rows, float* __restrict__ out) {
  constexpr int kTerms = kBf16 ? 1 : 3;
  constexpr int kSpan = kMt * 16;         // bins a warp covers
  constexpr int kWords = kMt > 8 ? 2 : 1; // bitmap words per row pair (16 bits j each)

  // two staging buffers: the next tile is stored while this one is read
  __shared__ uint32_t s_vals[2][kTerms * kChans * kChanWords];  // bf16 [term][channel][row]
  __shared__ uint32_t s_bins[2][kWarps * kPairs];               // int16 [feature][row], -1 pads
  extern __shared__ float s_hist[];                          // [kWarps, B, 3]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;  // A row within 8, B column
  const int t = tid & 3;          // A column pair / B row pair
  const int f0 = blockIdx.x * kWarps;
  const bool active = f0 + warp < F;  // the last group is ragged
  const long long begin = (long long)blockIdx.y * slice_rows;
  const long long end = begin + slice_rows < n ? begin + slice_rows : n;

  // the zero channel, which stage() never writes
  for (int i = tid; i < 2 * kTerms * kChanWords; i += kThreads) {
    const int buf = i / (kTerms * kChanWords);
    const int k = i % (kTerms * kChanWords);
    s_vals[buf][((k / kChanWords) * kChans + 3) * kChanWords + k % kChanWords] = 0u;
  }

  // staging: thread tid owns tile row tid % kTile, its values (tid < kTile)
  // and kFeatPerThread of the 8 features. fetch() loads a tile into
  // registers, so the next tile's loads are in flight while this one's mma
  // run; stage() splits the values and stores both into a buffer.
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
          s_vals16[(j * kChans + k) * 2 * kChanWords + srow] = term;
          x -= __bfloat162float(term);
        }
      }
    }
    short* s_bins16 = reinterpret_cast<short*>(s_bins[buf]);
#pragma unroll
    for (int q = 0; q < kFeatPerThread; ++q) s_bins16[(sfeat + q) * kTile + srow] = (short)b[q];
  };

  // B registers: channel g of the row pairs, the zero channel for g >= 3
  const int boff = (g < 3 ? g : 3) * kChanWords + t;

  float d[kMt][4];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) d[mt][0] = d[mt][1] = d[mt][2] = d[mt][3] = 0.0f;

  fetch(begin);
  stage(0);
  __syncthreads();
  int buf = 0;
  for (long long c0 = begin; c0 < end; c0 += kTile, buf ^= 1) {
    const bool more = c0 + kTile < end;
    if (more) fetch(c0 + kTile);
    if (active) {
      const uint32_t* sv = s_vals[buf] + boff;
      const uint32_t* sb = s_bins[buf] + warp * kPairs + t;
      const long long left = end - c0;
      const int steps = ((left < kTile ? (int)left : kTile) + kStep - 1) / kStep;
      for (int st = 0; st < steps; ++st) {
        // rows 2t, 2t+1 (h = 0) and 2t+8, 2t+9 (h = 1) of the step: bit j
        // of q[h][w] / bit 16 + j for the pair's first / second row of bin
        // 8 (16 w + j) + g
        uint32_t q[2][kWords];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t pair = sb[st * 8 + 4 * h];
          const uint32_t m0 = row_bit<kSpan>((int)(pair << 16) >> 16, g);
          const uint32_t m1 = row_bit<kSpan>((int)pair >> 16, g);
          if constexpr (kWords == 1) {
            q[h][0] = m0 | (m1 << 16);
          } else {
            q[h][0] = (m0 & 0xffffu) | (m1 << 16);
            q[h][1] = (m0 >> 16) | (m1 & 0xffff0000u);
          }
        }
        uint32_t bv[kTerms][2];
#pragma unroll
        for (int j = 0; j < kTerms; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) bv[j][h] = sv[j * kChans * kChanWords + st * 8 + 4 * h];
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt) {
          // A rows mt*16 + g (bit 2 mt) and mt*16 + g + 8 (bit 2 mt + 1)
          const int w = (2 * mt) >> 4;
          const int j = (2 * mt) & 15;
          const uint32_t a0 = hot_word(q[0][w], j);
          const uint32_t a1 = hot_word(q[0][w], j + 1);
          const uint32_t a2 = hot_word(q[1][w], j);
          const uint32_t a3 = hot_word(q[1][w], j + 1);
#pragma unroll
          for (int k = 0; k < kTerms; ++k) mma_bf16(d[mt], a0, a1, a2, a3, bv[k][0], bv[k][1]);
        }
      }
    }
    if (more) stage(buf ^ 1);
    __syncthreads();
  }

  // D element e of tile mt: bin mt*16 + g + 8*(e >> 1), channel 2t + (e & 1).
  // Every cell below B is stored by exactly one lane (idle warps store zeros).
  float* hist = s_hist + warp * B * 3;
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int bin = mt * 16 + g + 8 * (e >> 1);
      const int ch = 2 * t + (e & 1);
      if (bin < B && ch < 3) hist[bin * 3 + ch] = d[mt][e];
    }
  __syncthreads();

  const int feats = F - f0 < kWarps ? F - f0 : kWarps;
  float* o = out + (long long)f0 * B * 3;
  for (int c = tid; c < feats * B * 3; c += kThreads) {
    if (s_hist[c] != 0.0f) atomicAdd(o + c, s_hist[c]);
  }
}

template <int kMt>
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
  decltype(&onehot_kernel<kMt, false>) kern =
      bf16 ? &onehot_kernel<kMt, true> : &onehot_kernel<kMt, false>;
  kern<<<grid, kThreads, smem, stream>>>(
      (const uint8_t*)bins, stride_f, stride_n, (const float*)values, (const int*)rows, n,
      F, B, slice_rows, (float*)out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// hist[F, B, 3] (zeroed by the caller) += histogram of n rows; the same
// arguments as lgbt_histogram (csrc/histogram.cu). B <= 256.
int lgbt_hist_onehot(const void* bins, long long stride_f, long long stride_n,
                     const void* values, const void* rows, long long n, int F,
                     int B, int bf16, void* out, void* stream) {
  if (n <= 0 || F <= 0) return (int)cudaSuccess;
  if (B < 1 || B > 256) return (int)cudaErrorInvalidValue;
  // kMt: ceil(B / 16) rounded up to a power of two
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (B <= 16) {
    err = launch<1>(bins, stride_f, stride_n, values, rows, n, F, B, bf16, out, s);
  } else if (B <= 32) {
    err = launch<2>(bins, stride_f, stride_n, values, rows, n, F, B, bf16, out, s);
  } else if (B <= 64) {
    err = launch<4>(bins, stride_f, stride_n, values, rows, n, F, B, bf16, out, s);
  } else if (B <= 128) {
    err = launch<8>(bins, stride_f, stride_n, values, rows, n, F, B, bf16, out, s);
  } else {
    err = launch<16>(bins, stride_f, stride_n, values, rows, n, F, B, bf16, out, s);
  }
  return (int)err;
}

}  // extern "C"
