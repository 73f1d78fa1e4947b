// Bit-plane factored leaf histogram on Hopper tensor cores (sm_90a), B <= 256.
//
// Replaces the TPU kernel lightgbm_tpu/ops/hist_pallas.py:655
// histogram_pallas_bitplane (body _kernel_bitplane :605, factors from
// bitplane_split :574). A bin splits as bin = hi * lob + lo, lo its low
// log2(lob) bits and hi the rest (ops/hist_kernel.py bitplane_split: 16 x 16
// at B=255, 8 x 8 at B=63, 4 x 4 at B=15), and per feature
//
//   D[lo * 3 + k, hi] = sum_r A[lo * 3 + k, r] * H[r, hi]
//   A[lo * 3 + k, r]  = onehot_lo[lo, r] * values[r, k]   (lob * 3 rows)
//   H[r, hi]          = onehot_hi[r, hi]                 (hib columns)
//
// so hist[f, hi * lob + lo, k] = D[lo * 3 + k, hi]. Both one-hot factors are
// built, as in the TPU kernel, from bit-plane compares: onehot_lo[lo, r] is
// the AND over the log2(lob) low planes of (bit p of bins[f, r] == bit p of
// lo), onehot_hi the AND over the high planes. The products run on mma.sync
// m16n8k16 (bf16 operands, f32 accumulate): A in ceil(lob*3/16) row tiles
// (3 at B=255), H in ceil(hib/8) column tiles (2 at B=255), rows in steps of
// 16. Rows of A at or above lob*3, columns of H at or above hib, and slots
// hi * lob + lo at or above B are padding and never written.
//
// A block owns (a row slice, a feature); each of its four warps walks
// 16-row steps and keeps the at most 3 x 2 accumulators in registers; the
// warps add them into a [B, 3] shared histogram, which the block flushes
// into the zeroed output with global atomics.
//
// Operand types, as in csrc/hist_onehot.cu: bf16 rounds each value once;
// float32 splits each value into three bf16 terms whose sum is the value
// exactly and runs three products into one accumulator (never TF32). The
// one-hot factor H is exact in bf16.
//
// What bounds it on the card: operations on the CUDA cores that build the
// factors. Per 16 rows and feature a thread makes 4 x (log2 B) plane
// compares and 3 x 2 (x 3 terms in f32) mma; the mma work, 2 x 48 x 16 x 16
// per 16 rows (x3 in f32), is a third of the one-hot tile kernel's at
// B=255. A root pass reads 40 MB (12 us at 3.35 TB/s, H100 SXM data
// sheet). The design reads every bin byte once per feature and keeps the
// partial sums in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kStep = 16;            // rows per mma
constexpr int kMaxMt = 3;            // ceil(16 * 3 / 16)
constexpr int kMaxNt = 2;            // ceil(16 / 8)
constexpr int kTargetBlocks = 1056;  // 8 blocks on each of 132 SMs
constexpr long long kMinSlice = 1024;

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// AND over planes p in [0, nbits) of (bit shift + p of b == bit p of want);
// b < 0 (a padding row) matches nothing
__device__ __forceinline__ bool planes_equal(int b, int want, int shift, int nbits) {
  bool eq = b >= 0;
  for (int p = 0; p < nbits; ++p) eq = eq && (((b >> (shift + p)) & 1) == ((want >> p) & 1));
  return eq;
}

template <bool kBf16>
__global__ void __launch_bounds__(kWarps * 32)
bitplane_kernel(const uint8_t* __restrict__ bins, long long stride_f,
                long long stride_n, const float* __restrict__ values,
                const int* __restrict__ rows, long long n, int B, int lo_bits,
                int hi_bits, long long slice_rows, float* __restrict__ out) {
  constexpr int kTerms = kBf16 ? 1 : 3;
  extern __shared__ float hist[];  // [B, 3]
  const int f = blockIdx.y;
  for (int i = threadIdx.x; i < B * 3; i += blockDim.x) hist[i] = 0.0f;
  __syncthreads();

  const int lob = 1 << lo_bits;
  const int hib = 1 << hi_bits;
  const int m_rows = lob * 3;
  const int mts = (m_rows + 15) / 16;
  const int nts = (hib + 7) / 8;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long begin = (long long)blockIdx.x * slice_rows;
  const long long end = begin + slice_rows < n ? begin + slice_rows : n;
  const uint8_t* col = bins + (long long)f * stride_f;

  float d[kMaxMt][kMaxNt][4];
#pragma unroll
  for (int mt = 0; mt < kMaxMt; ++mt)
#pragma unroll
    for (int nt = 0; nt < kMaxNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[mt][nt][e] = 0.0f;

  for (long long c0 = begin + warp * kStep; c0 < end; c0 += kWarps * kStep) {
    // this thread's four rows of the step: k = 2t, 2t+1, 2t+8, 2t+9
    int bk[4];
    __nv_bfloat16 term[kTerms][4][3];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long i = c0 + 2 * t + (q & 1) + (q >> 1) * 8;
      float v[3] = {0.0f, 0.0f, 0.0f};
      bk[q] = -1;
      if (i < end) {
        const long long r = rows != nullptr ? (long long)rows[i] : i;
        bk[q] = col[r * stride_n];
        v[0] = values[r * 3];
        v[1] = values[r * 3 + 1];
        v[2] = values[r * 3 + 2];
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
#pragma unroll
        for (int j = 0; j < kTerms; ++j) {
          term[j][q][k] = __float2bfloat16_rn(v[k]);
          v[k] -= __bfloat162float(term[j][q][k]);
        }
      }
    }
    // H fragments: column hi = nt * 8 + g, rows 2t, 2t+1 | 2t+8, 2t+9
    uint32_t h[kMaxNt][2];
#pragma unroll
    for (int nt = 0; nt < kMaxNt; ++nt) {
      const int hi = nt * 8 + g;
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        w[q] = (hi < hib && planes_equal(bk[q], hi, lo_bits, hi_bits)) ? 0x3f80u : 0u;
      }
      h[nt][0] = w[0] | (w[1] << 16);
      h[nt][1] = w[2] | (w[3] << 16);
    }
#pragma unroll
    for (int mt = 0; mt < kMaxMt; ++mt) {
      if (mt >= mts) break;
      // A rows m = mt*16 + g (a0, a2) and m + 8 (a1, a3): lo = m / 3, k = m % 3
      bool on[2][4];
      int kk[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int m = mt * 16 + g + 8 * s;
        kk[s] = m % 3;
#pragma unroll
        for (int q = 0; q < 4; ++q) on[s][q] = m < m_rows && planes_equal(bk[q], m / 3, 0, lo_bits);
      }
#pragma unroll
      for (int j = 0; j < kTerms; ++j) {
        __nv_bfloat16 z = __float2bfloat16_rn(0.0f);
        __nv_bfloat16 e[2][4];
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const __nv_bfloat16 x0 = term[j][q][0], x1 = term[j][q][1], x2 = term[j][q][2];
            e[s][q] = on[s][q] ? (kk[s] == 0 ? x0 : (kk[s] == 1 ? x1 : x2)) : z;
          }
        const uint32_t a0 = pack2(e[0][0], e[0][1]);
        const uint32_t a1 = pack2(e[1][0], e[1][1]);
        const uint32_t a2 = pack2(e[0][2], e[0][3]);
        const uint32_t a3 = pack2(e[1][2], e[1][3]);
#pragma unroll
        for (int nt = 0; nt < kMaxNt; ++nt) {
          if (nt < nts) mma_bf16(d[mt][nt], a0, a1, a2, a3, h[nt][0], h[nt][1]);
        }
      }
    }
  }

  // D element e of (mt, nt): row m = mt*16 + g + 8*(e >> 1), column
  // hi = nt*8 + 2t + (e & 1); slot hi * lob + m / 3, channel m % 3
#pragma unroll
  for (int mt = 0; mt < kMaxMt; ++mt)
#pragma unroll
    for (int nt = 0; nt < kMaxNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = mt * 16 + g + 8 * (e >> 1);
        const int hi = nt * 8 + 2 * t + (e & 1);
        const int slot = hi * lob + m / 3;
        if (mt < mts && nt < nts && m < m_rows && hi < hib && slot < B &&
            d[mt][nt][e] != 0.0f) {
          atomicAdd(hist + slot * 3 + m % 3, d[mt][nt][e]);
        }
      }
  __syncthreads();

  float* o = out + (long long)f * B * 3;
  for (int i = threadIdx.x; i < B * 3; i += blockDim.x) {
    if (hist[i] != 0.0f) atomicAdd(o + i, hist[i]);
  }
}

}  // namespace

extern "C" {

// hist[F, B, 3] (zeroed by the caller) += histogram of n rows; the same
// arguments as lgbt_histogram (csrc/histogram.cu). 2 <= B <= 256.
int lgbt_hist_bitplane(const void* bins, long long stride_f, long long stride_n,
                       const void* values, const void* rows, long long n, int F,
                       int B, int bf16, void* out, void* stream) {
  if (n <= 0 || F <= 0) return (int)cudaSuccess;
  if (B < 1 || B > 256 || F > 65535) return (int)cudaErrorInvalidValue;
  // bitplane_split: p = max(ceil(log2 B), 2) planes, lob = 2^(p/2)
  int p = 0;
  while ((1 << p) < B) ++p;
  if (p < 2) p = 2;
  const int lo_bits = p / 2;
  const int hi_bits = p - lo_bits;
  long long slices = (kTargetBlocks + F - 1) / F;
  long long slice_rows = (n + slices - 1) / slices;
  slice_rows = (slice_rows + kWarps * kStep - 1) / (kWarps * kStep) * (kWarps * kStep);
  if (slice_rows < kMinSlice) slice_rows = kMinSlice;
  slices = (n + slice_rows - 1) / slice_rows;
  dim3 grid((unsigned)slices, (unsigned)F);
  decltype(&bitplane_kernel<false>) kern =
      bf16 ? &bitplane_kernel<true> : &bitplane_kernel<false>;
  kern<<<grid, kWarps * 32, B * 3 * (int)sizeof(float), (cudaStream_t)stream>>>(
      (const uint8_t*)bins, stride_f, stride_n, (const float*)values,
      (const int*)rows, n, B, lo_bits, hi_bits, slice_rows, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
