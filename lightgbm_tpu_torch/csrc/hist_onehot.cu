// One-hot tile leaf histogram on Hopper tensor cores (sm_90a), B <= 256.
//
// Replaces the TPU kernel lightgbm_tpu/ops/hist_pallas.py:524
// histogram_pallas_onehot (body _kernel_onehot :484):
// hist[f] = onehot(bins[f])^T @ values, B-tiled at 128 bins, contracted on
// the matrix unit. The same product runs here on mma.sync
// m16n8k16 with bf16 operands and f32 accumulation:
//
//   A [16 bins x 16 rows]  one-hot: A[m, r] = (bins[f, r] == bin0 + m), in
//                          bf16, exact because it holds 0 and 1 only;
//   B [16 rows x 8]        the rows' values (grad, hess, count), the three
//                          channels padded to the 8 columns mma wants;
//   D [16 bins x 8]        f32 accumulators in registers.
//
// A block owns (a row slice, a feature, a tile of 128 bins). Each of its four
// warps walks 16-row steps of the slice and keeps the tile's eight 16-bin
// accumulators in registers (32 floats a thread); at the end the warps add
// their accumulators into a [128, 3] shared tile, and the block flushes the
// tile's non-zero cells below B into the zeroed output with global atomics.
// Rows past the slice's end carry A = 0 and B = 0.
//
// Operand types. bf16 (hist_dtype=bfloat16): B holds each value rounded to
// bf16, one product per tile. float32: never TF32 (10 mantissa bits).
// Each value v splits into three bf16 terms, t0 = bf16(v),
// t1 = bf16(v - t0), t2 = bf16(v - t0 - t1); each residual is exact in f32
// and the last one fits bf16's 8 bits, so t0 + t1 + t2 == v and the three
// products into one accumulator give the f32 product exactly (the
// counterpart of the TPU's HIGHEST precision, bf16 x 3). The tensor cores
// add in f32 but in their own order and rounding, so real-valued sums differ
// from a sequential f32 sum in the last bits; dyadic inputs with small
// exponents sum exactly in every order.
//
// What bounds it on the card: the one-hot costs operations, not bytes. A
// root pass at 1M rows x 28 features x 255 bins reads 40 MB (12 us at
// 3.35 TB/s, H100 SXM data sheet) but builds 2 x 8 A fragments and issues
// 16 (bf16) or 48 (f32) mma per 16 rows per feature: 2 x 16 x 16 x 8 x 1M x 28 = 115 GFLOP of
// bf16 products in f32 mode, about 0.12 ms at 989 TFLOP/s dense, and the
// compares that build A cost as much again on the CUDA cores. The design
// reads each bin byte once per bin tile and keeps every partial sum in
// registers; a faster version would share one row step's loads between the
// tiles and feed wgmma from shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kTile = 128;         // bins per block
constexpr int kMt = kTile / 16;    // 16-bin accumulators per warp
constexpr int kStep = 16;          // rows per mma
constexpr int kTargetBlocks = 1056;  // 8 blocks on each of 132 SMs
constexpr long long kMinSlice = 1024;

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// two one-hot entries (1.0 in bf16 is 0x3f80), the first in the low half
__device__ __forceinline__ uint32_t onehot2(int b0, int b1, int bin) {
  return (b0 == bin ? 0x3f80u : 0u) | (b1 == bin ? 0x3f800000u : 0u);
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

template <bool kBf16>
__global__ void __launch_bounds__(kWarps * 32)
onehot_kernel(const uint8_t* __restrict__ bins, long long stride_f,
              long long stride_n, const float* __restrict__ values,
              const int* __restrict__ rows, long long n, int B,
              long long slice_rows, float* __restrict__ out) {
  constexpr int kTerms = kBf16 ? 1 : 3;
  __shared__ float tile[kTile * 3];
  const int f = blockIdx.y;
  const int bin0 = blockIdx.z * kTile;
  for (int i = threadIdx.x; i < kTile * 3; i += blockDim.x) tile[i] = 0.0f;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // A/D row within 16, B/D column
  const int t = lane & 3;   // A column pair / B row pair
  const long long begin = (long long)blockIdx.x * slice_rows;
  const long long end = begin + slice_rows < n ? begin + slice_rows : n;
  const uint8_t* col = bins + (long long)f * stride_f;

  float d[kMt][4];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) d[mt][0] = d[mt][1] = d[mt][2] = d[mt][3] = 0.0f;

  for (long long c0 = begin + warp * kStep; c0 < end; c0 += kWarps * kStep) {
    // this thread's four rows of the step: k = 2t, 2t+1, 2t+8, 2t+9
    int bk[4];
    __nv_bfloat16 term[kTerms][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long i = c0 + 2 * t + (q & 1) + (q >> 1) * 8;
      float v = 0.0f;
      bk[q] = -1;
      if (i < end) {
        const long long r = rows != nullptr ? (long long)rows[i] : i;
        bk[q] = col[r * stride_n];
        if (g < 3) v = values[r * 3 + g];
      }
#pragma unroll
      for (int j = 0; j < kTerms; ++j) {
        term[j][q] = __float2bfloat16_rn(v);
        v -= __bfloat162float(term[j][q]);
      }
    }
    uint32_t b[kTerms][2];
#pragma unroll
    for (int j = 0; j < kTerms; ++j) {
      b[j][0] = pack2(term[j][0], term[j][1]);
      b[j][1] = pack2(term[j][2], term[j][3]);
    }
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt) {
      const int lo = bin0 + mt * 16 + g;  // A rows g and g + 8
      const uint32_t a0 = onehot2(bk[0], bk[1], lo);
      const uint32_t a1 = onehot2(bk[0], bk[1], lo + 8);
      const uint32_t a2 = onehot2(bk[2], bk[3], lo);
      const uint32_t a3 = onehot2(bk[2], bk[3], lo + 8);
#pragma unroll
      for (int j = 0; j < kTerms; ++j) mma_bf16(d[mt], a0, a1, a2, a3, b[j][0], b[j][1]);
    }
  }

  // D element e of tile mt: bin row mt*16 + g + 8*(e >> 1), channel 2t + (e & 1)
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ch = 2 * t + (e & 1);
      if (ch < 3 && d[mt][e] != 0.0f) {
        atomicAdd(tile + (mt * 16 + g + 8 * (e >> 1)) * 3 + ch, d[mt][e]);
      }
    }
  }
  __syncthreads();

  float* o = out + ((long long)f * B + bin0) * 3;
  const int cells = (B - bin0 < kTile ? B - bin0 : kTile) * 3;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    if (tile[i] != 0.0f) atomicAdd(o + i, tile[i]);
  }
}

}  // namespace

extern "C" {

// hist[F, B, 3] (zeroed by the caller) += histogram of n rows; the same
// arguments as lgbt_histogram (csrc/histogram.cu). B <= 256.
int lgbt_hist_onehot(const void* bins, long long stride_f, long long stride_n,
                     const void* values, const void* rows, long long n, int F,
                     int B, int bf16, void* out, void* stream) {
  if (n <= 0 || F <= 0) return (int)cudaSuccess;
  if (B < 1 || B > 2 * kTile || F > 65535) return (int)cudaErrorInvalidValue;
  const int tiles = (B + kTile - 1) / kTile;
  long long slices = (kTargetBlocks + (long long)F * tiles - 1) / ((long long)F * tiles);
  long long slice_rows = (n + slices - 1) / slices;
  slice_rows = (slice_rows + kWarps * kStep - 1) / (kWarps * kStep) * (kWarps * kStep);
  if (slice_rows < kMinSlice) slice_rows = kMinSlice;
  slices = (n + slice_rows - 1) / slice_rows;
  dim3 grid((unsigned)slices, (unsigned)F, (unsigned)tiles);
  decltype(&onehot_kernel<false>) kern =
      bf16 ? &onehot_kernel<true> : &onehot_kernel<false>;
  kern<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bins, stride_f, stride_n, (const float*)values,
      (const int*)rows, n, B, slice_rows, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
