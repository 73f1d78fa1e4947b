// Nibble-packed leaf histogram for Hopper (sm_90a), B <= 16.
//
// Replaces the TPU kernel lightgbm_tpu/ops/hist_pallas.py:409
// histogram_pallas_packed4 (body _kernel_p4 :354, input from pack4 :390),
// which reads bins packed two to a byte (row 2j in the low nibble, row 2j+1
// in the high one; ops/hist_kernel.py pack4) and the two rows' values side
// by side ([N2, 6] f32), and contracts one one-hot per half on the matrix
// unit. Here every thread takes packed columns j in a grid-stride loop,
// reads the six values of its two rows once, and for each feature of the
// block's feature tile reads one byte, unpacks the two bins and adds both
// rows into its warp's own [features, 16, 3] f32 sub-histogram in shared
// memory. Per-warp copies keep the shared-memory atomics of a block's eight
// warps apart; at the end the block sums the eight copies per cell in warp
// order and flushes the non-zero cells into the zeroed output with global
// atomics. A padding row (odd N) carries bin 0 and value 0 and adds nothing.
//
// What bounds it on the card: bytes. Packing halves the bin bytes: a root
// pass at 1M rows x 28 features reads 14 MB of packed bins and 12 MB of
// values, about 8 us at 3.35 TB/s (H100 SXM data sheet), against 12 us
// unpacked. The design reads each packed byte and each value once per feature
// tile (one tile for F <= 151), and with 16 bins the sub-histograms are
// small, so the shared atomics of a warp collide often: that contention, not
// the bytes, is what a faster version has to remove.
//
// bf16 operands round each value to bf16 (nearest even) before its f32 add.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 16;  // bins a nibble can hold
constexpr int kMaxSmem = 227 * 1024;

template <bool kBf16>
__device__ __forceinline__ float rounded(float v) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
packed4_kernel(const uint8_t* __restrict__ bins, long long stride_f,
               long long stride_n, const float* __restrict__ values,
               long long n2, int F, int f_tile, int B,
               float* __restrict__ out) {
  extern __shared__ float cells[];  // [kWarps, ft, kSlots, 3]
  const int f0 = blockIdx.y * f_tile;
  const int ft = min(f_tile, F - f0);
  const int warp_cells = ft * kSlots * 3;
  for (int i = threadIdx.x; i < kWarps * warp_cells; i += blockDim.x) cells[i] = 0.0f;
  __syncthreads();

  float* mine = cells + (threadIdx.x >> 5) * warp_cells;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n2;
       j += step) {
    const float* v = values + j * 6;
    const float e0 = rounded<kBf16>(v[0]), e1 = rounded<kBf16>(v[1]),
                e2 = rounded<kBf16>(v[2]);
    const float o0 = rounded<kBf16>(v[3]), o1 = rounded<kBf16>(v[4]),
                o2 = rounded<kBf16>(v[5]);
    const uint8_t* bp = bins + j * stride_n + (long long)f0 * stride_f;
    for (int fl = 0; fl < ft; ++fl) {
      const int byte = bp[fl * stride_f];
      const int lo = byte & 15;
      const int hi = byte >> 4;
      float* c = mine + fl * kSlots * 3;
      if (lo < B) {
        atomicAdd(c + lo * 3, e0);
        atomicAdd(c + lo * 3 + 1, e1);
        atomicAdd(c + lo * 3 + 2, e2);
      }
      if (hi < B) {
        atomicAdd(c + hi * 3, o0);
        atomicAdd(c + hi * 3 + 1, o1);
        atomicAdd(c + hi * 3 + 2, o2);
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < ft * B * 3; i += blockDim.x) {
    const int fl = i / (B * 3);
    const int cell = i - fl * B * 3;  // b * 3 + k
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += cells[w * warp_cells + fl * kSlots * 3 + cell];
    if (s != 0.0f) atomicAdd(out + (long long)(f0 + fl) * B * 3 + cell, s);
  }
}

}  // namespace

extern "C" {

// hist[F, B, 3] (zeroed by the caller) += histogram of the 2 * n2 rows in
// the packed input: bins[f, j] at bins + f * stride_f + j * stride_n holds
// rows 2j (low nibble) and 2j+1 (high nibble); values is [n2, 6] f32
// row-major, the two rows' three values side by side. B <= 16.
int lgbt_hist_packed4(const void* bins, long long stride_f, long long stride_n,
                      const void* values, long long n2, int F, int B, int bf16,
                      void* out, void* stream) {
  if (n2 <= 0 || F <= 0) return (int)cudaSuccess;
  if (B < 1 || B > kSlots) return (int)cudaErrorInvalidValue;
  const int tile_bytes = kWarps * kSlots * 3 * (int)sizeof(float);
  int f_tile = kMaxSmem / tile_bytes;
  if (f_tile > F) f_tile = F;
  const int smem = f_tile * tile_bytes;
  decltype(&packed4_kernel<false>) kern =
      bf16 ? &packed4_kernel<true> : &packed4_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;

  static int num_sms = 0;
  if (num_sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, dev);
    if (num_sms <= 0) num_sms = 132;
  }
  int per_sm = (228 * 1024) / (smem + 1024);
  if (per_sm < 1) per_sm = 1;
  if (per_sm > 8) per_sm = 8;
  const long long want = (n2 + kThreads - 1) / kThreads;
  const long long cap = (long long)num_sms * per_sm;
  dim3 grid((unsigned)(want < cap ? want : cap), (unsigned)((F + f_tile - 1) / f_tile));
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)bins, stride_f, stride_n, (const float*)values, n2, F,
      f_tile, B, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
