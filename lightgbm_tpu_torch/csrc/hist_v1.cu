// Per-feature-grid leaf histogram for Hopper (sm_90a): the oracle kernel.
//
// Replaces the TPU kernel lightgbm_tpu/ops/hist_pallas.py:301
// histogram_pallas_v1 (body _kernel :144): the per-feature-grid radix kernel
// that the JAX package keeps as the differential oracle of its feature-
// batched kernel. Here it is the oracle of csrc/histogram.cu and shares no
// code with it: the grid is (row chunk, feature), every block owns ONE
// feature's [B, 3] f32 sub-histogram in shared memory (at most 336 x 12
// bytes), walks its chunk of kChunk rows reading bins[f, r] straight from the
// strided [F, N] input, adds with shared-memory atomics and flushes its non-
// zero cells into the zeroed output with global atomics.
//
// What bounds it on the card: bytes. A root pass at 1M rows x 28 features
// has to read 28 MB of bins and 12 MB of values, about 12 us at 3.35 TB/s
// (H100 SXM data sheet). This design reads the values once per feature (28 times at the root, from
// L2 where they fit), which is what the feature-batched kernel was built to
// avoid; it is kept plain on purpose, so that the two kernels can hold each
// other.
//
// bf16 operands round each value to bf16 (nearest even) before its f32 add.
// Sums are f32 in an order set by the atomics; dyadic inputs with small
// exponents sum exactly in every order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16384;  // rows per block

template <bool kBf16>
__device__ __forceinline__ float rounded(float v) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
v1_kernel(const uint8_t* __restrict__ bins, long long stride_f,
          long long stride_n, const float* __restrict__ values,
          const int* __restrict__ rows, long long n, int B,
          float* __restrict__ out) {
  extern __shared__ float cell[];  // [B, 3]
  const int f = blockIdx.y;
  for (int i = threadIdx.x; i < B * 3; i += blockDim.x) cell[i] = 0.0f;
  __syncthreads();

  const long long begin = (long long)blockIdx.x * kChunk;
  const long long end = begin + kChunk < n ? begin + kChunk : n;
  const uint8_t* col = bins + (long long)f * stride_f;
  for (long long i = begin + threadIdx.x; i < end; i += blockDim.x) {
    const long long r = rows != nullptr ? (long long)rows[i] : i;
    const int b = col[r * stride_n];
    if (b < B) {
      atomicAdd(cell + b * 3, rounded<kBf16>(values[r * 3]));
      atomicAdd(cell + b * 3 + 1, rounded<kBf16>(values[r * 3 + 1]));
      atomicAdd(cell + b * 3 + 2, rounded<kBf16>(values[r * 3 + 2]));
    }
  }
  __syncthreads();

  float* o = out + (long long)f * B * 3;
  for (int i = threadIdx.x; i < B * 3; i += blockDim.x) {
    if (cell[i] != 0.0f) atomicAdd(o + i, cell[i]);
  }
}

}  // namespace

extern "C" {

// hist[F, B, 3] (zeroed by the caller) += histogram of n rows; the same
// arguments as lgbt_histogram (csrc/histogram.cu).
int lgbt_hist_v1(const void* bins, long long stride_f, long long stride_n,
                 const void* values, const void* rows, long long n, int F,
                 int B, int bf16, void* out, void* stream) {
  if (n <= 0 || F <= 0) return (int)cudaSuccess;
  if (B < 1 || B > 336 || F > 65535) return (int)cudaErrorInvalidValue;
  const long long chunks = (n + kChunk - 1) / kChunk;
  if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)chunks, (unsigned)F);
  const int smem = B * 3 * (int)sizeof(float);
  decltype(&v1_kernel<false>) kern = bf16 ? &v1_kernel<true> : &v1_kernel<false>;
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)bins, stride_f, stride_n, (const float*)values,
      (const int*)rows, n, B, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
