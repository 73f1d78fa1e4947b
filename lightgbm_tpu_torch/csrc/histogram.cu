// Leaf histogram kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/hist_pallas.py:_histogram_pallas_fb
// (body _kernel_fb), entered through histogram_pallas. It computes the same
// function, hist[f, bins[f, r], k] += values[r, k] over the rows r of a leaf,
// but not the same way: the TPU kernel factors each bin into a radix pair and
// contracts one-hot tiles on the matrix unit because a TPU has no fast
// scatter. Hopper has fast shared-memory atomics, so this is the reference
// OpenCL histogram256 design: every block keeps a [features, B, 3] f32
// sub-histogram in shared memory (28 features at B=256 take 86 KB), its
// threads stride over rows and add each row's three values into the row's
// bin of every feature, and the block flushes its non-zero cells into the
// zeroed output with global atomicAdd.
//
// What bounds it on the card: bytes. A root pass at 1M rows x 28 features
// reads 28 MB of bins and 12 MB of values, about 12 us at 3.35 TB/s. The
// design reads each input byte once per feature group (one group for F <= 65
// at B = 256), keeps every partial sum on chip, and writes the output once
// per block. A leaf segment is read through the optional row-index vector, so
// the grower never materialises a gathered copy; with the transposed [N, F]
// bin layout (stride_n = F, stride_f = 1) a row's bins are one contiguous
// run, which keeps those gathers to a few sectors per row.
//
// Sums are f32 in an order set by the atomics, so they differ between runs
// in the last bits; on values that are dyadic rationals with small exponents
// every order gives the same bits. The count channel is a sum of 1.0s, exact
// up to 2^24 rows.
//
// bf16 operands (hist_dtype=bfloat16): each of a row's three values is
// rounded to bf16 (round to nearest even) before its f32 atomic add, the
// counterpart of the TPU kernel's bf16 matrix operands with f32 accumulation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// shared memory a block may use on sm_90 (232,448 bytes), less a margin
constexpr int kMaxSmem = 227 * 1024;

template <bool kBf16>
__device__ __forceinline__ float operand(float v) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const uint8_t* __restrict__ bins, long long stride_f,
            long long stride_n, const float* __restrict__ values,
            const int* __restrict__ rows, long long n, int F, int f_tile,
            int B, float* __restrict__ out) {
  extern __shared__ float cells[];  // [ft, B, 3]
  const int f0 = blockIdx.y * f_tile;
  const int ft = min(f_tile, F - f0);
  const int size = ft * B * 3;
  for (int i = threadIdx.x; i < size; i += blockDim.x) cells[i] = 0.0f;
  __syncthreads();

  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const long long r = rows != nullptr ? (long long)rows[i] : i;
    const float v0 = operand<kBf16>(values[r * 3]);
    const float v1 = operand<kBf16>(values[r * 3 + 1]);
    const float v2 = operand<kBf16>(values[r * 3 + 2]);
    const uint8_t* bp = bins + r * stride_n + (long long)f0 * stride_f;
    for (int fl = 0; fl < ft; ++fl) {
      const int b = bp[fl * stride_f];
      if (b < B) {
        float* c = cells + (fl * B + b) * 3;
        atomicAdd(c, v0);
        atomicAdd(c + 1, v1);
        atomicAdd(c + 2, v2);
      }
    }
  }
  __syncthreads();

  float* o = out + (long long)f0 * B * 3;
  for (int i = threadIdx.x; i < size; i += blockDim.x) {
    const float v = cells[i];
    if (v != 0.0f) atomicAdd(o + i, v);
  }
}

}  // namespace

extern "C" {

// hist[F, B, 3] (zeroed by the caller) += histogram of n rows.
// bins[f, r] lives at bins + f * stride_f + r * stride_n; values is [N, 3]
// f32 row-major; rows (may be null) holds n int32 row indices into both.
// bf16 != 0 rounds the values to bf16 before they are added.
int lgbt_histogram(const void* bins, long long stride_f, long long stride_n,
                   const void* values, const void* rows, long long n, int F,
                   int B, int bf16, void* out, void* stream) {
  if (n <= 0 || F <= 0) return (int)cudaSuccess;
  const int cell_bytes = B * 3 * (int)sizeof(float);
  int f_tile = kMaxSmem / cell_bytes;
  if (f_tile < 1) return (int)cudaErrorInvalidValue;
  if (f_tile > F) f_tile = F;
  const int smem = f_tile * cell_bytes;
  decltype(&hist_kernel<false>) kern = bf16 ? &hist_kernel<true> : &hist_kernel<false>;
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
  long long want = (n + kThreads - 1) / kThreads;
  long long cap = (long long)num_sms * per_sm;
  dim3 grid((unsigned)(want < cap ? want : cap), (unsigned)((F + f_tile - 1) / f_tile));
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)bins, stride_f, stride_n, (const float*)values,
      (const int*)rows, n, F, f_tile, B, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
