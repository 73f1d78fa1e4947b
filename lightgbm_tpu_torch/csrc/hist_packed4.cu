// Nibble-packed leaf histogram for Hopper (sm_90a), B <= 16.
//
// Replaces the TPU kernel lightgbm_tpu/ops/hist_pallas.py:409
// histogram_pallas_packed4 (body _kernel_p4 :354, input from pack4 :390),
// which reads bins packed two to a byte (row 2j in the low nibble, row 2j+1
// in the high one) and the two rows' values side by side, and contracts one
// one-hot per half on the matrix unit. It computes the same function,
// hist[f, b, k] = sum of values[r, k] over the rows r whose 4-bit bin of
// feature f is b, for b < B; a nibble >= B adds nothing.
//
// What bounds it on the card: shared-memory issue, not HBM bytes. A root
// pass at 1M rows x 28 features reads 14 MB of packed bins and 12 MB of
// values, about 8 us at 3.35 TB/s, but makes 6 shared accesses a row and a
// feature (3 loads, 3 stores), about 21 us of shared-memory issue over 132
// SMs. The values are read once per feature group, the re-reads from L2,
// through the same L1 data path as the shared accesses. Each block pays a
// fixed cost to zero and reduce its 96 KB of copies, which sets the time of
// small segments beside the launch and the latency of a gather by row. The
// design:
//
// 1. One entry reads packed bins by row. bins[f, j] holds rows 2j (low
//    nibble) and 2j+1 (high nibble); row r's bin is
//    (bins[f, r >> 1] >> ((r & 1) * 4)) & 15. values is [N, 3] f32, not
//    packed. With rows == nullptr a thread takes whole pairs: one bin load
//    serves two rows, whose six values are 24 contiguous bytes read as three
//    8-byte loads. With rows, it takes single rows by index, so the grower
//    reads a leaf segment out of the packed copy made once at set-up, with
//    no gather and no packing per call.
// 2. Two layouts, one kernel. When the bins are the [N2, F] set-up copy
//    (stride_f = 1, stride_n % 4 == 0, F % 4 == 0, 4-byte aligned) one
//    32-bit load gives a pair's 4 feature bytes, and (w >> shift) & 0x0f0f0f0f
//    one row's 4 bins. Otherwise (pack4's [F, N2]) the bins are read a byte
//    a feature.
// 3. A block owns kG = 4 features and a chunk of rows, with 128 threads,
//    and every thread owns a whole [4, 16, 3] f32 sub-histogram in dynamic
//    shared memory, laid out cells[((g * 16 + slot) * 3 + k) * 128 + tid]
//    (96 KB a block, opted in once per instantiation, carveout at its
//    maximum, so two blocks share an SM). Lane l always touches bank l, so
//    an add is a plain load, add and store: no atomic, no compare-and-swap
//    loop, no bank conflict, whatever the bins. The old design gave each
//    warp one copy, so its shared f32 atomicAdds were CAS loops
//    (ATOMS.CAST.SPIN on Hopper) that collided at 16 bins; they are gone. All
//    16 slots exist, so a nibble >= B lands in a slot that is never flushed;
//    a feature past F in the last group reads bin 0 into cells that are never
//    flushed either.
// 4. Loads go ahead of the adds. A step covers 4 rows a thread (2 pairs on
//    the root path): the thread loads the rows' indices, then their values
//    and bin words, and only then adds. The loads are one step ahead: a
//    step's values and bins are issued before the previous step's adds, its
//    row indices two steps ahead, and the first step's loads before the
//    zeroing of the copies; bins are unpacked and values rounded only at the
//    adds. Per row the thread issues the 12 loads of its 4 features x 3
//    channels, then the 12 adds, then the 12 stores (the cells of one row
//    never alias); the next row's loads follow them, since two rows may hit
//    the same cell. Every loop is unrolled at compile time and no register
//    array is indexed by a run-time value (that would spill).
// 5. A fixed-order block reduction. Warp w takes the cells c = w (mod 4) of
//    the group's nf x B x 3, 8 at a time; lane l adds copies l, l+32, l+64,
//    l+96 in that order, then 5 __shfl_xor_sync rounds sum across the lanes.
//    The cells' offsets are carried without a division and the flush has no
//    branch per cell (lane u writes the u-th sum). With one chunk the block
//    stores every cell of its group, zeros included (the output needs no
//    zeroing then), and the result is the same on every run; with more
//    chunks it adds its non-zero cells with atomicAdd whose result is unused
//    (RED).
// 6. A 1-D grid of ceil(F / 4) groups x chunks blocks, the group varying
//    fastest so the blocks reading the same rows run side by side and their
//    re-reads of the values hit L2. The launcher's rows_per_block
//    (ops/hist_kernel.py packed4_grid) is a multiple of 512 rows sized for
//    one wave of two blocks an SM.
//
// bf16 operands round each value to bf16 (nearest even) before its f32 add.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kG = 4;                      // features per block
constexpr int kSlots = 16;                 // bins a nibble can hold
constexpr int kRows = 4;                   // rows per thread per step
constexpr int kStep = kThreads * kRows;    // rows per block per step
constexpr int kCopy = kG * kSlots * 3;     // cells of one thread's copy
constexpr int kSmem = kCopy * kThreads * (int)sizeof(float);  // 98,304 bytes
constexpr int kReduce = 8;                 // cells a warp reduces together

template <bool kBf16>
__device__ __forceinline__ float operand(float v) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// Add one row into the thread's copy (mine = cells + tid): the 12 loads,
// then the 12 adds, then the 12 stores.
__device__ __forceinline__ void add_row(float* mine, const int (&b)[kG], const float (&v)[3]) {
  float c[kG][3];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int k = 0; k < 3; ++k) c[g][k] = mine[((g * kSlots + b[g]) * 3 + k) * kThreads];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int k = 0; k < 3; ++k) c[g][k] += v[k];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int k = 0; k < 3; ++k) mine[((g * kSlots + b[g]) * 3 + k) * kThreads] = c[g][k];
}

// One step of a thread: kRows rows as loaded, kept raw until their adds so
// that the next step's loads are in flight meanwhile.
struct Step {
  bool ok[kRows];
  float v[kRows][3];
  unsigned w[kRows];     // kWord: the row pair's word of kG bytes
  int byte[kRows][kG];   // otherwise the pair's byte of each feature
  int shift[kRows];      // 0 for row 2j, 4 for row 2j+1
};

// The row indices of a step (rows given): thread t's rows i0 + kThreads * jj.
struct Index {
  bool ok[kRows];
  long long r[kRows];
};

struct Args {
  const uint8_t* bins;  // at the group's first feature
  long long stride_f, stride_n;
  const float* values;
  long long end;
  int nf;
  bool vec;  // values 8-byte aligned: a row pair's 24 bytes as three 8-byte loads
};

template <bool kWord>
__device__ __forceinline__ void load_bins(Step& s, int jj, const Args& a, long long j, bool ok) {
  const uint8_t* bp = a.bins + j * a.stride_n;
  if (kWord) {
    s.w[jj] = ok ? *reinterpret_cast<const unsigned*>(bp) : 0u;
  } else {
#pragma unroll
    for (int g = 0; g < kG; ++g) s.byte[jj][g] = ok && g < a.nf ? bp[g * a.stride_f] : 0;
  }
}

// Rows 0..n-1: the pairs j0 and j0 + kThreads, rows 2j (jj = 2q) and 2j+1.
template <bool kWord>
__device__ __forceinline__ void load_pairs(Step& s, const Args& a, long long j0) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const long long j = j0 + q * kThreads;
    const bool lo = 2 * j < a.end, hi = 2 * j + 1 < a.end;
    s.ok[2 * q] = lo;
    s.ok[2 * q + 1] = hi;
    s.shift[2 * q] = 0;
    s.shift[2 * q + 1] = 4;
    const float* vp = a.values + 6 * j;
    if (hi && a.vec) {
      const float2* v2 = reinterpret_cast<const float2*>(vp);
      const float2 x = v2[0], y = v2[1], z = v2[2];
      s.v[2 * q][0] = x.x;
      s.v[2 * q][1] = x.y;
      s.v[2 * q][2] = y.x;
      s.v[2 * q + 1][0] = y.y;
      s.v[2 * q + 1][1] = z.x;
      s.v[2 * q + 1][2] = z.y;
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s.v[2 * q][k] = lo ? vp[k] : 0.0f;
        s.v[2 * q + 1][k] = hi ? vp[3 + k] : 0.0f;
      }
    }
    load_bins<kWord>(s, 2 * q, a, j, lo);
    s.w[2 * q + 1] = s.w[2 * q];
#pragma unroll
    for (int g = 0; g < kG; ++g) s.byte[2 * q + 1][g] = s.byte[2 * q][g];
  }
}

__device__ __forceinline__ void load_index(Index& ix, const int* rows, long long i0, long long end) {
#pragma unroll
  for (int jj = 0; jj < kRows; ++jj) {
    const long long i = i0 + jj * kThreads;
    ix.ok[jj] = i < end;
    ix.r[jj] = ix.ok[jj] ? (long long)rows[i] : 0;
  }
}

template <bool kWord>
__device__ __forceinline__ void load_rows(Step& s, const Args& a, const Index& ix) {
#pragma unroll
  for (int jj = 0; jj < kRows; ++jj) {
    const long long r = ix.r[jj];
    s.ok[jj] = ix.ok[jj];
    s.shift[jj] = (int)(r & 1) * 4;
    const float* vp = a.values + 3 * r;
#pragma unroll
    for (int k = 0; k < 3; ++k) s.v[jj][k] = ix.ok[jj] ? vp[k] : 0.0f;
    load_bins<kWord>(s, jj, a, r >> 1, ix.ok[jj]);
  }
}

template <bool kBf16, bool kWord>
__device__ __forceinline__ void add_step(float* mine, const Step& s) {
#pragma unroll
  for (int jj = 0; jj < kRows; ++jj) {
    if (!s.ok[jj]) continue;
    int b[kG];
    if (kWord) {
      const unsigned x = (s.w[jj] >> s.shift[jj]) & 0x0f0f0f0fu;
#pragma unroll
      for (int g = 0; g < kG; ++g) b[g] = (int)((x >> (8 * g)) & 0xffu);
    } else {
#pragma unroll
      for (int g = 0; g < kG; ++g) b[g] = (s.byte[jj][g] >> s.shift[jj]) & 15;
    }
    const float v[3] = {operand<kBf16>(s.v[jj][0]), operand<kBf16>(s.v[jj][1]),
                        operand<kBf16>(s.v[jj][2])};
    add_row(mine, b, v);
  }
}

// kPairs: rows == nullptr, whole row pairs a thread; kWord: see the header.
template <bool kBf16, bool kWord, bool kPairs>
__global__ void __launch_bounds__(kThreads, 2)
packed4_kernel(const uint8_t* __restrict__ bins, long long stride_f, long long stride_n,
               const float* __restrict__ values, const int* __restrict__ rows, long long n,
               int F, int B, long long rows_per_block, int groups, bool vec,
               float* __restrict__ out) {
  extern __shared__ float4 smem4[];  // [kG, kSlots, 3, kThreads] f32
  float* cells = reinterpret_cast<float*>(smem4);
  const int group = blockIdx.x % groups;
  const long long chunk = blockIdx.x / groups;
  const int f0 = group * kG;
  const int nf = min(kG, F - f0);
  const long long begin = chunk * rows_per_block;
  const Args a{bins + (long long)f0 * stride_f, stride_f, stride_n, values,
               min(begin + rows_per_block, n), nf, vec};
  // the first step's loads (the row indices, when given) are in flight
  // while the block zeroes its copies; then every step's loads are issued
  // before the previous step's adds
  Step cur, next;
  Index ix;
  // the thread's first row pair (kPairs) or first row
  long long i0 = kPairs ? begin / 2 + threadIdx.x : begin + threadIdx.x;
  if (kPairs) {
    load_pairs<kWord>(cur, a, i0);
  } else {
    load_index(ix, rows, i0, a.end);
  }
  // zero the cells the flush reads: slots < B of the group's features
  const int live4 = B * 3 * kThreads / 4;
  for (int g = 0; g < nf; ++g)
    for (int i = threadIdx.x; i < live4; i += kThreads)
      smem4[g * (kSlots * 3 * kThreads / 4) + i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  float* mine = cells + threadIdx.x;
  if (kPairs) {
    for (; 2 * i0 < a.end; i0 += kStep / 2) {
      load_pairs<kWord>(next, a, i0 + kStep / 2);
      add_step<kBf16, kWord>(mine, cur);
      cur = next;
    }
  } else {
    load_rows<kWord>(cur, a, ix);
    load_index(ix, rows, i0 + kStep, a.end);
    for (; i0 < a.end; i0 += kStep) {
      load_rows<kWord>(next, a, ix);
      load_index(ix, rows, i0 + 2 * kStep, a.end);
      add_step<kBf16, kWord>(mine, cur);
      cur = next;
    }
  }
  __syncthreads();

  // Warp w reduces the cells c = w (mod kWarps) of the group's [nf, B, 3],
  // kReduce at a time. It carries cell c as (feature g, rem = c - g * B * 3),
  // at copy offset (g * kSlots * 3 + rem) * kThreads, with no division and
  // no branch (B * 3 >= 3, so a step of kWarps wraps rem at most twice); a
  // cell past the live ones reads a clamped offset and is not flushed. After
  // the shuffles every lane holds every sum, and lane u flushes the u-th.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b3 = B * 3;
  const int live = nf * b3;
  float* o = out + (long long)f0 * b3;
  const bool one_chunk = gridDim.x == (unsigned)groups;
  int g = 0, rem = warp;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const bool wrap = rem >= b3;
    rem -= wrap ? b3 : 0;
    g += wrap;
  }
  for (int c0 = warp; c0 < live; c0 += kWarps * kReduce) {
    int at[kReduce];
#pragma unroll
    for (int u = 0; u < kReduce; ++u) {
      at[u] = (min(g, kG - 1) * kSlots * 3 + rem) * kThreads + lane;
      rem += kWarps;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const bool wrap = rem >= b3;
        rem -= wrap ? b3 : 0;
        g += wrap;
      }
    }
    float s[kReduce];
#pragma unroll
    for (int u = 0; u < kReduce; ++u) {
      const float* src = cells + at[u];
      s[u] = ((src[0] + src[32]) + src[64]) + src[96];
    }
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1)
#pragma unroll
      for (int u = 0; u < kReduce; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], m);
    float sum = s[0];
#pragma unroll
    for (int u = 1; u < kReduce; ++u) sum = lane == u ? s[u] : sum;
    const int c = c0 + lane * kWarps;
    if (lane < kReduce && c < live) {
      if (one_chunk) {
        o[c] = sum;
      } else if (sum != 0.0f) {
        atomicAdd(o + c, sum);
      }
    }
  }
}

using Kernel = decltype(&packed4_kernel<false, false, false>);

template <bool kBf16, bool kWord>
Kernel pick(bool pairs) {
  return pairs ? &packed4_kernel<kBf16, kWord, true> : &packed4_kernel<kBf16, kWord, false>;
}

// A bit per device for each of the 8 instantiations whose 96 KB opt-in is set.
unsigned opted_in[8];

}  // namespace

extern "C" {

// hist[F, B, 3] receives the histogram of n rows read from nibble-packed
// bins: bins[f, j] at bins + f * stride_f + j * stride_n holds row 2j in its
// low nibble and row 2j+1 in its high one; values is [N, 3] f32 row-major,
// not packed; rows (may be null: rows 0..n-1) holds n int32 row indices into
// both. With one chunk (n <= rows_per_block) every cell is stored, so out
// needs no zeroing; with more, the caller zeroes it and the chunks add into
// it. bf16 != 0 rounds the values to bf16 before they are added. The grid is
// ceil(F / 4) x ceil(n / rows_per_block) blocks; B <= 16; rows_per_block is
// a multiple of 512.
int lgbt_hist_packed4(const void* bins, long long stride_f, long long stride_n,
                      const void* values, const void* rows, long long n, int F, int B, int bf16,
                      long long rows_per_block, void* out, void* stream) {
  if (n <= 0 || F <= 0) return (int)cudaSuccess;
  if (B < 1 || B > kSlots || rows_per_block < kStep || rows_per_block % kStep != 0)
    return (int)cudaErrorInvalidValue;
  const long long groups = (F + kG - 1) / kG;
  const long long chunks = (n + rows_per_block - 1) / rows_per_block;
  if (groups * chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool word = stride_f == 1 && stride_n % 4 == 0 && F % kG == 0 &&
                    ((uintptr_t)bins & 3) == 0;
  const bool pairs = rows == nullptr;
  const Kernel kern = bf16 ? (word ? pick<true, true>(pairs) : pick<true, false>(pairs))
                           : (word ? pick<false, true>(pairs) : pick<false, false>(pairs));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  unsigned& opted = opted_in[(bf16 ? 4 : 0) + (word ? 2 : 0) + (pairs ? 1 : 0)];
  if (dev >= 32 || !(opted >> dev & 1u)) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) opted |= 1u << dev;
  }
  kern<<<(unsigned)(groups * chunks), kThreads, kSmem, (cudaStream_t)stream>>>(
      (const uint8_t*)bins, stride_f, stride_n, (const float*)values, (const int*)rows, n, F, B,
      rows_per_block, (int)groups, ((uintptr_t)values & 7) == 0, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
