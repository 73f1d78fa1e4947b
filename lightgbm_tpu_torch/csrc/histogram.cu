// Leaf histogram kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/hist_pallas.py:_histogram_pallas_fb
// (body _kernel_fb), entered through histogram_pallas. It computes the same
// function, hist[f, bins[f, r], k] += values[r, k] over the rows r of a leaf,
// but not the same way: the TPU kernel factors each bin into a radix pair and
// contracts one-hot tiles on the matrix unit because a TPU has no fast
// scatter. Hopper has fast shared-memory atomics, so every block scatters
// its rows into a sub-histogram in shared memory and flushes it once.
//
// What bounds it on the card: bytes. A root pass at 1M rows x 28 features
// reads 28 MB of bins and 12 MB of values, about 12 us at 3.35 TB/s. Most
// calls of a tree are small leaf segments (a median of about 4.5k rows at
// 1M x 28, B = 255), where a fixed cost per call and per block outweighs the
// bytes. The design:
//
// - A block owns one feature group of kG = 4 features and one chunk of rows.
//   Its [kG, B, 3] f32 sub-histogram lives in static shared memory, at most
//   4 x 336 x 12 = 16,128 bytes: under the 48 KB default, so the kernel needs
//   no opt-in attribute, and up to 8 blocks of 256 threads share an SM. A
//   group that holds fewer than kG features (the last one when F % 4 != 0)
//   masks the rest by a predicate, not by a run-time loop bound.
// - The grid is 1-D, groups x chunks blocks, the group varying fastest
//   (group = blockIdx.x % groups): the blocks that read the same rows run
//   side by side, and their repeated reads of a row's values and bin sector
//   hit L2. The launcher sizes a chunk (rows_per_block, from
//   ops/hist_kernel.py histogram_grid) at a multiple of 1024 rows aimed at
//   about four blocks per SM, so a 4.5k-row segment gets 35 blocks of 4
//   rows a thread and the 1M root 532 blocks of 13,312 rows.
// - Loads are hoisted ahead of the atomics. A step covers 1024 rows: thread
//   t takes rows base + t + 256 j, j < 4, loads all four rows' indices, then
//   their three values and kG bins, and only then makes its 4 x kG x 3
//   shared atomics, so the loads of four rows are in flight together. Every
//   loop over rows and features is unrolled at compile time and no register
//   array is indexed by a run-time value (which would spill). When the bins
//   are the [N, F] copy (stride_f = 1, 4-byte aligned rows, F % 4 == 0) a
//   row's kG bins are one 32-bit load.
// - The flush depends on the chunk count. With one chunk a block owns its
//   cells outright and stores every cell of its group, zeros included, with
//   plain stores. With more it adds its non-zero cells with atomicAdd whose
//   result is unused (RED); at the root that is about 1.6M global adds into
//   21,420 addresses (76 a cell).
//
// What the SASS shows (cuobjdump -sass of the sm_90a build): Hopper has no
// native shared-memory f32 add. Each shared atomicAdd is a compare-and-swap
// loop, LDS, FADD, ATOMS.CAST.SPIN, ISETP and a branch back, in this kernel
// as in the one it replaced; the flush's global add is a native
// REDG.E.ADD.F32. ptxas: 40 registers a thread on the one-word bin path, 50
// and 51 on the byte path, no spills. So a small segment waits on each
// thread's chain of 48 CAS loops, and the root on the shared atomics' rate;
// the design cuts the flush, the waits on loads and the idle SMs, not the
// count of shared adds.
//
// Features of few bins. A one-hot column sends most rows of a warp
// to one cell, and the CAS loops of those lanes serialise: at 581k x 54 with
// 44 two-bin columns the root took 1.9 ms against 0.22 ms at 1M x 28 x 255
// bins. Such tables take the entries' grouped form (kGroup, the ``_grouped``
// entries), which the host picks once a run from the binned table
// (ops/hist_kernel.py grouped_adds: some feature whose two random rows share
// a bin with a chance of at least 1/4); other tables keep the loop above,
// which pays nothing for it. In the grouped form each warp checks once, at
// its first step, whether at least kBusyLanes of its lanes share their bin
// with the next lane, feature by feature; a feature that does has its adds
// grouped for the rest of the block's rows: the lanes are grouped by bin
// with __match_any_sync, each group of at least kGroupLanes lanes is summed
// by a butterfly of shuffles and added by its first lane, smaller groups
// add lane by lane. Other features keep one atomicAdd a value. Its loop over
// rows runs while the warp's first row is in the chunk, so all 32 lanes
// take part in every shuffle.
//
// Two entries share the block's work (hist_block). lgbt_histogram takes
// its rows and grid from the host (the root, and every call of the host
// split loop). lgbt_histogram_segment serves the device-resident split
// loop (ops/grow.py grow_tree_device): it reads the smaller child's leaf
// index, begin and count from device memory, takes a grid fixed once a
// tree (the most chunks any segment can need) and derives the chunking of
// histogram_grid from the count on the device; blocks past the segment's
// chunks return at once. Its "one chunk stores outright" test is that
// device-side chunk count, and with more chunks it adds into the loop's
// scratch for the step, which the step before's split scan
// (csrc/split_pair.cu's folded entry) leaves zeroed.
//
// Sums are f32 in an order set by the atomics, so they differ between runs
// in the last bits; on values that are dyadic rationals with small exponents
// every order gives the same bits. The count channel is a sum of the mask
// column, exact up to 2^24 rows.
//
// bf16 operands (hist_dtype=bfloat16): each of a row's three values is
// rounded to bf16 (round to nearest even) before its f32 atomic add, the
// counterpart of the TPU kernel's bf16 matrix operands with f32 accumulation.
//
// Wide bins (the kWide instantiations, launched for int16 bins, 256 < B <=
// 1024). The JAX dataset stores int32 bins past 256 bins a feature; the
// port's card copy is int16 (half the bytes) and its TPU counterpart is the
// same radix kernel up to B = 336, XLA code above. The block is the same,
// reading two bytes a bin (a row's kG bins one 64-bit load on the word
// path), and its [kG, B, 3] cells live in dynamic shared memory sized by B:
// 48 KB at B = 1024, so the launcher raises the kernel's dynamic shared
// limit once, and 4 blocks of 256 threads share an SM there (8 up to B =
// 512). The byte instantiations keep their static cells and their code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kG = 4;                      // features per block
constexpr int kRows = 4;                   // rows per thread per step
constexpr int kStep = kThreads * kRows;    // rows per block per step
constexpr int kMaxBins = 336;         // byte bins: the static cells' width
constexpr int kMaxWideBins = 1024;    // int16 bins: dynamic cells sized by B
// the chunking of ops/hist_kernel.py histogram_grid: chunks of a multiple
// of kStep rows, at most kMaxChunk, aimed at kBlocksPerSm blocks an SM
constexpr long long kMaxChunk = 65536;
constexpr int kBlocksPerSm = 4;
constexpr int kActive = 0, kSmall = 5;  // slots of the loop's control vector (ops/grow_state.py)

// a bin of the byte or the int16 instantiations
template <bool kWide>
using Bin = std::conditional_t<kWide, int16_t, uint8_t>;

template <bool kBf16>
__device__ __forceinline__ float operand(float v) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// The grouped form (see the header): a warp groups a feature's adds
// (add_grouped) when at least kBusyLanes of its lanes share their bin with
// the next lane at its first step; a group of at least kGroupLanes lanes
// is summed before its one add. Copies of this file with other values
// build as older sources of obs/pair.py --kernel histogram_grid: on the
// Covertype-shaped table (an H100 SXM at 700 W) kBusyLanes 4 took the root
// in 0.28 ms, 8 in 0.40 and 16 in 0.63, the segments alike at 4 and 8 and
// twice as long at 16; kGroupLanes 2 and 4 alike, 8 slower (PERF.md).
constexpr int kBusyLanes = 4;
constexpr int kGroupLanes = 4;
constexpr unsigned kAll = 0xffffffffu;

// One warp's adds of a feature: each lane's row into cell ``bin`` of
// ``cells`` ([B, 3]; bin == B adds nothing). The lanes are grouped by bin
// (__match_any_sync); the values of each group of at least kGroupLanes
// lanes are summed by a butterfly of shuffles (the other lanes adding
// zeros) and its first lane makes the three adds (at most 32 / kGroupLanes
// butterflies); the lanes of smaller groups add one by one. Every lane of
// the warp must call it.
__device__ __forceinline__ void add_grouped(float* __restrict__ cells, int bin, int B,
                                            const float (&v)[3], int lane) {
  const unsigned peers = __match_any_sync(kAll, bin);
  const bool big = __popc(peers) >= kGroupLanes;
  unsigned leaders = __ballot_sync(kAll, big && lane == __ffs(peers) - 1 && bin < B);
  while (leaders) {
    const int first = __ffs(leaders) - 1;
    leaders &= leaders - 1;
    const bool in = (__shfl_sync(kAll, peers, first) >> lane) & 1u;
    float s0 = in ? v[0] : 0.0f, s1 = in ? v[1] : 0.0f, s2 = in ? v[2] : 0.0f;
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) {
      s0 += __shfl_xor_sync(kAll, s0, d);
      s1 += __shfl_xor_sync(kAll, s1, d);
      s2 += __shfl_xor_sync(kAll, s2, d);
    }
    if (lane == first) {
      float* c = cells + bin * 3;
      atomicAdd(c, s0);
      atomicAdd(c + 1, s1);
      atomicAdd(c + 2, s2);
    }
  }
  if (!big && bin < B) {
    float* c = cells + bin * 3;
    atomicAdd(c, v[0]);
    atomicAdd(c + 1, v[1]);
    atomicAdd(c + 2, v[2]);
  }
}

// The block's work, shared by both entries: feature group ``group`` over
// rows [chunk * rows_per_block, +rows_per_block) of the n rows (rows[i], or
// i when rows is null). ``owns``: the block is its group's only chunk, so
// it stores every cell of the group instead of adding into the output.
// kWord: the kG bins of a row are one aligned 32-bit word (64-bit: kWide)
// (see the header). kGroup: the grouped form for features of few bins (see
// the header). kWide: int16 bins, the cells in dynamic shared memory.
template <bool kBf16, bool kWord, bool kGroup, bool kWide>
__device__ __forceinline__ void hist_block(
    const Bin<kWide>* __restrict__ bins, long long stride_f, long long stride_n,
    const float* __restrict__ values, const int* __restrict__ rows, long long n, int F, int B,
    long long rows_per_block, int group, long long chunk, bool owns, float* __restrict__ out) {
  float* cells;  // [kG, B, 3]
  if constexpr (kWide) {
    extern __shared__ float wide_cells[];
    cells = wide_cells;
  } else {
    __shared__ float byte_cells[kG * kMaxBins * 3];
    cells = byte_cells;
  }
  const int f0 = group * kG;
  const int nf = min(kG, F - f0);
  for (int i = threadIdx.x; i < kG * B * 3; i += kThreads) cells[i] = 0.0f;
  __syncthreads();

  const long long begin = chunk * rows_per_block;
  const long long end = min(begin + rows_per_block, n);
  const Bin<kWide>* bg = bins + (long long)f0 * stride_f;
  const int lane = threadIdx.x & 31;
  bool grouped[kG] = {};  // per feature, set at the warp's first step (see kBusyLanes)
  bool first_step = kGroup;
  // grouped, the loop runs while the warp's first row is in the chunk, so
  // every lane of a warp takes every step (the grouped adds shuffle across
  // lanes); ok[] masks each lane's rows past the chunk
  const long long start = begin + (kGroup ? (threadIdx.x & ~31) : threadIdx.x);
  for (long long wbase = start; wbase < end; wbase += kStep) {
    const long long base = kGroup ? wbase + lane : wbase;
    bool ok[kRows];
    long long r[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const long long i = base + j * kThreads;
      ok[j] = i < end;
      r[j] = ok[j] ? (rows != nullptr ? (long long)rows[i] : i) : 0;
    }
    float v[kRows][3];
    int b[kRows][kG];  // B (never added) for a row past the chunk or a masked feature
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const float* vp = values + r[j] * 3;
#pragma unroll
      for (int k = 0; k < 3; ++k) v[j][k] = ok[j] ? operand<kBf16>(vp[k]) : 0.0f;
      const Bin<kWide>* bp = bg + r[j] * stride_n;
      if constexpr (kWord && kWide) {
        const uint2 w = ok[j] ? *reinterpret_cast<const uint2*>(bp) : make_uint2(0u, 0u);
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          b[j][g] = ok[j] ? (int)(((g < 2 ? w.x : w.y) >> (16 * (g & 1))) & 0xffffu) : B;
        }
      } else if (kWord) {
        const unsigned w = ok[j] ? *reinterpret_cast<const unsigned*>(bp) : 0u;
#pragma unroll
        for (int g = 0; g < kG; ++g) b[j][g] = ok[j] ? (int)((w >> (8 * g)) & 0xffu) : B;
      } else {
#pragma unroll
        for (int g = 0; g < kG; ++g) b[j][g] = ok[j] && g < nf ? (int)bp[g * stride_f] : B;
      }
    }
    if (kGroup && first_step) {
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const bool same = b[0][g] == __shfl_down_sync(kAll, b[0][g], 1) && lane < 31;
        grouped[g] = g < nf && __popc(__ballot_sync(kAll, same)) >= kBusyLanes;
      }
      first_step = false;
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if (kGroup && grouped[g]) {
          add_grouped(cells + g * B * 3, b[j][g], B, v[j], lane);
        } else if (b[j][g] < B) {
          float* c = cells + (g * B + b[j][g]) * 3;
          atomicAdd(c, v[j][0]);
          atomicAdd(c + 1, v[j][1]);
          atomicAdd(c + 2, v[j][2]);
        }
      }
    }
  }
  __syncthreads();

  float* o = out + (long long)f0 * B * 3;
  const int mine = nf * B * 3;
  if (owns) {  // one chunk: the block owns its cells
    for (int i = threadIdx.x; i < mine; i += kThreads) o[i] = cells[i];
  } else {
    for (int i = threadIdx.x; i < mine; i += kThreads) {
      const float c = cells[i];
      if (c != 0.0f) atomicAdd(o + i, c);
    }
  }
}

template <bool kBf16, bool kWord, bool kGroup, bool kWide>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const Bin<kWide>* __restrict__ bins, long long stride_f,
            long long stride_n, const float* __restrict__ values,
            const int* __restrict__ rows, long long n, int F, int B,
            long long rows_per_block, int groups, float* __restrict__ out) {
  hist_block<kBf16, kWord, kGroup, kWide>(bins, stride_f, stride_n, values, rows, n, F, B,
                                          rows_per_block, blockIdx.x % groups,
                                          blockIdx.x / groups, gridDim.x == (unsigned)groups,
                                          out);
}

// The segment entry of the device-resident split loop: the rows are
// order[begin, begin + count) of leaf ctl[kSmall], all three read from
// device memory, and the chunking is ops/hist_kernel.py histogram_grid's,
// derived here from that count. The grid is fixed by the caller (groups x
// the most chunks any segment of the run can need); blocks past this
// segment's chunks return at once, and so does every block once the loop
// has stopped (ctl[kActive] == 0). One chunk stores its group's cells
// outright; more add into ``out``, which the caller keeps zeroed.
template <bool kBf16, bool kWord, bool kGroup, bool kWide>
__global__ void __launch_bounds__(kThreads)
hist_segment_kernel(const Bin<kWide>* __restrict__ bins, long long stride_f,
                    long long stride_n, const float* __restrict__ values,
                    const int* __restrict__ order, const int* __restrict__ ctl,
                    const int* __restrict__ leaf_begin, const int* __restrict__ leaf_count,
                    int F, int B, int groups, int num_sms, float* __restrict__ out) {
  if (!ctl[kActive]) return;
  const int leaf = ctl[kSmall];
  const long long n = leaf_count[leaf];
  const long long slots = (long long)kBlocksPerSm * num_sms;
  const long long want = (n * groups + slots - 1) / slots;
  const long long rows_per_block =
      min(max((want + kStep - 1) / kStep * kStep, (long long)kStep), kMaxChunk);
  const long long chunks = (n + rows_per_block - 1) / rows_per_block;
  const long long chunk = blockIdx.x / groups;
  if (chunk >= chunks) return;
  hist_block<kBf16, kWord, kGroup, kWide>(bins, stride_f, stride_n, values,
                                          order + leaf_begin[leaf], n, F, B, rows_per_block,
                                          blockIdx.x % groups, chunk, chunks == 1, out);
}

// kWide: a row's kG int16 bins are one aligned 64-bit word
bool word_bins(const void* bins, long long stride_f, long long stride_n, int F, bool wide) {
  const uintptr_t align = wide ? 7 : 3;
  return stride_f == 1 && stride_n % 4 == 0 && F % kG == 0 && ((uintptr_t)bins & align) == 0;
}

// The flags of every C entry: bit 0 bf16 operands, bit 1 int16 bins (kWide).
constexpr int kFlagBf16 = 1, kFlagWide = 2;

// Raise a kWide kernel's dynamic shared memory limit to its widest cells
// (48 KB at B = 1024) once, at its first launch: the first iteration of a
// captured boosting loop is eager, so no captured launch asks for it.
cudaError_t allow_wide_cells(const void* kern) {
  static const void* raised[32];
  static int count = 0;
  for (int i = 0; i < count; ++i) {
    if (raised[i] == kern) return cudaSuccess;
  }
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kG * kMaxWideBins * 3 * (int)sizeof(float));
  if (err == cudaSuccess && count < 32) raised[count++] = kern;
  return err;
}

template <bool kGroup, bool kWide>
int launch_histogram(const void* bins, long long stride_f, long long stride_n,
                     const void* values, const void* rows, long long n, int F, int B, int flags,
                     long long rows_per_block, void* out, void* stream) {
  if (n <= 0 || F <= 0) return (int)cudaSuccess;
  if (B < 1 || B > (kWide ? kMaxWideBins : kMaxBins) || rows_per_block < 1)
    return (int)cudaErrorInvalidValue;
  const long long groups = (F + kG - 1) / kG;
  const long long chunks = (n + rows_per_block - 1) / rows_per_block;
  if (groups * chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool word = word_bins(bins, stride_f, stride_n, F, kWide);
  decltype(&hist_kernel<false, false, kGroup, kWide>) kern =
      (flags & kFlagBf16)
          ? (word ? &hist_kernel<true, true, kGroup, kWide> : &hist_kernel<true, false, kGroup, kWide>)
          : (word ? &hist_kernel<false, true, kGroup, kWide>
                  : &hist_kernel<false, false, kGroup, kWide>);
  int shared = 0;
  if (kWide) {
    const cudaError_t err = allow_wide_cells((const void*)kern);
    if (err != cudaSuccess) return (int)err;
    shared = kG * B * 3 * (int)sizeof(float);
  }
  kern<<<(unsigned)(groups * chunks), kThreads, shared, (cudaStream_t)stream>>>(
      (const Bin<kWide>*)bins, stride_f, stride_n, (const float*)values,
      (const int*)rows, n, F, B, rows_per_block, (int)groups, (float*)out);
  return (int)cudaGetLastError();
}

template <bool kGroup, bool kWide>
int launch_segment(const void* bins, long long stride_f, long long stride_n,
                   const void* values, const void* order, const void* ctl,
                   const void* leaf_begin, const void* leaf_count, int F, int B, int flags,
                   int num_sms, int max_chunks, void* out, void* stream) {
  if (F <= 0) return (int)cudaSuccess;
  if (B < 1 || B > (kWide ? kMaxWideBins : kMaxBins) || num_sms < 1 || max_chunks < 1)
    return (int)cudaErrorInvalidValue;
  const long long groups = (F + kG - 1) / kG;
  if (groups * max_chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool word = word_bins(bins, stride_f, stride_n, F, kWide);
  decltype(&hist_segment_kernel<false, false, kGroup, kWide>) kern =
      (flags & kFlagBf16) ? (word ? &hist_segment_kernel<true, true, kGroup, kWide>
                                  : &hist_segment_kernel<true, false, kGroup, kWide>)
                          : (word ? &hist_segment_kernel<false, true, kGroup, kWide>
                                  : &hist_segment_kernel<false, false, kGroup, kWide>);
  int shared = 0;
  if (kWide) {
    const cudaError_t err = allow_wide_cells((const void*)kern);
    if (err != cudaSuccess) return (int)err;
    shared = kG * B * 3 * (int)sizeof(float);
  }
  kern<<<(unsigned)(groups * max_chunks), kThreads, shared, (cudaStream_t)stream>>>(
      (const Bin<kWide>*)bins, stride_f, stride_n, (const float*)values, (const int*)order,
      (const int*)ctl, (const int*)leaf_begin, (const int*)leaf_count, F, B, (int)groups,
      num_sms, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// hist[F, B, 3], zeroed by the caller, receives the histogram of n rows:
// with one chunk (n <= rows_per_block) each block stores its cells, so the
// output is assigned, not added to; with more, the chunks add into it.
// bins[f, r] lives at bins + f * stride_f + r * stride_n (in bins, not
// bytes); values is [N, 3] f32 row-major; rows (may be null) holds n int32
// row indices into both. flags: bit 0 rounds the values to bf16 before
// they are added, bit 1 reads int16 bins (B <= 1024; else uint8, B <= 336).
// The grid is ceil(F / 4) x ceil(n / rows_per_block) blocks.
int lgbt_histogram(const void* bins, long long stride_f, long long stride_n,
                   const void* values, const void* rows, long long n, int F,
                   int B, int flags, long long rows_per_block, void* out,
                   void* stream) {
  return (flags & kFlagWide)
             ? launch_histogram<false, true>(bins, stride_f, stride_n, values, rows, n, F, B,
                                             flags, rows_per_block, out, stream)
             : launch_histogram<false, false>(bins, stride_f, stride_n, values, rows, n, F, B,
                                              flags, rows_per_block, out, stream);
}

// lgbt_histogram's grouped form, for tables with features of few bins (see
// the header); the same arguments and output.
int lgbt_histogram_grouped(const void* bins, long long stride_f, long long stride_n,
                           const void* values, const void* rows, long long n, int F,
                           int B, int flags, long long rows_per_block, void* out,
                           void* stream) {
  return (flags & kFlagWide)
             ? launch_histogram<true, true>(bins, stride_f, stride_n, values, rows, n, F, B,
                                            flags, rows_per_block, out, stream)
             : launch_histogram<true, false>(bins, stride_f, stride_n, values, rows, n, F, B,
                                             flags, rows_per_block, out, stream);
}

// The segment entry (hist_segment_kernel): out [F, B, 3], zeroed by the
// caller, receives the histogram of order[leaf_begin[l] : + leaf_count[l]]
// for the leaf l = ctl[5], all read from device memory; nothing once ctl[0]
// is 0. The grid is ceil(F / 4) x max_chunks blocks, max_chunks the most
// chunks a segment of the run can need (ops/hist_kernel.py
// segment_max_chunks); num_sms sets the chunking as histogram_grid's does.
// flags as lgbt_histogram's. A histogram pool's step passes a second
// control vector as ctl to build the larger child (ops/grow_state.py).
int lgbt_histogram_segment(const void* bins, long long stride_f, long long stride_n,
                           const void* values, const void* order, const void* ctl,
                           const void* leaf_begin, const void* leaf_count, int F, int B,
                           int flags, int num_sms, int max_chunks, void* out, void* stream) {
  return (flags & kFlagWide)
             ? launch_segment<false, true>(bins, stride_f, stride_n, values, order, ctl,
                                           leaf_begin, leaf_count, F, B, flags, num_sms,
                                           max_chunks, out, stream)
             : launch_segment<false, false>(bins, stride_f, stride_n, values, order, ctl,
                                            leaf_begin, leaf_count, F, B, flags, num_sms,
                                            max_chunks, out, stream);
}

// lgbt_histogram_segment's grouped form; the same arguments and output.
int lgbt_histogram_segment_grouped(const void* bins, long long stride_f, long long stride_n,
                                   const void* values, const void* order, const void* ctl,
                                   const void* leaf_begin, const void* leaf_count, int F,
                                   int B, int flags, int num_sms, int max_chunks, void* out,
                                   void* stream) {
  return (flags & kFlagWide)
             ? launch_segment<true, true>(bins, stride_f, stride_n, values, order, ctl,
                                          leaf_begin, leaf_count, F, B, flags, num_sms,
                                          max_chunks, out, stream)
             : launch_segment<true, false>(bins, stride_f, stride_n, values, order, ctl,
                                           leaf_begin, leaf_count, F, B, flags, num_sms,
                                           max_chunks, out, stream);
}

}  // extern "C"
