// Fixed-order leaf histogram for Hopper (sm_90a): the oracle kernel.
//
// Replaces the TPU kernel lightgbm_tpu/ops/hist_pallas.py:301
// histogram_pallas_v1 (body _kernel :144), the per-feature-grid radix kernel
// that the JAX package keeps as the differential oracle of its feature-
// batched kernel. It computes the same function, hist[f, b, k] = sum of
// values[r, k] over the rows r (rows[i], or i) whose bin of feature f is b,
// for b < B; a bin >= B adds nothing. Here it is the oracle of
// csrc/histogram.cu, shares no code with it and is not routed. The TPU runs
// its grid in order, chunk after chunk into one output block, so its sums
// have one order; this kernel has one order too, and its bits are a
// function of (n, F, B, rows, SM count) only.
//
// What bounds it on the card: bytes. A root pass at 1M rows x 28 features
// has to read 28 MB of bins and 12 MB of values, 0.012 ms at 3.35 TB/s
// (H100 SXM data sheet). The first port (one feature a block, fixed
// 16384-row chunks, shared and global atomics) missed that by 20x: 28
// blocks at any segment up to 16384 rows; one serial chain a thread of
// dependent loads and CAS-loop atomics (ATOMS.CAST.SPIN), 64 rows deep;
// at the root each block read one byte of every 28 it pulled (a warp's bins
// lie 28 bytes apart in the grower's [N, F] copy) and the values once per
// feature; and bits that changed from run to run. This design reads each
// byte once per group, but on the H100 its time is set by the SM's
// throughput for __match_any_sync (one per 32 row-features) and by the bank
// conflicts of 32 random cell updates per shared access, not by bytes: the
// root takes about 24x its bytes bound (PERF.md). The design:
//
// 1. A block owns kG = 16 features and one chunk of rows, with 256 threads
//    (8 warps). Warp w owns the group's features w and w + 8, so only one
//    warp ever writes a feature's [B, 3] f32 histogram, which lives in
//    dynamic shared memory (kG B 12 bytes: 48,960 at B = 255, 64,512 at
//    B = 336; the opt-in is set once per instantiation and device). The
//    grid is 1-D, groups x chunks, the group varying fastest so the blocks
//    that read the same rows run side by side. rows_per_block
//    (ops/hist_kernel.py v1_grid) is a multiple of kT rows aimed at one
//    wave of two blocks an SM: the 1M-row root gets 2 x 131 blocks, a
//    100k-row segment 2 x 98, where the old grid gave 28 x 62 and 28 x 7.
// 2. Each tile of kT = 512 rows is staged once for all the group's
//    features, one tile ahead, in the other of two shared stages while the
//    warps fold the current one; the row indices of the tile after it wait
//    in registers. The values (3 words a row, at a row stride of 3 words)
//    always go by 4-byte cp.async. On the word path (stride_f == 1,
//    stride_n % 4 == 0, F % 4 == 0, 4-byte aligned bins: the grower's
//    [N, F] copy) a row's 16 group bins are 4 words, also copied by
//    cp.async, and stored at a row stride of kBinWords = 5 words, so a warp
//    reading one feature's byte of 32 consecutive rows hits 32 banks
//    (gcd(5, 32) = 1). On the byte path (any other strides) the bins are
//    loaded into registers a tile ahead and stored to the stage after the
//    fold. Bins and values cross L2 once per group (twice at F = 28), not
//    once per feature.
// 3. Each feature is folded in row order with no atomics. A warp takes a
//    tile 32 rows a step, lane i on row i of the step, steps ascending. It
//    reads its feature's 32 bins from the stage and calls __match_any_sync
//    on them; a lane past the tile's rows, or with a bin >= B, gets a key of
//    its own (256 + lane) and adds nothing. The lowest lane of each peer set
//    loads the 3 cells, adds its own values and then its peers' (read from
//    the stage) in ascending lane order, and stores the 3 cells back: plain
//    LDS, FADD and STS. So within a block every cell is the plain left fold
//    of its rows in the order of the rows vector, the order of the plain
//    version's CPU index_add_. The chain of a step is a few shared accesses,
//    not a chain of global loads and CAS loops.
// 4. Chunks are reduced in a fixed order. With one chunk the block stores
//    every cell of its group, zeros included, straight into the output.
//    With more, each block stores its partial into a [chunks, F, B, 3] f32
//    scratch, and v1_reduce_kernel, launched by the same C entry on the same
//    stream, gives one thread each output cell and sums chunks 0..C-1 in
//    order, from 0. The caller allocates the output and the scratch
//    uninitialised: every cell is stored. No atomic of any kind remains.
//
// bf16 operands round each value to bf16 (nearest even) before its f32 add.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kG = 16;         // features per block, two per warp
constexpr int kT = 512;        // rows per tile
constexpr int kBinWords = 5;   // row stride of a stage's bins, in words
constexpr int kMaxBins = 336;
constexpr int kRowsPerThread = kT / kThreads;            // rows a thread stages
constexpr int kStageWords = kT * (kBinWords + 3);        // bins, then values
constexpr int kMaxSmem = kG * kMaxBins * 12 + 2 * kStageWords * 4;  // 97,280 bytes

template <bool kBf16>
__device__ __forceinline__ float operand(float v) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ void copy4(void* smem_dst, const void* src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Args {
  const uint8_t* bins;  // at the group's first feature
  long long stride_f, stride_n;
  const float* values;
  int nf;  // the group's features (kG but in a short last group)
};

// The rows thread t stages of one tile: tile rows t and t + kThreads.
struct Tile {
  long long r[kRowsPerThread];
  bool ok[kRowsPerThread];
};

__device__ __forceinline__ void tile_rows(Tile& t, const int* rows, long long first, long long end) {
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const long long i = first + threadIdx.x + j * kThreads;
    t.ok[j] = i < end;
    t.r[j] = !t.ok[j] ? 0 : rows != nullptr ? (long long)rows[i] : i;
  }
}

// The tile's values and, on the word path, its bins, by cp.async.
template <bool kWord>
__device__ __forceinline__ void stage_async(unsigned* stage, const Tile& t, const Args& a) {
  float* sv = reinterpret_cast<float*>(stage + kT * kBinWords);
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    if (!t.ok[j]) continue;
    const int i = threadIdx.x + j * kThreads;
    const float* vp = a.values + 3 * t.r[j];
#pragma unroll
    for (int k = 0; k < 3; ++k) copy4(sv + 3 * i + k, vp + k);
    if (kWord) {
      const unsigned* bp = reinterpret_cast<const unsigned*>(a.bins + t.r[j] * a.stride_n);
#pragma unroll
      for (int w = 0; w < kG / 4; ++w)
        if (4 * w < a.nf) copy4(stage + kBinWords * i + w, bp + w);
    }
  }
}

// The byte path's bins of one tile, in registers until the previous fold ends.
struct Bytes {
  unsigned char b[kRowsPerThread][kG];
};

__device__ __forceinline__ void load_bytes(Bytes& by, const Tile& t, const Args& a) {
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const uint8_t* bp = a.bins + t.r[j] * a.stride_n;
#pragma unroll
    for (int g = 0; g < kG; ++g)
      by.b[j][g] = t.ok[j] && g < a.nf ? bp[g * a.stride_f] : 0;
  }
}

__device__ __forceinline__ void store_bytes(unsigned* stage, const Bytes& by, const Tile& t, int nf) {
  unsigned char* sb = reinterpret_cast<unsigned char*>(stage);
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    if (!t.ok[j]) continue;
    const int i = threadIdx.x + j * kThreads;
#pragma unroll
    for (int g = 0; g < kG; ++g)
      if (g < nf) sb[4 * kBinWords * i + g] = by.b[j][g];
  }
}

// Warp w folds the tile's first ``count`` rows of the stage into the cells
// of features w and w + kWarps (design point 3).
template <bool kBf16>
__device__ __forceinline__ void fold_tile(float* cells, const unsigned* stage, int count, int nf,
                                          int B) {
  const unsigned char* sb = reinterpret_cast<const unsigned char*>(stage);
  const float* sv = reinterpret_cast<const float*>(stage + kT * kBinWords);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const bool second = warp + kWarps < nf;  // warp-uniform
  if (warp >= nf) return;
  for (int s = 0; s < count; s += 32) {
    const int i = s + lane;
    const bool ok = i < count;
    const float v[3] = {operand<kBf16>(sv[3 * i]), operand<kBf16>(sv[3 * i + 1]),
                        operand<kBf16>(sv[3 * i + 2])};
    int b[2];
    bool live[2];
    unsigned peers[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      b[q] = q == 0 || second ? sb[4 * kBinWords * i + warp + kWarps * q] : 0;
      live[q] = ok && (q == 0 || second) && b[q] < B;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q)
      peers[q] = __match_any_sync(0xffffffffu, live[q] ? (unsigned)b[q] : 256u + lane);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (live[q] && (peers[q] & below) == 0u) {
        float* c = cells + ((warp + kWarps * q) * B + b[q]) * 3;
        float c0 = c[0] + v[0], c1 = c[1] + v[1], c2 = c[2] + v[2];
        for (unsigned m = peers[q] & (peers[q] - 1u); m != 0u; m &= m - 1u) {
          const float* p = sv + 3 * (s + __ffs(m) - 1);
          c0 += operand<kBf16>(p[0]);
          c1 += operand<kBf16>(p[1]);
          c2 += operand<kBf16>(p[2]);
        }
        c[0] = c0;
        c[1] = c1;
        c[2] = c2;
      }
    }
    __syncwarp();  // the next step's leaders read these cells
  }
}

template <bool kBf16, bool kWord>
__global__ void __launch_bounds__(kThreads, 2)
v1_kernel(const uint8_t* __restrict__ bins, long long stride_f, long long stride_n,
          const float* __restrict__ values, const int* __restrict__ rows, long long n, int F,
          int B, long long rows_per_block, int groups, float* __restrict__ dst) {
  extern __shared__ float4 smem4[];  // 2 stages of [kT, 5] bin words + [kT, 3] values; cells
  unsigned* smem = reinterpret_cast<unsigned*>(smem4);
  float* cells = reinterpret_cast<float*>(smem + 2 * kStageWords);  // [nf, B, 3]
  const int group = blockIdx.x % groups;
  const long long chunk = blockIdx.x / groups;
  const int f0 = group * kG;
  const int nf = min(kG, F - f0);
  const long long begin = chunk * rows_per_block;
  const long long end = min(begin + rows_per_block, n);
  const int tiles = (int)((end - begin + kT - 1) / kT);
  const Args a{bins + (long long)f0 * stride_f, stride_f, stride_n, values, nf};

  // tile 0 goes to stage 0 while the cells are zeroed; tile 1's rows wait
  Tile cur, next;
  Bytes by;
  tile_rows(cur, rows, begin, end);
  tile_rows(next, rows, begin + kT, end);
  stage_async<kWord>(smem, cur, a);
  copy_commit();
  if (!kWord) {
    load_bytes(by, cur, a);
    store_bytes(smem, by, cur, nf);
  }
  for (int i = threadIdx.x; i < nf * B * 3; i += kThreads) cells[i] = 0.0f;

  for (int t = 0; t < tiles; ++t) {
    // tile t has landed, and every warp is done with stage (t + 1) & 1
    copy_wait();
    __syncthreads();
    unsigned* stage = smem + (t & 1) * kStageWords;
    unsigned* other = smem + ((t + 1) & 1) * kStageWords;
    const bool more = t + 1 < tiles;
    if (more) {
      stage_async<kWord>(other, next, a);
      copy_commit();
      if (!kWord) load_bytes(by, next, a);
      cur = next;
      tile_rows(next, rows, begin + (long long)(t + 2) * kT, end);
    }
    fold_tile<kBf16>(cells, stage, (int)min((long long)kT, end - begin - (long long)t * kT), nf, B);
    if (!kWord && more) store_bytes(other, by, cur, nf);
  }
  __syncthreads();

  // the group's [nf, B, 3] cells, zeros included: the output (one chunk) or
  // this chunk's partial in the scratch
  float* o = dst + (chunk * F + f0) * (long long)B * 3;
  for (int i = threadIdx.x; i < nf * B * 3; i += kThreads) o[i] = cells[i];
}

// out[c] = sum over chunks 0..C-1, in order, of the partials' cell c.
__global__ void __launch_bounds__(kThreads)
v1_reduce_kernel(const float* __restrict__ scratch, long long cells, int chunks,
                 float* __restrict__ out) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= cells) return;
  float s = 0.0f;
#pragma unroll 8
  for (int k = 0; k < chunks; ++k) s += scratch[k * cells + c];
  out[c] = s;
}

using Kernel = decltype(&v1_kernel<false, false>);

// A bit per device for each of the 4 instantiations whose opt-in is set.
unsigned opted_in[4];

}  // namespace

extern "C" {

// hist[F, B, 3] receives the histogram of n rows: bins[f, r] at bins +
// f * stride_f + r * stride_n (uint8), values [N, 3] f32 row-major, rows (may
// be null: rows 0..n-1) n int32 row indices into both. The grid is ceil(F /
// 16) x ceil(n / rows_per_block) blocks; rows_per_block is a multiple of
// 512; B <= 336. With one chunk the blocks store every cell of out; with
// more they store [chunks, F, B, 3] partials into scratch and a second
// kernel sums them into out. Neither needs zeroing. bf16 != 0 rounds the
// values to bf16 before they are added.
int lgbt_hist_v1(const void* bins, long long stride_f, long long stride_n, const void* values,
                 const void* rows, long long n, int F, int B, int bf16, long long rows_per_block,
                 void* scratch, void* out, void* stream) {
  if (n <= 0 || F <= 0) return (int)cudaSuccess;
  if (B < 1 || B > kMaxBins || rows_per_block < kT || rows_per_block % kT != 0)
    return (int)cudaErrorInvalidValue;
  const long long groups = (F + kG - 1) / kG;
  const long long chunks = (n + rows_per_block - 1) / rows_per_block;
  if (groups * chunks > 0x7fffffffLL || (chunks > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool word = stride_f == 1 && stride_n % 4 == 0 && F % 4 == 0 &&
                    ((uintptr_t)bins & 3) == 0;
  const Kernel kern = bf16 ? (word ? &v1_kernel<true, true> : &v1_kernel<true, false>)
                           : (word ? &v1_kernel<false, true> : &v1_kernel<false, false>);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  unsigned& opted = opted_in[(bf16 ? 2 : 0) + (word ? 1 : 0)];
  if (dev >= 32 || !(opted >> dev & 1u)) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) opted |= 1u << dev;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const int smem = kG * B * 12 + 2 * kStageWords * 4;
  kern<<<(unsigned)(groups * chunks), kThreads, smem, s>>>(
      (const uint8_t*)bins, stride_f, stride_n, (const float*)values, (const int*)rows, n, F, B,
      rows_per_block, (int)groups, (float*)(chunks == 1 ? out : scratch));
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return (int)err;
  const long long cells = (long long)F * B * 3;
  v1_reduce_kernel<<<(unsigned)((cells + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      (const float*)scratch, cells, (int)chunks, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
