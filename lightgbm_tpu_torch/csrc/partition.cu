// Stable partition of one leaf's row segment for Hopper (sm_90a), the
// partition step of the device-resident split loop (ops/grow.py
// grow_tree_device).
//
// Counterpart of lightgbm_tpu/ops/grow.py partition_batch / apply_split's
// partition_segment: the rows order[begin : begin + count] of the split leaf
// are reordered stably into [left | right] by the picked split's numerical
// decision (dense_bin.hpp Split: bin <= threshold, the missing bin going to
// default_left), so the segment keeps the reference's [pre | left | right |
// post] layout. Every bound and index is read from device memory: the leaf
// from ctl[kBest], (feature, threshold, default_left) from its record in
// best_i, the feature's missing_type / default_bin / num_bin, and the
// segment's (begin, count) from leaf_begin / leaf_count. It writes the
// children's (begin, count) back there, so no host round trip sizes
// anything. Equal, element for element, to the plain version
// ops/partition.py ``stable_partition`` (torch.cat([seg[gl], seg[~gl]])).
//
// What bounds it: bytes, and at small segments the three launches. A split
// of n rows must read n row indices (4 B) and n bins of one feature (1 B,
// gathered) and write n indices: 9 n bytes, 2.7 us at the 1M-row root on
// 3.35 TB/s. The design is the simple right one, a grid sized from the SM
// count that strides over 1024-row tiles of a segment whose length only the
// device knows:
//  1. count: each tile's rows are decided once; the decisions go to a byte
//     array and the rows to a scratch copy of the segment, and the tile's
//     left count (four __syncthreads_count) to tiles[t];
//  2. scan: one block turns tiles[] into exclusive left offsets, and writes
//     the left count and the children's (begin, count);
//  3. scatter: each tile ranks its rows by warp ballots (striped: element
//     j * 256 + thread of a tile), the left ones after the lefts of earlier
//     tiles and rows, the right ones after all lefts, and writes them from
//     the scratch copy back into order.
// Once ctl[kActive] is 0 (the loop has stopped) every pass returns at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;                  // rows a thread a tile
constexpr int kTile = kThreads * kItems;   // rows a tile
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
// slots of the loop's control vector (ops/grow_state.py)
constexpr int kActive = 0, kBest = 3, kNew = 4, kPBegin = 7, kPCount = 8, kLeft = 9;
constexpr int kMissingZero = 1, kMissingNan = 2;

__device__ __forceinline__ bool go_left(int col, int thr, bool dl, int miss, int dbin,
                                        int nan_bin) {
  bool gl = col <= thr;
  if (miss == kMissingZero) {
    if (col == dbin) gl = dl;
  } else if (miss == kMissingNan) {
    if (col == nan_bin) gl = dl;
  }
  return gl;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ bins, long long stride_f, long long stride_n,
             const int* __restrict__ order, int* __restrict__ scratch,
             uint8_t* __restrict__ flags, int* __restrict__ tiles, const int* __restrict__ ctl,
             const int* __restrict__ best_i, const int* __restrict__ missing,
             const int* __restrict__ default_bin, const int* __restrict__ num_bin,
             const int* __restrict__ leaf_begin, const int* __restrict__ leaf_count) {
  if (!ctl[kActive]) return;
  const int leaf = ctl[kBest];
  const long long b0 = leaf_begin[leaf];
  const int cnt = leaf_count[leaf];
  const int ntiles = (cnt + kTile - 1) / kTile;
  if ((int)blockIdx.x >= ntiles) return;
  const int f = best_i[leaf * 4 + 0], thr = best_i[leaf * 4 + 1];
  const bool dl = best_i[leaf * 4 + 3] != 0;
  const int miss = missing[f], dbin = default_bin[f], nan_bin = num_bin[f] - 1;
  const uint8_t* col = bins + (long long)f * stride_f;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    int row[kItems];
    bool ok[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = t * kTile + j * kThreads + threadIdx.x;
      ok[j] = i < cnt;
      row[j] = ok[j] ? order[b0 + i] : 0;
    }
    int bin[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) bin[j] = ok[j] ? (int)col[row[j] * stride_n] : 0;
    int left = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = t * kTile + j * kThreads + threadIdx.x;
      const bool gl = ok[j] && go_left(bin[j], thr, dl, miss, dbin, nan_bin);
      if (ok[j]) {
        flags[b0 + i] = gl ? 1 : 0;
        scratch[b0 + i] = row[j];
      }
      left += __syncthreads_count(gl);
    }
    if (threadIdx.x == 0) tiles[t] = left;
  }
}

// Exclusive scan of the tiles' left counts in one block, then the
// children's bounds: leaf ctl[kBest] keeps [b0, b0 + left), the new leaf
// ctl[kNew] takes [b0 + left, b0 + count).
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int* __restrict__ tiles, int* __restrict__ ctl, int* __restrict__ leaf_begin,
            int* __restrict__ leaf_count) {
  __shared__ int warp_total[kScanThreads / 32];
  __shared__ int carry;
  if (!ctl[kActive]) return;
  const int leaf = ctl[kBest], nl = ctl[kNew];
  const int b0 = leaf_begin[leaf], cnt = leaf_count[leaf];
  const int ntiles = (cnt + kTile - 1) / kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < ntiles; base += kScanThreads) {
    const int t = base + threadIdx.x;
    const int v = t < ntiles ? tiles[t] : 0;
    int incl = v;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, s);
      if (lane >= s) incl += o;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    int before = carry;
    for (int w = 0; w < warp; ++w) before += warp_total[w];
    if (t < ntiles) tiles[t] = before + incl - v;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry = before + incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const int left = carry;
    ctl[kPBegin] = b0;
    ctl[kPCount] = cnt;
    ctl[kLeft] = left;
    leaf_count[leaf] = left;
    leaf_begin[nl] = b0 + left;
    leaf_count[nl] = cnt - left;
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(int* __restrict__ order, const int* __restrict__ scratch,
               const uint8_t* __restrict__ flags, const int* __restrict__ tiles,
               const int* __restrict__ ctl) {
  __shared__ int wcount[kItems][kWarps];
  if (!ctl[kActive]) return;
  const long long b0 = ctl[kPBegin];
  const int cnt = ctl[kPCount], total_left = ctl[kLeft];
  const int ntiles = (cnt + kTile - 1) / kTile;
  if ((int)blockIdx.x >= ntiles) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    int row[kItems], rank[kItems];
    bool ok[kItems], gl[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = t * kTile + j * kThreads + threadIdx.x;
      ok[j] = i < cnt;
      gl[j] = ok[j] && flags[b0 + i] != 0;
      row[j] = ok[j] ? scratch[b0 + i] : 0;
      const unsigned vote = __ballot_sync(kFull, gl[j]);
      rank[j] = __popc(vote & lower);
      if (lane == 0) wcount[j][warp] = __popc(vote);
    }
    __syncthreads();
    int before_row = tiles[t];  // lefts of the earlier tiles
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      int before = before_row;
      for (int w = 0; w < warp; ++w) before += wcount[j][w];
      for (int w = 0; w < kWarps; ++w) before_row += wcount[j][w];
      if (ok[j]) {
        const int i = t * kTile + j * kThreads + threadIdx.x;
        const int left_before = before + rank[j];
        const int pos = gl[j] ? left_before : total_left + (i - left_before);
        order[b0 + pos] = row[j];
      }
    }
    __syncthreads();  // wcount is rewritten by the next tile
  }
}

}  // namespace

extern "C" {

// Stably partition the segment of leaf ctl[3] (the split leaf) of order
// [N] int32 by the split record best_i[leaf] = (feature, threshold, num_cat,
// default_left), the feature's bins at bins + f * stride_f + row * stride_n
// and its missing_type / default_bin / num_bin [F] int32. Writes
// leaf_count[leaf], leaf_begin / leaf_count[ctl[4]] and ctl[7..9] (the
// parent's begin and count, the left count). Scratch: scratch [N] int32,
// flags [N] bytes, tiles [ceil(N / 1024)] int32. grid blocks of 256
// threads stride over the tiles. Does nothing once ctl[0] is 0.
int lgbt_partition(const void* bins, long long stride_f, long long stride_n, void* order,
                   void* scratch, void* flags, void* tiles, void* ctl, const void* best_i,
                   const void* missing, const void* default_bin, const void* num_bin,
                   void* leaf_begin, void* leaf_count, int grid, void* stream) {
  if (grid < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  count_kernel<<<grid, kThreads, 0, s>>>(
      (const uint8_t*)bins, stride_f, stride_n, (const int*)order, (int*)scratch,
      (uint8_t*)flags, (int*)tiles, (const int*)ctl, (const int*)best_i, (const int*)missing,
      (const int*)default_bin, (const int*)num_bin, (const int*)leaf_begin,
      (const int*)leaf_count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<1, kScanThreads, 0, s>>>((int*)tiles, (int*)ctl, (int*)leaf_begin,
                                         (int*)leaf_count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scatter_kernel<<<grid, kThreads, 0, s>>>((int*)order, (const int*)scratch,
                                           (const uint8_t*)flags, (const int*)tiles,
                                           (const int*)ctl);
  return (int)cudaGetLastError();
}

}  // extern "C"
