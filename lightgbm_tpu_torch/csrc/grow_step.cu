// Each row's leaf after the device-resident split loop, for Hopper
// (sm_90a): leaf_ids, and the score update that consumes it, score_update.
// Both read the leaves from the loop's state in device memory, so the host
// launches them without reading anything back. (The step's pick and tree
// wiring run in csrc/partition.cu, fused with the partition; the histogram
// subtraction runs inside the split scan, csrc/split_pair.cu.)
//
// leaf_ids is the counterpart of the reconstruction after the reference's
// loop (lightgbm_tpu/ops/grow.py:1880-1893, an argsort and a searchsorted
// over the leaves' begins, then a scatter through the row permutation):
// leaf_id[order[i]] = the leaf whose segment [leaf_begin, + leaf_count)
// holds position i. Its plain version is ops/grow_step.py ``leaf_ids``.
//
// score_update is what the captured boosting iteration runs in its place
// (models/gbdt.py _device_iteration, the reference's _finish_step score
// update): score[r] += value[leaf of row r] for every row, one f32 add a
// row, so the result is the same bits as its plain version,
// ``score.add_(value[leaf_ids])`` (ops/grow_step.py ``score_update``). It
// replaces leaf_ids' 8 MB int64 index and the gather and add kernels that
// read it.
//
// What bounds them: bytes, and the scattered accesses through ``order``.
// leaf_ids reads order (4 bytes a row) and writes an int64 (8, scattered);
// score_update reads order and reads and writes the score (4 + 8): at 1M
// rows 12 MB, 3.6 us at 3.35 TB/s. A position's row is random within the
// leaf's span, so each scattered access of a warp is a sector of its own,
// and the card takes such accesses at a fraction of its streaming rate.
// The design:
//  - The lookup (tile_leaves / leaf_of), shared by both: a block owns a
//    tile of kTile = 1024 positions, 4 a thread, so 1M rows give 977
//    blocks, about 7 a multiprocessor on 132: one wave. Every load that
//    does not depend on another is issued first: each thread's 4 positions
//    of ``order`` (a warp reads 128 contiguous bytes), and the leaves'
//    begin and count for l < M, with ctl. The leaves whose non-empty
//    segment meets the tile (at most kTile) are listed once into shared
//    memory and sorted by begin (each listed leaf's rank is the number of
//    listed begins below its own: non-empty segments are disjoint, so their
//    begins differ). A position's leaf is the last listed begin <= it, a
//    binary search in shared memory, with no chain of global loads per
//    leaf.
//  - score_update makes one scattered access a row, not two: a scattered
//    read-modify-write of the score would wait on a scattered read before
//    its scattered write. Its entry launches the lookup writing each row's
//    leaf as one byte (M <= 256; an int32 otherwise) into a scratch buffer
//    through ``order``, then a pass in row order that adds value[leaf] to
//    the score: the reads and the writes of the score coalesced. Every row
//    gets one add, so no atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;                  // positions a thread
constexpr int kTile = kThreads * kItems;   // positions a block
constexpr int kNumLeaves = 1;              // slot of the loop's control vector (ops/grow_state.py)

// The leaves that meet a tile, sorted by begin, in shared memory.
struct TileLeaves {
  int begin[kTile];
  int leaf[kTile];
  int n;
};

// List the leaves l < min(ctl[kNumLeaves], M) whose non-empty segment meets
// [lo, hi) into ``listed`` (unsorted), then sort them by begin into ``out``.
// Ends with a barrier.
__device__ __forceinline__ void tile_leaves(const int* __restrict__ ctl,
                                            const int* __restrict__ leaf_begin,
                                            const int* __restrict__ leaf_count, int M,
                                            long long lo, long long hi, TileLeaves& listed,
                                            TileLeaves& out) {
  if (threadIdx.x == 0) listed.n = 0;
  __syncthreads();
  const int nl = min(ctl[kNumLeaves], M);
  for (int l = threadIdx.x; l < M; l += kThreads) {
    const long long b = leaf_begin[l], e = b + leaf_count[l];
    if (l < nl && e > b && b < hi && e > lo) {
      const int j = atomicAdd(&listed.n, 1);
      if (j < kTile) {  // always: disjoint segments meeting kTile positions
        listed.begin[j] = (int)b;
        listed.leaf[j] = l;
      }
    }
  }
  __syncthreads();
  const int n = min(listed.n, kTile);
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int b = listed.begin[j];
    int rank = 0;
    for (int k = 0; k < n; ++k) rank += listed.begin[k] < b;
    out.begin[rank] = b;
    out.leaf[rank] = listed.leaf[j];
  }
  if (threadIdx.x == 0) out.n = n;
  __syncthreads();
}

// The index into ``t`` of the last begin <= i, or -1 when none is (a
// position no listed leaf holds: never, on a state the loop grew).
__device__ __forceinline__ int leaf_of(const TileLeaves& t, int n, long long i) {
  if (n == 0 || t.begin[0] > i) return -1;
  int a = 0, z = n;  // t.begin[a] <= i < t.begin[z] (z = n: past the end)
  while (z - a > 1) {
    const int mid = (a + z) >> 1;
    if (t.begin[mid] <= i) a = mid; else z = mid;
  }
  return a;
}

// out[order[i]] = the leaf of position i, as an L (int64 for leaf_ids; one
// byte or an int32 for score_update's scratch).
template <typename L>
__global__ void __launch_bounds__(kThreads)
leaf_tile_kernel(const int* __restrict__ ctl, const int* __restrict__ order,
                 const int* __restrict__ leaf_begin, const int* __restrict__ leaf_count, int M,
                 long long N, L* __restrict__ out) {
  __shared__ TileLeaves listed, sorted;
  const long long lo = (long long)blockIdx.x * kTile;
  const long long hi = min(lo + kTile, N);
  int row[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = lo + k * kThreads + threadIdx.x;
    row[k] = i < hi ? order[i] : -1;
  }
  tile_leaves(ctl, leaf_begin, leaf_count, M, lo, hi, listed, sorted);
  const int n = sorted.n;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int at = row[k] >= 0 ? leaf_of(sorted, n, lo + k * kThreads + threadIdx.x) : -1;
    if (at >= 0) out[row[k]] = (L)sorted.leaf[at];
  }
}

// score[r] += value[leaf[r]] for rows r in order, kItems a thread.
template <typename L>
__global__ void __launch_bounds__(kThreads)
add_value_kernel(const L* __restrict__ leaf, const float* __restrict__ value, long long N,
                 float* __restrict__ score) {
  const long long base = (long long)blockIdx.x * kTile + threadIdx.x;
  L l[kItems];
  float s[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long r = base + k * kThreads;
    l[k] = r < N ? leaf[r] : (L)0;
    s[k] = r < N ? score[r] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long r = base + k * kThreads;
    if (r < N) score[r] = s[k] + __ldg(value + l[k]);
  }
}

template <typename L>
int score_update(const int* ctl, const int* order, const int* leaf_begin, const int* leaf_count,
                 const float* value, int M, long long N, L* scratch, float* score,
                 cudaStream_t stream) {
  const unsigned grid = (unsigned)((N + kTile - 1) / kTile);
  leaf_tile_kernel<L><<<grid, kThreads, 0, stream>>>(ctl, order, leaf_begin, leaf_count, M, N,
                                                      scratch);
  add_value_kernel<L><<<grid, kThreads, 0, stream>>>(scratch, value, N, score);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each row's leaf, leaf_id [N] int64, from the loop's segment layout:
// order [N] int32, leaf_begin / leaf_count [M] int32 and ctl[kNumLeaves].
int lgbt_leaf_ids(const void* ctl, const void* order, const void* leaf_begin,
                  const void* leaf_count, int M, long long N, void* leaf_id, void* stream) {
  if (M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const long long grid = (N + kTile - 1) / kTile;
  leaf_tile_kernel<long long><<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)ctl, (const int*)order, (const int*)leaf_begin, (const int*)leaf_count, M, N,
      (long long*)leaf_id);
  return (int)cudaGetLastError();
}

// score [N] f32 += value [M] f32 of each row's leaf, from the same layout as
// lgbt_leaf_ids; scratch holds N leaf indices between the two launches:
// N bytes when M <= 256, N int32 otherwise.
int lgbt_score_update(const void* ctl, const void* order, const void* leaf_begin,
                      const void* leaf_count, const void* value, int M, long long N,
                      void* scratch, void* score, void* stream) {
  if (M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if (M <= 256) {
    return score_update<unsigned char>(
        (const int*)ctl, (const int*)order, (const int*)leaf_begin, (const int*)leaf_count,
        (const float*)value, M, N, (unsigned char*)scratch, (float*)score, (cudaStream_t)stream);
  }
  return score_update<int>((const int*)ctl, (const int*)order, (const int*)leaf_begin,
                           (const int*)leaf_count, (const float*)value, M, N, (int*)scratch,
                           (float*)score, (cudaStream_t)stream);
}

}  // extern "C"
