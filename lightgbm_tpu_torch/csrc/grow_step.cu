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
//
// cegb_lazy is the lazy CEGB bookkeeping of a step (lightgbm_tpu/ops/
// grow.py:1392-1420) and of a tree's root (:1146-1150), one pass over rows:
// on a step, over the split segment order[pbegin : + pcount) the step's
// pick_partition left (its left part the leaf ctl[kBest], its right part
// the new leaf ctl[kNew]): each row in the bag pays the split's feature
// (used[row, f] = 1, f = node_i[step - 1]), and every feature's count of
// each child's bagged rows that have not paid for it goes to unused [M, F];
// at the root, over every row into unused[0], paying nothing. ``used`` is
// the training's [N, F] bytes (a row's F flags contiguous: one read a row,
// where the reference's [F, N] layout would scatter F). The bag is the
// values' third column (0 or 1: bagging and GOSS draw masks), so the counts
// are the reference's bag-weighted sums, exact integers in f32. The plain
// version is ops/grow_step.py ``cegb_lazy``.
//
// What bounds it: bytes, about (8 + F) a row (the row id, its bag weight,
// its F flags), scattered by ``order``: 36 MB at the 1M-row root of 28
// features, 11 us at 3.35 TB/s. A fixed grid strides over the segment
// (the graph launches it at one shape); each warp counts a feature's
// unpaid rows of each side with two ballots, one shared-memory add a warp,
// each block adds its [2, F] counts into an int32 accumulator, and the
// grid's last block (a ticket) writes them as f32 and clears the
// accumulator and the ticket for the next launch. Nothing once ctl[kActive]
// is 0 (a step after the loop stopped).

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

constexpr int kActive = 0, kStep = 2, kBest = 3, kNew = 4, kPBegin = 7, kPCount = 8,
              kLeft = 9;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLazyThreads = 256;

__global__ void __launch_bounds__(kLazyThreads)
cegb_lazy_kernel(const int* __restrict__ ctl, const int* __restrict__ node_i,
                 const int* __restrict__ order, const float* __restrict__ values,
                 unsigned char* used, int F, long long N, int root, int* acc, int* ticket,
                 float* __restrict__ unused) {
  extern __shared__ int cnt_s[];  // [2, F]: this block's counts of each side
  __shared__ bool last;
  if (!root && !ctl[kActive]) return;
  const int tid = threadIdx.x, lane = tid & 31;
  long long begin = 0, n = N, left = N;
  int fs = -1, best = 0, nw = 0;
  if (!root) {
    begin = ctl[kPBegin];
    n = ctl[kPCount];
    left = ctl[kLeft];
    fs = node_i[(ctl[kStep] - 1) * 5];
    best = ctl[kBest];
    nw = ctl[kNew];
  }
  for (int i = tid; i < 2 * F; i += kLazyThreads) cnt_s[i] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * kLazyThreads;
  for (long long base = (long long)blockIdx.x * kLazyThreads; base < n; base += stride) {
    const long long i = base + tid;  // every thread of a block takes the same trips
    int row = 0;
    bool bagged = false;
    if (i < n) {
      row = root ? (int)i : order[begin + i];
      bagged = values[(long long)row * 3 + 2] > 0.0f;
    }
    unsigned char* u = used + (long long)row * F;
    if (bagged && fs >= 0) u[fs] = 1;
    const bool right = i >= left;
    for (int ff = 0; ff < F; ++ff) {
      const bool un = bagged && !u[ff];
      const unsigned m0 = __ballot_sync(kFull, un && !right);
      const unsigned m1 = __ballot_sync(kFull, un && right);
      if (lane == 0) {
        if (m0) atomicAdd(&cnt_s[ff], __popc(m0));
        if (m1) atomicAdd(&cnt_s[F + ff], __popc(m1));
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < 2 * F; i += kLazyThreads) {
    if (cnt_s[i]) atomicAdd(acc + i, cnt_s[i]);
  }
  __threadfence();  // the block's adds are visible before its ticket
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < F; i += kLazyThreads) {
    unused[(long long)best * F + i] = (float)atomicExch(acc + i, 0);
    const int r = atomicExch(acc + F + i, 0);
    if (!root) unused[(long long)nw * F + i] = (float)r;
  }
  if (tid == 0) *ticket = 0;
}

}  // namespace

extern "C" {

// The lazy CEGB bookkeeping (see the header): root 1 counts every row into
// unused[0]; root 0 the step's split segment into its two children, after
// marking the split's feature paid. ctl [16], node_i [M, 5] int32, order
// [N] int32, values [N, 3] f32 (the bag in column 2), used [N, F] bytes,
// acc [2, F] int32 and ticket [1] int32 (zero between launches), unused
// [M, F] f32; grid blocks of 256 threads.
int lgbt_cegb_lazy(const void* ctl, const void* node_i, const void* order, const void* values,
                   void* used, int F, long long N, int root, void* acc, void* ticket,
                   void* unused, int grid, void* stream) {
  if (F < 1 || N < 1 || grid < 1 || 2 * F * (int)sizeof(int) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cegb_lazy_kernel<<<grid, kLazyThreads, 2 * F * sizeof(int), (cudaStream_t)stream>>>(
      (const int*)ctl, (const int*)node_i, (const int*)order, (const float*)values,
      (unsigned char*)used, F, N, root, (int*)acc, (int*)ticket, (float*)unused);
  return (int)cudaGetLastError();
}

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
