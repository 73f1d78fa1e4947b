// The per-split histogram subtraction of the device-resident split loop for
// Hopper (sm_90a), hist_subtract, and each row's leaf after the loop,
// leaf_ids. Both read every leaf index from the loop's control vector in
// device memory, so the host launches them without reading anything back.
// (The step's pick and tree wiring run in csrc/partition.cu, fused with the
// partition.)
//
// hist_subtract is the counterpart of the histogram subtraction trick after
// lightgbm_tpu/ops/grow.py's apply_split (serial_tree_learner.cpp:510):
// ``hist[large] = hist[parent] - small; hist[small] = small``. Its plain
// version is ops/grow_step.py ``subtract``, equal bit for bit. What bounds
// it: latency; it moves F * B * 3 floats four times (342 KB at 28 x 255),
// mostly from L2, a launch's worth of time.
//
// leaf_ids runs once a tree after the loop: each row's leaf from the
// segment layout, the counterpart of the reconstruction after the
// reference's loop (lightgbm_tpu/ops/grow.py:1880-1893, an argsort and a
// searchsorted over the leaves' begins, then a scatter through the row
// permutation). A block owns a tile of kLeafTile positions of ``order``; its
// threads list the non-empty leaves whose segment meets the tile (at most
// kLeafTile of them), then the block writes each listed leaf's index to
// ``leaf_id[order[i]]`` for its positions i in the tile. Every position
// belongs to one leaf, so no two writes meet and the list's order does not
// matter. It moves 12 bytes a row (order in, int64 leaf_id out). Its plain
// version is ops/grow_step.py ``leaf_ids``.
//
// Once the loop has stopped (ctl[kActive] 0), hist_subtract returns at once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// slots of the loop's control vector (ops/grow_state.py)
constexpr int kActive = 0, kNumLeaves = 1, kBest = 3, kSmall = 5, kLarge = 6;
// positions of ``order`` a leaf_ids block owns
constexpr int kLeafTile = 4096;

// hist[large] = hist[best] - small; hist[small] = small; small = 0 (ready
// for the next step's histogram, which adds into it). The parent's cell is
// read before either write: the smaller or the larger child is the
// parent's own slot.
__global__ void __launch_bounds__(kThreads)
subtract_kernel(const int* __restrict__ ctl, float* __restrict__ hist,
                float* __restrict__ small, long long cells) {
  if (!ctl[kActive]) return;
  const long long best = ctl[kBest], s_idx = ctl[kSmall], l_idx = ctl[kLarge];
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < cells;
       i += (long long)gridDim.x * kThreads) {
    const float pv = hist[best * cells + i];
    const float sv = small[i];
    hist[l_idx * cells + i] = pv - sv;
    hist[s_idx * cells + i] = sv;
    small[i] = 0.0f;
  }
}

// leaf_id[order[i]] = l for every position i of leaf l's segment
// [leaf_begin[l], leaf_begin[l] + leaf_count[l]), l < ctl[kNumLeaves].
__global__ void __launch_bounds__(kThreads)
leaf_id_kernel(const int* __restrict__ ctl, const int* __restrict__ order,
               const int* __restrict__ leaf_begin, const int* __restrict__ leaf_count, int M,
               long long N, long long* __restrict__ leaf_id) {
  __shared__ int listed[kLeafTile];
  __shared__ int n_listed;
  const long long lo = (long long)blockIdx.x * kLeafTile;
  const long long hi = min(lo + kLeafTile, N);
  const int nl = min(ctl[kNumLeaves], M);
  if (threadIdx.x == 0) n_listed = 0;
  __syncthreads();
  for (int l = threadIdx.x; l < nl; l += kThreads) {
    const long long b = leaf_begin[l], e = b + leaf_count[l];
    if (e > b && b < hi && e > lo) listed[atomicAdd(&n_listed, 1)] = l;
  }
  __syncthreads();
  const int n = n_listed;
  for (int j = 0; j < n; ++j) {
    const int l = listed[j];
    const long long b = leaf_begin[l];
    const long long s = max(b, lo), e = min(b + leaf_count[l], hi);
    for (long long i = s + threadIdx.x; i < e; i += kThreads) leaf_id[order[i]] = l;
  }
}

}  // namespace

extern "C" {

// The step's histogram subtraction over hist [M, cells] f32 and the smaller
// child's histogram small [cells] f32, which it leaves zeroed; grid blocks
// of 256 threads.
int lgbt_hist_subtract(const void* ctl, void* hist, void* small, long long cells, int grid,
                       void* stream) {
  if (cells < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  subtract_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)ctl, (float*)hist, (float*)small, cells);
  return (int)cudaGetLastError();
}

// Each row's leaf, leaf_id [N] int64, from the loop's segment layout:
// order [N] int32, leaf_begin / leaf_count [M] int32 and ctl[kNumLeaves].
int lgbt_leaf_ids(const void* ctl, const void* order, const void* leaf_begin,
                  const void* leaf_count, int M, long long N, void* leaf_id, void* stream) {
  if (M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const long long grid = (N + kLeafTile - 1) / kLeafTile;
  leaf_id_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)ctl, (const int*)order, (const int*)leaf_begin, (const int*)leaf_count, M, N,
      (long long*)leaf_id);
  return (int)cudaGetLastError();
}

}  // extern "C"
