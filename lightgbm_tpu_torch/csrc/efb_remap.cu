// The group-to-feature histogram remap of EFB-bundled datasets, for Hopper
// (sm_90a): efb_remap.
//
// Counterpart of ``remap_hist`` in lightgbm_tpu/ops/grow.py:806-822 (XLA
// code there, a gather through a per-feature plan; no Pallas kernel): the
// histogram of a leaf built over the bundled [G, N] bin matrix at the group
// width Bg ([G, Bg, 3], lightgbm_tpu/efb.py's encoding) becomes the
// feature-space [F, B, 3] histogram that the split scan reads. Sub-bin s of
// feature f, s != default_bin(f), s < num_bin(f), reads group gid(f)'s bin
// off(f) + s - (s > default_bin(f)); bins at or above num_bin(f) are 0; the
// default bin's row is the leaf's totals minus the sum of the feature's
// other rows. The plain version is ops/remap.py ``remap_hist``, equal bit
// for bit: the gathers are copies, and the sum runs in one fixed order in
// both, a pairwise tree over 256 slots (slot s holds sub-bin s's row, 0
// where none): at half-width h = 128, 64, ..., 1 slot i takes
// slot[i] + slot[i + h].
//
// Grid: one block a feature, one thread a sub-bin (B <= 256; kWide below). The block
// reads its group row's sub-bins (one gather a thread, 3 floats), writes
// them into the feature's row, sums them in shared memory in the tree
// order above, and its default-bin thread writes totals - sum. Totals come
// from device memory: the loop's ``laux`` row of the child being remapped
// (``ctl[kSmall]``, the split record's sums that the pick wrote), or a
// fixed row (the root's sums, or a [3] vector of the host loop). A launch
// of the device loop also clears, in block f < G, row f of the group
// scratch that the next step's segment histogram adds into
// (``zero_g``): no block of this launch reads that buffer, the fold's own
// scheme (csrc/split_pair.cu kFold). It returns at once when ctl[kActive]
// is 0.
//
// What bounds it: launch latency. The bytes are the group histogram read
// once (G x Bg x 12), the feature histogram written (F x B x 12) and the
// cleared scratch (G x Bg x 12): at 674 features of 255 bins, 2.1 MB, 0.6
// us on 3.35 TB/s, below one launch. A block does one gather and one
// 8-level tree in shared memory; every block is independent, so the F
// blocks run in one wave.
//
// Wide rows (the kWide instantiation, 256 < B <= 1024: a bundled table's
// int16 groups, a feature of more than 256 bins in its own group): the same
// order over a pairwise tree of 1024 slots, 256 threads of 4 slots each.
// Thread s gathers sub-bins s, s + 256, s + 512 and s + 768 and adds the
// tree's first two levels in registers, (v[s] + v[s + 512]) + (v[s + 256]
// + v[s + 768]): at h = 512 slot i takes slot[i] + slot[i + 512], at h =
// 256 slot s takes slot[s] + slot[s + 256]. The 8 levels left run in shared
// memory as above. The plain version sums over 1024 slots past 256 bins
// (ops/remap.py ``slots``). A row of 256 bins or fewer summed over 1024
// slots would equal the 256-slot tree (its top slots are zeros), but the
// byte instantiation keeps its code.
//
// The larger child of a pooled step (the kLarge instantiations, a state
// with a histogram pool, ops/grow_state.py): when the step's pick found the
// parent evicted, a second segment histogram built the larger child over
// the groups, and this launch remaps it with the larger child's sums. It
// reads the pool's control vector ``run`` as that launch does: run[0] set
// on a miss, run[5] the larger child's leaf, whose laux row holds the
// split record's sums. It clears its own group scratch for the next step
// first, on a hit too (the segment histogram adds into it), then returns at
// once on a hit. Once the loop has stopped (ctl[0] 0) it returns before
// anything.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // one thread a sub-bin; the tree's slots
constexpr int kMaxBins = 1024;  // kWide: 4 sub-bins a thread
constexpr int kActive = 0, kSmall = 5;  // slots of the loop's control vector (ops/grow_state.py)
constexpr int kLaux = 5;                // floats a row of the loop's laux

struct Args {
  const float* in;      // [G, Bg, 3] group histogram
  float* out;           // [F, B, 3] feature histogram
  float* zero_g;        // [G, Bg, 3] cleared, or null
  const float* totals;  // row ``row`` (stride kLaux) holds (sum_grad, sum_hess, count)
  const int* ctl;       // the loop's control vector, or null
  const int* gid;       // [F] each feature's group
  const int* off;       // [F] its offset in the group
  const int* dbin;      // [F] default_bin
  const int* nbin;      // [F] num_bin
  int row;              // the totals' row, or -1: ctl[kSmall] (kLarge: run[kSmall])
  int F, B, G, Bg;
  const int* run;       // kLarge: the pool's control vector (run[kActive], run[kSmall])
};

// kWide: feature f's row over 1024 slots, 4 a thread, written to out
__device__ __forceinline__ void remap_wide(const Args& a, float (*red)[kThreads], int f, int s,
                                           int g, int off, int d, int nb, const float* t) {
  float v[4][3];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int b = s + j * kThreads;
    v[j][0] = v[j][1] = v[j][2] = 0.0f;
    if (b < nb && b != d) {
      const float* src = a.in + ((long long)g * a.Bg + off + b - (b > d)) * 3;
      v[j][0] = src[0];
      v[j][1] = src[1];
      v[j][2] = src[2];
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) red[c][s] = (v[0][c] + v[2][c]) + (v[1][c] + v[3][c]);
  __syncthreads();
#pragma unroll
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (s < h) {
      red[0][s] = red[0][s] + red[0][s + h];
      red[1][s] = red[1][s] + red[1][s + h];
      red[2][s] = red[2][s] + red[2][s + h];
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int b = s + j * kThreads;
    if (b >= a.B) break;
    float* o = a.out + ((long long)f * a.B + b) * 3;
    if (b == d) {
      o[0] = t[0] - red[0][0];
      o[1] = t[1] - red[1][0];
      o[2] = t[2] - red[2][0];
    } else {
      o[0] = v[j][0];
      o[1] = v[j][1];
      o[2] = v[j][2];
    }
  }
}

template <bool kWide, bool kLarge>
__global__ void __launch_bounds__(kThreads) efb_remap_kernel(Args a) {
  if (a.ctl != nullptr && a.ctl[kActive] == 0) return;
  __shared__ float red[3][kThreads];
  const int f = blockIdx.x, s = threadIdx.x;
  if (a.zero_g != nullptr && f < a.G) {
    float* z = a.zero_g + (long long)f * a.Bg * 3;
    for (int i = s; i < a.Bg * 3; i += kThreads) z[i] = 0.0f;
  }
  if constexpr (kLarge) {
    if (a.run[kActive] == 0) return;  // a hit: the larger child is the parent's minus the smaller
  }
  const int g = a.gid[f], off = a.off[f], d = a.dbin[f], nb = a.nbin[f];
  if constexpr (kWide) {
    const int trow = a.row < 0 ? (kLarge ? a.run : a.ctl)[kSmall] : a.row;
    remap_wide(a, red, f, s, g, off, d, nb, a.totals + (long long)trow * kLaux);
    return;
  }
  float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f;
  if (s < nb && s != d) {
    const float* src = a.in + ((long long)g * a.Bg + off + s - (s > d)) * 3;
    v0 = src[0];
    v1 = src[1];
    v2 = src[2];
  }
  red[0][s] = v0;
  red[1][s] = v1;
  red[2][s] = v2;
  __syncthreads();
#pragma unroll
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (s < h) {
      red[0][s] = red[0][s] + red[0][s + h];
      red[1][s] = red[1][s] + red[1][s + h];
      red[2][s] = red[2][s] + red[2][s + h];
    }
    __syncthreads();
  }
  if (s >= a.B) return;
  float* o = a.out + ((long long)f * a.B + s) * 3;
  if (s == d) {
    const float* t =
        a.totals + (long long)(a.row < 0 ? (kLarge ? a.run : a.ctl)[kSmall] : a.row) * kLaux;
    o[0] = t[0] - red[0][0];
    o[1] = t[1] - red[1][0];
    o[2] = t[2] - red[2][0];
  } else {
    o[0] = v0;
    o[1] = v1;
    o[2] = v2;
  }
}

}  // namespace

extern "C" {

// out [F, B, 3] f32 = the remap of in [G, Bg, 3] f32 through the plan gid /
// off / dbin / nbin [F] int32, with the totals at totals + 5 * row (row -1:
// ctl[5], the loop's smaller child) ; zero_g [G, Bg, 3] cleared when not
// null; nothing when ctl is not null and ctl[0] is 0. B and Bg at most 1024
// (the kWide instantiation past B = 256). run non-null (a pooled step's
// larger child, row -1): the pool's control vector; zero_g is cleared
// whenever ctl[0] is set, the remap runs only when run[0] is set, with the
// totals of laux row run[5].
int lgbt_efb_remap(const void* in, void* out, void* zero_g, const void* totals, const void* ctl,
                   const void* gid, const void* off, const void* dbin, const void* nbin, int row,
                   int F, int B, int G, int Bg, const void* run, void* stream) {
  if (F < 1 || G < 1 || B < 1 || B > kMaxBins || Bg < 1 || Bg > kMaxBins ||
      (row < 0 && ctl == nullptr) || (run != nullptr && (ctl == nullptr || row >= 0)))
    return (int)cudaErrorInvalidValue;
  Args a{(const float*)in, (float*)out, (float*)zero_g, (const float*)totals, (const int*)ctl,
         (const int*)gid, (const int*)off, (const int*)dbin, (const int*)nbin, row, F, B, G, Bg,
         (const int*)run};
  const bool wide = B > kThreads;
  const cudaStream_t st = (cudaStream_t)stream;
  if (run != nullptr) {
    if (wide)
      efb_remap_kernel<true, true><<<F, kThreads, 0, st>>>(a);
    else
      efb_remap_kernel<false, true><<<F, kThreads, 0, st>>>(a);
  } else if (wide) {
    efb_remap_kernel<true, false><<<F, kThreads, 0, st>>>(a);
  } else {
    efb_remap_kernel<false, false><<<F, kThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
