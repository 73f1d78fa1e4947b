// Two-child best-split scan for Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/split_pallas.py:
// find_best_split_pair_pallas (body _kernel): the best numerical split of
// each child of a split, with the missing-value scan directions, kEpsilon
// seeds, L1/L2/max_delta_step, the monotone clamp, the feature mask and the
// reference tie-breaks, in the output layout of lightgbm_tpu/ops/grow.py
// _BEST_F ([C, 9] f32) plus [C, 4] int32 (feature, threshold, num_cat,
// default_left). The formulas are those of lightgbm_tpu/ops/split.py
// (candidate_gains and its helpers) and of the port's plain version,
// lightgbm_tpu_torch/ops/split.py, op for op.
//
// What bounds it on the card: latency. One call reads C*F*B*3 floats (170 KB
// for two children at 28 x 255) and does a few thousand operations per
// feature; launch and dependent-step latency dominate. The design keeps the
// step count small instead: one block per (feature, child) loads its
// histogram row into shared memory, one thread folds the inclusive bin
// prefix sequentially for each channel (B <= 256 steps, the left-to-right
// order of the CPU fold in lightgbm_tpu/ops/split.py _bin_prefix, so sums
// match it bit for bit), each thread scores its thresholds in both
// directions, and a block reduction keeps the best per feature. A second,
// one-block-per-child launch takes the feature argmax and writes the
// winner's side sums and constrained leaf outputs.
//
// Built with --fmad=false: a contracted a*b+c rounds once where the plain
// version rounds twice, which moves gains by an ulp and flips near-ties.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBig = 1 << 30;
// K_EPSILON = 1e-15 (meta.h:42) as the plain version rounds it into f32
constexpr double kEpsilon = 1e-15;

struct Params {
  float l1, l2, max_delta_step, min_data, min_hess, min_gain;
};

// clamp that passes NaN through, like torch.clamp and jnp.clip (fminf and
// fmaxf would drop it)
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float threshold_l1(float s, float l1) {
  if (l1 == 0.0f) return s;
  const float sgn = isnan(s) ? s : (s > 0.0f ? 1.0f : (s < 0.0f ? -1.0f : 0.0f));
  return sgn * clamp_nan(fabsf(s) - l1, 0.0f, INFINITY);
}

__device__ __forceinline__ float leaf_output(float sg, float sh, const Params& p) {
  float ret = -threshold_l1(sg, p.l1) / (sh + p.l2);
  if (p.max_delta_step > 0.0f) {
    ret = clamp_nan(ret, -p.max_delta_step, p.max_delta_step);
  }
  return ret;
}

__device__ __forceinline__ float leaf_output_constrained(float sg, float sh, const Params& p,
                                                         float lo, float hi) {
  return clamp_nan(leaf_output(sg, sh, p), lo, hi);
}

__device__ __forceinline__ float gain_given_output(float sg, float sh, float out,
                                                   const Params& p) {
  const float sg_l1 = threshold_l1(sg, p.l1);
  return -(2.0f * sg_l1 * out + (sh + p.l2) * out * out);
}

__device__ __forceinline__ float min_gain_shift(float sg, float sh, const Params& p) {
  const float sh_eff = sh + (float)(2.0 * kEpsilon);
  const float out = leaf_output(sg, sh_eff, p);
  return gain_given_output(sg, sh_eff, out, p) + p.min_gain;
}

__device__ __forceinline__ float candidate_gain(float lg, float lh, float rg, float rh,
                                                float lc, float rc, bool valid, int mono,
                                                float min_c, float max_c, float mgs,
                                                const Params& p) {
  bool ok = valid && lc >= p.min_data && rc >= p.min_data && lh >= p.min_hess &&
            rh >= p.min_hess;
  const float lo = leaf_output_constrained(lg, lh, p, min_c, max_c);
  const float ro = leaf_output_constrained(rg, rh, p, min_c, max_c);
  float g = gain_given_output(lg, lh, lo, p) + gain_given_output(rg, rh, ro, p);
  if ((mono > 0 && lo > ro) || (mono < 0 && lo < ro)) g = 0.0f;
  ok = ok && g > mgs;
  return ok ? g : -INFINITY;
}

// per (feature, child): best threshold and its left sums
// feat_f[c, f, :] = (gain, left_g, left_h incl. eps, left_c); feat_i[c, f, :] = (t, default_left)
__global__ void __launch_bounds__(kThreads)
split_feature_kernel(const float* __restrict__ hist, const float* __restrict__ sums,
                     const float* __restrict__ cons, const int* __restrict__ num_bin_a,
                     const int* __restrict__ missing_a, const int* __restrict__ default_bin_a,
                     const int* __restrict__ mono_a, const unsigned char* __restrict__ fmask,
                     float* __restrict__ feat_f, int* __restrict__ feat_i, int F, int B,
                     Params p, int two_way) {
  extern __shared__ float pre[];  // [B, 3] inclusive prefix
  __shared__ float red_g[2][kThreads];
  __shared__ int red_t[2][kThreads];
  const int f = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
  const float* h = hist + ((long long)c * F + f) * B * 3;
  const int num_bin = num_bin_a[f], miss = missing_a[f], dbin = default_bin_a[f];
  const int mono = mono_a[f];
  const bool multi_bin = num_bin > 2;
  const bool use_na = miss == 2 && multi_bin;
  const bool skip_def = miss == 1 && multi_bin;
  const bool single_scan = !(use_na || skip_def);

  for (int b = tid; b < B; b += blockDim.x) {
    const bool excl = b >= num_bin || (skip_def && b == dbin) || (use_na && b == num_bin - 1);
    for (int k = 0; k < 3; ++k) pre[b * 3 + k] = excl ? 0.0f : h[b * 3 + k];
  }
  __syncthreads();
  if (tid < 3) {
    float carry = 0.0f;
    for (int b = 0; b < B; ++b) {
      carry = carry + pre[b * 3 + tid];
      pre[b * 3 + tid] = carry;
    }
  }
  __syncthreads();

  const float sg = sums[c * 3], sh = sums[c * 3 + 1], nd = sums[c * 3 + 2];
  const float min_c = cons[c * 2], max_c = cons[c * 2 + 1];
  const float eps = (float)kEpsilon;
  const float sh_eff = sh + (float)(2.0 * kEpsilon);
  const float mgs = min_gain_shift(sg, sh, p);
  const float tg = pre[(B - 1) * 3], th = pre[(B - 1) * 3 + 1], tc = pre[(B - 1) * 3 + 2];

  float best_gn = -INFINITY, best_gp = -INFINITY;
  int best_tn = -1, best_tp = kBig;
  for (int t = tid; t < B; t += blockDim.x) {
    const float pg = pre[t * 3], ph = pre[t * 3 + 1], pc = pre[t * 3 + 2];
    // dir = -1: right side accumulates from the top, default_left = true
    const float rg_n = tg - pg;
    const float rh_n = (th - ph) + eps;
    const float rc_n = tc - pc;
    const float lg_n = sg - rg_n, lh_n = sh_eff - rh_n, lc_n = nd - rc_n;
    const bool v_neg = t <= num_bin - 2 - (use_na ? 1 : 0) && !(skip_def && t == dbin - 1);
    const float gn = candidate_gain(lg_n, lh_n, rg_n, rh_n, lc_n, rc_n, v_neg, mono, min_c,
                                    max_c, mgs, p);
    if (gn > best_gn || (gn == best_gn && t > best_tn)) { best_gn = gn; best_tn = t; }
    if (two_way) {
      // dir = +1: left side accumulates from the bottom, default_left = false
      const float lg_p = pg, lh_p = ph + eps, lc_p = pc;
      const float rg_p = sg - lg_p, rh_p = sh_eff - lh_p, rc_p = nd - lc_p;
      const bool v_pos = t <= num_bin - 2 && !(skip_def && t == dbin) && !single_scan;
      const float gp = candidate_gain(lg_p, lh_p, rg_p, rh_p, lc_p, rc_p, v_pos, mono, min_c,
                                      max_c, mgs, p);
      if (gp > best_gp || (gp == best_gp && t < best_tp)) { best_gp = gp; best_tp = t; }
    }
  }
  red_g[0][tid] = best_gn; red_t[0][tid] = best_tn;
  red_g[1][tid] = best_gp; red_t[1][tid] = best_tp;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) {
      // dir = -1 keeps the largest threshold among equal gains
      float g = red_g[0][tid + s]; int t = red_t[0][tid + s];
      if (g > red_g[0][tid] || (g == red_g[0][tid] && t > red_t[0][tid])) {
        red_g[0][tid] = g; red_t[0][tid] = t;
      }
      // dir = +1 keeps the smallest
      g = red_g[1][tid + s]; t = red_t[1][tid + s];
      if (g > red_g[1][tid] || (g == red_g[1][tid] && t < red_t[1][tid])) {
        red_g[1][tid] = g; red_t[1][tid] = t;
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    const float g_neg = red_g[0][0], g_pos = red_g[1][0];
    const bool use_pos = g_pos > g_neg;  // +1 must beat -1 strictly
    float g = use_pos ? g_pos : g_neg;
    const int t = use_pos ? red_t[1][0] : red_t[0][0];
    bool dl = !use_pos;
    if (miss == 2 && !multi_bin) dl = false;  // 2-bin NaN features
    if (!fmask[f]) g = -INFINITY;
    const float pg = pre[t * 3], ph = pre[t * 3 + 1], pc = pre[t * 3 + 2];
    float lg, lh, lc;
    if (use_pos) {
      lg = pg; lh = ph + eps; lc = pc;
    } else {
      const float rg_n = tg - pg, rh_n = (th - ph) + eps, rc_n = tc - pc;
      lg = sg - rg_n; lh = sh_eff - rh_n; lc = nd - rc_n;
    }
    float* o = feat_f + ((long long)c * F + f) * 4;
    o[0] = g; o[1] = lg; o[2] = lh; o[3] = lc;
    int* oi = feat_i + ((long long)c * F + f) * 2;
    oi[0] = t; oi[1] = dl ? 1 : 0;
  }
}

// per child: feature argmax (smallest index on ties) and the winner's record
__global__ void __launch_bounds__(kThreads)
split_pick_kernel(const float* __restrict__ feat_f, const int* __restrict__ feat_i,
                  const float* __restrict__ sums, const float* __restrict__ cons,
                  float* __restrict__ outf, int* __restrict__ outi, int F, Params p) {
  __shared__ float red_g[kThreads];
  __shared__ int red_f[kThreads];
  const int c = blockIdx.x, tid = threadIdx.x;
  float best = -INFINITY;
  int best_f = kBig;
  for (int f = tid; f < F; f += blockDim.x) {
    const float g = feat_f[((long long)c * F + f) * 4];
    if (g > best || (g == best && f < best_f)) { best = g; best_f = f; }
  }
  red_g[tid] = best; red_f[tid] = best_f;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) {
      const float g = red_g[tid + s]; const int f = red_f[tid + s];
      if (g > red_g[tid] || (g == red_g[tid] && f < red_f[tid])) { red_g[tid] = g; red_f[tid] = f; }
    }
    __syncthreads();
  }
  if (tid == 0) {
    const float g_best = red_g[0];
    const bool has_split = g_best > -INFINITY;
    const int fb = has_split ? red_f[0] : 0;
    const float* w = feat_f + ((long long)c * F + fb) * 4;
    const int* wi = feat_i + ((long long)c * F + fb) * 2;
    const float sg = sums[c * 3], sh = sums[c * 3 + 1], nd = sums[c * 3 + 2];
    const float min_c = cons[c * 2], max_c = cons[c * 2 + 1];
    const float eps = (float)kEpsilon;
    const float lg = w[1], lh = w[2], lc = w[3];
    const float rg = sg - lg;
    const float rh = (sh + (float)(2.0 * kEpsilon)) - lh;
    const float rc = nd - lc;
    float* o = outf + c * 9;
    o[0] = has_split ? g_best - min_gain_shift(sg, sh, p) : -INFINITY;
    o[1] = lg; o[2] = lh - eps; o[3] = lc;
    o[4] = rg; o[5] = rh - eps; o[6] = rc;
    o[7] = leaf_output_constrained(lg, lh, p, min_c, max_c);
    o[8] = leaf_output_constrained(rg, rh, p, min_c, max_c);
    int* oi = outi + c * 4;
    oi[0] = has_split ? fb : -1;
    oi[1] = wi[0];
    oi[2] = 0;
    oi[3] = wi[1];
  }
}

}  // namespace

extern "C" {

// Best split of each of C children. hist [C, F, B, 3], sums [C, 3]
// (sum_grad, sum_hess, count), cons [C, 2] (monotone min, max), per-feature
// int32 num_bin/missing_type/default_bin/monotone [F], fmask [F] bytes.
// Scratch feat_f [C, F, 4] f32 and feat_i [C, F, 2] int32; out outf [C, 9],
// outi [C, 4].
int lgbt_split_pair(const void* hist, const void* sums, const void* cons, const void* num_bin,
                    const void* missing, const void* default_bin, const void* mono,
                    const void* fmask, void* feat_f, void* feat_i, void* outf, void* outi, int C,
                    int F, int B, float l1, float l2, float max_delta_step, float min_data,
                    float min_hess, float min_gain, int two_way, void* stream) {
  if (C <= 0 || F <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  const Params p{l1, l2, max_delta_step, min_data, min_hess, min_gain};
  const int smem = B * 3 * (int)sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  split_feature_kernel<<<dim3(F, C), kThreads, smem, s>>>(
      (const float*)hist, (const float*)sums, (const float*)cons, (const int*)num_bin,
      (const int*)missing, (const int*)default_bin, (const int*)mono,
      (const unsigned char*)fmask, (float*)feat_f, (int*)feat_i, F, B, p, two_way);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split_pick_kernel<<<C, kThreads, 0, s>>>((const float*)feat_f, (const int*)feat_i,
                                           (const float*)sums, (const float*)cons,
                                           (float*)outf, (int*)outi, F, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
