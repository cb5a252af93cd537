// K3 glm_irls_pass: one fused pass over the samples for one IRLS evaluation
// of the per-variant logistic / Firth regressions.  The kernel template is
// instantiated by glm_irls.cu (the plain design of the main path) and by
// glm_irls_x.cu (the scaled and residualized designs), which nvcc builds in
// parallel.
//
// Replaces (plink_tpu/ops/glm.py) the contractions of `_design_ops`
// (xtv, hessian, eta_of, :328) inside `_logistic_core` (:383) and
// `_firth_core` (:492), including the Firth hat diagonal (`hat_diag`,
// :510-523) and the two-stage f32/f64 log-likelihood (:400-410, :545-551).
// The JAX code materialises several [vb, n] f32 planes per evaluation
// (eta, p, w, the predictor column); here nothing of that size touches HBM.
//
// Per variant v with design x_s = [c_s (dc covariates incl. intercept) | G(v,s)],
// G = wH*het + wA*homalt + wV*valid decoded from the packed 2-bit row, and
// eta_s = valid * x_s . beta_v, p_s = valid * sigmoid(eta_s):
//   mode 0 (logistic): H = sum w x x^T with w = p(1-p)valid, vec = X^T (p - y valid),
//                      ll = sum [yv log p + (valid - yv) log(1-p)], the f32
//                      per-sample terms added in f64;
//   mode 1 (firth2):   h_s = v_s x_s^T Hinv0 x_s with v = p(1-p)valid,
//                      vec = X^T ((yv - p + h(0.5 - p)) valid),
//                      H = sum (1+h) v x x^T.
// 1 - p is taken as sigmoid(-eta), not by subtraction, so the weights and
// residuals of samples with large |eta| keep f32 relative accuracy; y is
// 0/1 (case/control), so p - y is p or -(1 - p).  The loglik is an f64 sum
// of the f32 per-sample terms and stays f64 on output.  The JAX code sums
// f32 128-sample chunks and returns f32 (sparing the TPU's emulated f64);
// but one f32 ulp of |ll| exceeds the 1e-8 relative convergence test once
// |ll| > ~100, so the test would compare roundings and the iteration that
// stops (hence the reported SE) would depend on the summation order.
//
// P (template) genotype predictor columns G_1..G_P, each with its own
// plane weights (plink_tpu `_plane_cols`, :288-325, without `covj`; the
// designs whose columns carry a covariate factor run on K16, glm_wide.cu):
// P = 1 is the additive / dominant / recessive / hetonly design of the main
// path, P = 2 the genotypic and hethom models (glm_irls_p2.cu).  The P = 1
// instantiations unroll to the code the kernel ran before P existed.
//
// Design flags (template, so the main path's instantiations compile as
// they did before the flags existed):
//   kScale: G *= s_s, a per-sample genotype multiplier (plink_tpu
//           `_plane_cols` sscale, :313-314; 0.5 for males on chrX under
//           --xchr-model 1);
//   kResid: the residualized design of cc-/firth-residualize (plink_tpu
//           `_resid_body`, :623-643): no covariates (dc = 0, d = P), each
//           column G'_p = (G_p - mean_vp) * valid centred on its per-variant
//           mean over valid samples, and a fixed per-sample offset in the
//           linear predictor, eta = (beta . G' + offset) * valid (`eta_of`,
//           :371-379).
//
// Bound: operations.  ~200 FP32 instructions per (variant, sample) pair at
// d = 13 (decode, the d-term dot product, one exp and one log1p, and the
// d(d+1)/2 + d multiply-adds of the accumulation) against 2 bits of packed
// input per pair.  Design: one thread per variant keeps the packed upper
// triangle of H and the vector in registers (the dc template parameter
// unrolls every index), 64 variants per block share a 128-sample tile of the
// per-sample table [c | y | mask] (and s, offset) in shared memory, and the
// sample axis is split over blockIdx.y into runs of at most 2,048 samples,
// which fills the card at biobank n and bounds the f32 drift of each
// accumulator; a second kernel adds the runs in f64 in split order, so no
// atomics are used and two runs, on any card, give the same bytes.  FP32
// FMA throughout (no tensor cores, no TF32), f64 for the loglik sum and the
// across-split sums.  A block whose variants are all inactive skips its
// sample loop (late IRLS iterations).
//
// Dense mode (template flag DENSE, K18 in glm_dense.cu): the one genotype
// column is the variant's A1 dosage, as in glm_moments.cuh's dense mode;
// its false branch is the code above, so the plane instantiations compile
// as before.
#pragma once

#include "common.cuh"

namespace {

constexpr int kScale = 1;
constexpr int kResid = 2;

__device__ __forceinline__ void logistic_terms(float eta, float& p, float& q,
                                               float& sp_pos, float& sp_neg) {
  // softplus(x) = max(x, 0) + log1p(exp(-|x|)) as jax.nn.softplus; the same
  // exp(-|eta|) serves p = sigmoid(eta) and q = 1 - p = sigmoid(-eta)
  const float t = expf(-fabsf(eta));
  const float l1 = log1pf(t);
  sp_pos = fmaxf(eta, 0.f) + l1;
  sp_neg = fmaxf(-eta, 0.f) + l1;
  const float big = 1.f / (1.f + t);
  const float small = t * big;
  p = (eta >= 0.f) ? big : small;
  q = (eta >= 0.f) ? small : big;
}

template <int NC, int P, int MODE, int FLAGS, bool DENSE = false>
__global__ void __launch_bounds__(kTileVariants)
irls_pass_kernel(const uint8_t* __restrict__ packed, int64_t nb_bytes, int vb,
                 const float* __restrict__ feat, int64_t npad, int64_t split_len,
                 const float* __restrict__ gw, const float* __restrict__ beta,
                 const float* __restrict__ hinv, const uint8_t* __restrict__ active,
                 const float* __restrict__ sscale, const float* __restrict__ offset,
                 const float* __restrict__ gmean, float* __restrict__ part,
                 double* __restrict__ part_ll) {
  constexpr bool SCALE = (FLAGS & kScale) != 0;
  constexpr bool RESID = (FLAGS & kResid) != 0;
  static_assert(!RESID || NC == 0, "the residualized design has no covariates");
  constexpr int D = NC + P;
  constexpr int F = NC + 2;  // per-sample table: c[0..NC-1], y, mask
  constexpr int NTRI = D * (D + 1) / 2;
  constexpr int NT = NTRI + D;
  extern __shared__ float smem[];
  float* sfeat = smem;
  float* ss = sfeat + kTileSamples * F;                 // SCALE: s
  float* soff = ss + (SCALE ? kTileSamples : 0);        // RESID: offset
  float* shinv = soff + (RESID ? kTileSamples : 0);     // MODE 1: Hinv0

  const int tv = threadIdx.x;
  const int v = blockIdx.x * kTileVariants + tv;
  const int split = blockIdx.y;
  const int64_t s0 = static_cast<int64_t>(split) * split_len;
  const int64_t s1 = min(npad, s0 + split_len);
  const bool on = v < vb && active[v] != 0;

  float b[D];
  float w0[P], w1[P], w2[P], gm[P];
#pragma unroll
  for (int j = 0; j < D; ++j) b[j] = on ? beta[static_cast<int64_t>(v) * D + j] : 0.f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    w0[p] = w1[p] = w2[p] = gm[p] = 0.f;
    if (DENSE) {
      w0[p] = 1.f;  // g enters as the het plane
    } else if (on) {
      w0[p] = gw[(static_cast<int64_t>(v) * P + p) * 3 + 0];
      w1[p] = gw[(static_cast<int64_t>(v) * P + p) * 3 + 1];
      w2[p] = gw[(static_cast<int64_t>(v) * P + p) * 3 + 2];
      if (RESID) gm[p] = gmean[static_cast<int64_t>(v) * P + p];
    }
  }
  if (MODE == 1) {
    int t = 0;
#pragma unroll
    for (int j = 0; j < D; ++j)
#pragma unroll
      for (int k = j; k < D; ++k, ++t)
        shinv[t * kTileVariants + tv] =
            on ? hinv[(static_cast<int64_t>(v) * D + j) * D + k] : 0.f;
  }

  float acc[NT];
#pragma unroll
  for (int e = 0; e < NT; ++e) acc[e] = 0.f;
  double ll = 0.0;
  const uint8_t* row = packed + static_cast<int64_t>(on ? v : 0) * nb_bytes;
  const bool aligned = ((nb_bytes & 3) == 0) &&
                       ((reinterpret_cast<uintptr_t>(packed) & 3) == 0);
  // late IRLS iterations leave few rows active: a block with none skips the
  // sample loop and writes its zero partials
  const int64_t s_end = __syncthreads_or(on) ? s1 : s0;

  for (int64_t t0 = s0; t0 < s_end; t0 += kTileSamples) {
    const int tn = static_cast<int>(min(static_cast<int64_t>(kTileSamples), s1 - t0));
    __syncthreads();
    for (int i = tv; i < tn * F; i += kTileVariants) sfeat[i] = feat[t0 * F + i];
    if (SCALE)
      for (int i = tv; i < tn; i += kTileVariants) ss[i] = sscale[t0 + i];
    if (RESID)
      for (int i = tv; i < tn; i += kTileVariants) soff[i] = offset[t0 + i];
    __syncthreads();
    if (!on) continue;
    for (int j0 = 0; j0 < tn; j0 += 16) {
      const uint32_t codes =
          DENSE ? 0u : load_codes16(row, nb_bytes, t0 + j0, aligned);
      const int kn = min(16, tn - j0);
      for (int k = 0; k < kn; ++k) {
        const int code = (codes >> (2 * k)) & 3;
        const float* f = sfeat + (j0 + k) * F;
        const uint32_t u = DENSE ? load_dosage(row, t0 + j0 + k) : 0u;
        const float valid = (DENSE ? u == 0xFFFFu : code == 3) ? 0.f : f[NC + 1];
        if (valid == 0.f) continue;  // contributes exactly 0 to every sum
        const float hpl = DENSE ? static_cast<float>(u) * (1.f / 16384.f) * valid
                                : (code == 1) ? valid : 0.f;
        const float apl = (code == 2) ? valid : 0.f;
        float x[D];
#pragma unroll
        for (int j = 0; j < NC; ++j) x[j] = f[j];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          x[NC + p] = w0[p] * hpl + w1[p] * apl + w2[p] * valid;
          if (SCALE) x[NC + p] *= ss[j0 + k];
          if (RESID) x[NC + p] = (x[NC + p] - gm[p]) * valid;
        }
        float eta = 0.f;
#pragma unroll
        for (int j = 0; j < D; ++j) eta = fmaf(b[j], x[j], eta);
        if (RESID) eta += soff[j0 + k];
        eta *= valid;
        const float yv = f[NC] * valid;
        float sg, q, sp_pos, sp_neg;
        logistic_terms(eta, sg, q, sp_pos, sp_neg);
        const float p = sg * valid;
        const float y_minus_p = (yv != 0.f) ? q * valid : -p;
        float wt, r;
        if (MODE == 0) {
          ll += static_cast<double>(yv * (-sp_neg) + (valid - yv) * (-sp_pos));
          wt = sg * q * valid;
          r = -y_minus_p;
        } else {
          const float vw = sg * q * valid;
          float quad = 0.f;
          int t = 0;
#pragma unroll
          for (int j = 0; j < D; ++j)
#pragma unroll
            for (int k = j; k < D; ++k, ++t) {
              const float h = shinv[t * kTileVariants + tv] * (k == j ? 1.f : 2.f);
              quad = fmaf(h * x[j], x[k], quad);
            }
          const float hd = vw * quad;
          r = (y_minus_p + hd * (0.5f - p)) * valid;
          wt = (1.f + hd) * vw;
        }
        int t = 0;
#pragma unroll
        for (int j = 0; j < D; ++j) {
          const float wx = wt * x[j];
#pragma unroll
          for (int k = j; k < D; ++k, ++t) acc[t] = fmaf(wx, x[k], acc[t]);
        }
#pragma unroll
        for (int j = 0; j < D; ++j) acc[NTRI + j] = fmaf(r, x[j], acc[NTRI + j]);
      }
    }
  }
  if (v < vb) {
#pragma unroll
    for (int e = 0; e < NT; ++e)
      part[(static_cast<int64_t>(split) * NT + e) * vb + v] = acc[e];
    if (MODE == 0) part_ll[static_cast<int64_t>(split) * vb + v] = ll;
  }
}

template <int NC, int P, int MODE, int FLAGS, bool DENSE>
cudaError_t launch_irls_mode(const dim3 grid, size_t smem, const uint8_t* packed,
                             int64_t nb_bytes, int vb, const float* feat,
                             int64_t npad, int64_t split_len, const float* gw,
                             const float* beta, const float* hinv,
                             const uint8_t* active, const float* sscale,
                             const float* offset, const float* gmean,
                             float* part, double* part_ll, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      irls_pass_kernel<NC, P, MODE, FLAGS, DENSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  irls_pass_kernel<NC, P, MODE, FLAGS, DENSE><<<grid, kTileVariants, smem, stream>>>(
      packed, nb_bytes, vb, feat, npad, split_len, gw, beta, hinv, active,
      sscale, offset, gmean, part, part_ll);
  return cudaGetLastError();
}

template <int NC, int FLAGS, int P = 1, bool DENSE = false>
cudaError_t launch_irls(const uint8_t* packed, int64_t nb_bytes, int vb,
                        const float* feat, int64_t npad, int mode,
                        int64_t split_len, int splits, const float* gw,
                        const float* beta, const float* hinv,
                        const uint8_t* active, const float* sscale,
                        const float* offset, const float* gmean, float* part,
                        double* part_ll, float* out_mat, float* out_vec,
                        double* out_ll, cudaStream_t stream) {
  constexpr int D = NC + P;
  constexpr int F = NC + 2 + ((FLAGS & kScale) ? 1 : 0) + ((FLAGS & kResid) ? 1 : 0);
  constexpr int NTRI = D * (D + 1) / 2;
  const size_t smem = sizeof(float) *
      (kTileSamples * F + (mode == 1 ? NTRI * kTileVariants : 0));
  const dim3 grid((vb + kTileVariants - 1) / kTileVariants, splits);
  const cudaError_t err =
      mode == 0
          ? launch_irls_mode<NC, P, 0, FLAGS, DENSE>(grid, smem, packed, nb_bytes, vb,
                                           feat, npad, split_len, gw, beta,
                                           hinv, active, sscale, offset, gmean,
                                           part, part_ll, stream)
          : launch_irls_mode<NC, P, 1, FLAGS, DENSE>(grid, smem, packed, nb_bytes, vb,
                                           feat, npad, split_len, gw, beta,
                                           hinv, active, sscale, offset, gmean,
                                           part, part_ll, stream);
  if (err != cudaSuccess) return err;
  return launch_reduce<D>(part, mode == 0 ? part_ll : nullptr, splits, vb, 1,
                          out_mat, out_vec, out_ll, stream);
}

}  // namespace
