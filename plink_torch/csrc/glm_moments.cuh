// K2 glm_moments: per-variant moments matrix of the hybrid-GLM scan.  The
// kernel template is instantiated by glm_moments.cu (one model predictor,
// the main path) and glm_moments_p2.cu (two: genotypic, hethom), which nvcc
// builds in parallel.
//
// Replaces (plink_tpu/ops/glm.py) `_plane_cols` (:288) followed by
// `_moments_from_cols` (:242) as `_glm_scan_body` calls them (:813-815):
//   momy[v] = sum_s valid(v,s) x_s x_s^T,
//   x_s = [cy_s (dc covariates incl. intercept, then y) | G_1..G_P(v,s) | ADD(v,s)],
// where each predictor column G_p = wH*het + wA*homalt + wV*valid is decoded
// from the packed 2-bit row with the per-variant plane weights gwm
// [vb, NP, 3] (NP = P + 1 columns: the model's P predictors and ADD; the
// NP = 2 instantiations unroll to the code the kernel ran before NP
// existed).  Designs whose columns carry a covariate factor run on K15
// (glm_wide.cu).
// The host reads the collinearity screen, the IRLS start and the
// A1-dosage/case/count statistics (mstats) from this matrix.  The integer
// valued entries (counts, dosage sums) stay exact: they are f32 sums of
// small integers far below 2^24.
//
// Bound: operations.  D(D+1)/2 = 120 multiply-adds per (variant, sample)
// pair at D = 15 against 2 bits of packed input.  Design as K3
// (glm_irls.cu): one thread per variant holds the packed upper triangle in
// registers, 64 variants per block share a 128-sample tile of [cy | mask] in
// shared memory, the sample axis is split over blockIdx.y into runs of at
// most 2,048 samples and the runs are added in f64 in index order by a
// second kernel; no [vb, n] plane is written to HBM, no atomics, FP32 FMA
// for the per-sample products.
//
// Scaled mode (SCALE, --xchr-model 1): both predictor columns are multiplied
// by a per-sample genotype multiplier s after the plane combination
// (plink_tpu `_plane_cols` :313-314, sscale; 0.5 for males on chrX), read
// from a second shared-memory tile.  A template flag, so the unscaled
// instantiations of the main path compile as before.
//
// Dense mode (DENSE, K17 in glm_dense.cu): the one predictor column is the
// variant's A1 dosage g = u / 16384 read from a uint16 row (`packed` is then
// the dosage array and `nb_bytes` its row stride; 65535 = missing) in place
// of the 2-bit decode: g enters as the het plane with weights (1, 0, 0).  A
// template flag whose false branch is the code above, so the plane
// instantiations compile as before.
#pragma once

#include "common.cuh"

namespace {

template <int DC, int NP, bool SCALE, bool DENSE = false>
__global__ void __launch_bounds__(kTileVariants)
moments_kernel(const uint8_t* __restrict__ packed, int64_t nb_bytes, int vb,
               const float* __restrict__ feat, int64_t npad, int64_t split_len,
               const float* __restrict__ gwm, const float* __restrict__ sscale,
               float* __restrict__ part) {
  constexpr int NC = DC + 1;  // cy columns
  constexpr int D = NC + NP;  // + model predictors + ADD
  constexpr int F = NC + 1;   // per-sample table: cy[0..NC-1], mask
  constexpr int NTRI = D * (D + 1) / 2;
  extern __shared__ float sfeat[];
  float* ss = sfeat + kTileSamples * F;  // SCALE: s of the tile's samples

  const int tv = threadIdx.x;
  const int v = blockIdx.x * kTileVariants + tv;
  const int split = blockIdx.y;
  const int64_t s0 = static_cast<int64_t>(split) * split_len;
  const int64_t s1 = min(npad, s0 + split_len);
  const bool on = v < vb;

  float w[3 * NP];
#pragma unroll
  for (int i = 0; i < 3 * NP; ++i)
    w[i] = DENSE ? (i == 0 ? 1.f : 0.f)
                 : on ? gwm[static_cast<int64_t>(v) * (3 * NP) + i] : 0.f;
  float acc[NTRI];
#pragma unroll
  for (int e = 0; e < NTRI; ++e) acc[e] = 0.f;
  const uint8_t* row = packed + static_cast<int64_t>(on ? v : 0) * nb_bytes;
  const bool aligned = ((nb_bytes & 3) == 0) &&
                       ((reinterpret_cast<uintptr_t>(packed) & 3) == 0);

  for (int64_t t0 = s0; t0 < s1; t0 += kTileSamples) {
    const int tn = static_cast<int>(min(static_cast<int64_t>(kTileSamples), s1 - t0));
    __syncthreads();
    for (int i = tv; i < tn * F; i += kTileVariants) sfeat[i] = feat[t0 * F + i];
    if (SCALE)
      for (int i = tv; i < tn; i += kTileVariants) ss[i] = sscale[t0 + i];
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
        const float valid = (DENSE ? u == 0xFFFFu : code == 3) ? 0.f : f[NC];
        if (valid == 0.f) continue;
        const float hpl = DENSE ? static_cast<float>(u) * (1.f / 16384.f) * valid
                                : (code == 1) ? valid : 0.f;
        const float apl = (code == 2) ? valid : 0.f;
        float x[D];
#pragma unroll
        for (int j = 0; j < NC; ++j) x[j] = f[j];
#pragma unroll
        for (int p = 0; p < NP; ++p)
          x[NC + p] = w[3 * p] * hpl + w[3 * p + 1] * apl + w[3 * p + 2] * valid;
        if (SCALE) {
#pragma unroll
          for (int p = 0; p < NP; ++p) x[NC + p] *= ss[j0 + k];
        }
        int t = 0;
#pragma unroll
        for (int j = 0; j < D; ++j) {
          const float wx = valid * x[j];
#pragma unroll
          for (int k2 = j; k2 < D; ++k2, ++t) acc[t] = fmaf(wx, x[k2], acc[t]);
        }
      }
    }
  }
  if (on) {
#pragma unroll
    for (int e = 0; e < NTRI; ++e)
      part[(static_cast<int64_t>(split) * NTRI + e) * vb + v] = acc[e];
  }
}

// SCALED = false leaves the scaled kernel out of the build (a non-null
// sscale is then refused).
template <int DC, int NP = 2, bool SCALED = true, bool DENSE = false>
cudaError_t launch_moments(const uint8_t* packed, int64_t nb_bytes, int vb,
                           const float* feat, int64_t npad, int64_t split_len,
                           int splits, const float* gwm, const float* sscale,
                           float* part, float* out, cudaStream_t stream) {
  constexpr int D = DC + 1 + NP;
  const size_t smem = sizeof(float) * kTileSamples * (DC + 2 + (sscale ? 1 : 0));
  const dim3 grid((vb + kTileVariants - 1) / kTileVariants, splits);
  if (sscale) {
    if constexpr (!SCALED) return cudaErrorInvalidValue;
    else
      moments_kernel<DC, NP, true, DENSE><<<grid, kTileVariants, smem, stream>>>(
          packed, nb_bytes, vb, feat, npad, split_len, gwm, sscale, part);
  } else
    moments_kernel<DC, NP, false, DENSE><<<grid, kTileVariants, smem, stream>>>(
        packed, nb_bytes, vb, feat, npad, split_len, gwm, nullptr, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce<D>(part, nullptr, splits, vb, 0, out, nullptr, nullptr,
                          stream);
}

}  // namespace
