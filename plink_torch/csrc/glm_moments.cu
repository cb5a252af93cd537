// K2 glm_moments: per-variant moments matrix of the hybrid-GLM scan.
//
// Replaces (plink_tpu/ops/glm.py) `_plane_cols` (:288) followed by
// `_moments_from_cols` (:242) as `_glm_scan_body` calls them (:813-815):
//   momy[v] = sum_s valid(v,s) x_s x_s^T,
//   x_s = [cy_s (dc covariates incl. intercept, then y) | G_1(v,s) | ADD(v,s)],
// where each predictor column G_p = wH*het + wA*homalt + wV*valid is decoded
// from the packed 2-bit row with the per-variant plane weights gwm [vb, 2, 3].
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
#include "common.cuh"

namespace {

template <int DC, bool SCALE>
__global__ void __launch_bounds__(kTileVariants)
moments_kernel(const uint8_t* __restrict__ packed, int64_t nb_bytes, int vb,
               const float* __restrict__ feat, int64_t npad, int64_t split_len,
               const float* __restrict__ gwm, const float* __restrict__ sscale,
               float* __restrict__ part) {
  constexpr int NC = DC + 1;  // cy columns
  constexpr int D = NC + 2;   // + model predictor + ADD
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

  float w[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) w[i] = on ? gwm[static_cast<int64_t>(v) * 6 + i] : 0.f;
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
      const uint32_t codes = load_codes16(row, nb_bytes, t0 + j0, aligned);
      const int kn = min(16, tn - j0);
      for (int k = 0; k < kn; ++k) {
        const int code = (codes >> (2 * k)) & 3;
        const float* f = sfeat + (j0 + k) * F;
        const float valid = (code == 3) ? 0.f : f[NC];
        if (valid == 0.f) continue;
        const float hpl = (code == 1) ? valid : 0.f;
        const float apl = (code == 2) ? valid : 0.f;
        float x[D];
#pragma unroll
        for (int j = 0; j < NC; ++j) x[j] = f[j];
        x[NC] = w[0] * hpl + w[1] * apl + w[2] * valid;
        x[NC + 1] = w[3] * hpl + w[4] * apl + w[5] * valid;
        if (SCALE) {
          x[NC] *= ss[j0 + k];
          x[NC + 1] *= ss[j0 + k];
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

template <int DC>
cudaError_t launch_moments(const uint8_t* packed, int64_t nb_bytes, int vb,
                           const float* feat, int64_t npad, int64_t split_len,
                           int splits, const float* gwm, const float* sscale,
                           float* part, float* out, cudaStream_t stream) {
  constexpr int D = DC + 3;
  const size_t smem = sizeof(float) * kTileSamples * (DC + 2 + (sscale ? 1 : 0));
  const dim3 grid((vb + kTileVariants - 1) / kTileVariants, splits);
  if (sscale)
    moments_kernel<DC, true><<<grid, kTileVariants, smem, stream>>>(
        packed, nb_bytes, vb, feat, npad, split_len, gwm, sscale, part);
  else
    moments_kernel<DC, false><<<grid, kTileVariants, smem, stream>>>(
        packed, nb_bytes, vb, feat, npad, split_len, gwm, nullptr, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce<D>(part, nullptr, splits, vb, 0, out, nullptr, nullptr,
                          stream);
}

}  // namespace

// packed [vb, nb_bytes] u8; feat [npad, dc+2] f32 = [c | y | mask]
// (npad = 4 * nb_bytes); gwm [vb, 2, 3]; sscale [npad] f32 or null (the
// unscaled kernel); part [splits, NTRI, vb] f32 scratch; out [vb, dc+3,
// dc+3].
PT_EXPORT int pt_glm_moments(const void* packed, long long nb_bytes, int vb,
                             const void* feat, long long npad, int dc,
                             long long split_len, int splits, const void* gwm,
                             const void* sscale, void* part, void* out,
                             void* stream) {
#define PT_CASE(N)                                                          \
  case N:                                                                   \
    return launch_moments<N>(                                               \
        static_cast<const uint8_t*>(packed), nb_bytes, vb,                  \
        static_cast<const float*>(feat), npad, split_len, splits,           \
        static_cast<const float*>(gwm), static_cast<const float*>(sscale),  \
        static_cast<float*>(part),                                          \
        static_cast<float*>(out), static_cast<cudaStream_t>(stream));
  switch (dc) {
    PT_NC_CASES(PT_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef PT_CASE
}
