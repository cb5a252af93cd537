// K17 glm_dense_moments and K18 glm_dense_irls: the moments matrix and one
// logistic / Firth IRLS evaluation of the dosage --glm, whose genotype
// column is a fractional A1 dosage per (variant, sample) instead of a
// combination of 2-bit planes.
//
// Replaces (plink_tpu/ops/glm.py) the device halves of `dense_qt_block`
// (:689: X^T X over [c | g], X^T y, y'y, sum g, sum g^2, obs), of
// `dense_cc_block` (:655: the same moments and sum g y, then
// `_logistic_core` or `_firth_core` on [c | g]) and of `dense_firth_block`
// (:677: `_firth_core`).  The kernels are K2's and K3's templates
// (glm_moments.cuh, glm_irls.cuh) in their dense mode: the template flag
// DENSE replaces the 2-bit decode by a load of the variant's dosage and
// feeds it in as the het plane with weights (1, 0, 0) (g = 1 * g + 0 + 0,
// exactly), so their arithmetic, their split of the sample axis into
// runs of at most 2,048 samples per f32 accumulator, the f64 sum of the
// runs in index order, the f64 log-likelihood and the Firth hat value are
// K2's and K3's, and the main path's K2 / K3 instantiations (DENSE false)
// compile as before.
//   K17 (mode moments): momy[v] = sum_s valid x x^T over x = [c | y | g],
//       D = dc + 2 (14 at SEX + 10 PCs): every output of dense_qt_block and
//       dense_cc_block's sums is an entry of it (obs = [0, 0], sum g =
//       [0, D-1], sum g y = [dc, D-1], sum g^2 = [D-1, D-1], y'y = [dc, dc]);
//   K18 (modes logistic, firth2): H = sum w x x^T, X^T r and the f64
//       loglik over x = [c | g], as K3.
//
// Input: the A1 dosage as uint16 [vb, npad] in 1/16384 units (32768 = two
// copies), 65535 where the sample's dosage is missing and in the padding.
// u / 16384 is exact in f32, so g and valid equal bit for bit the f32
// dosage and finite mask that plink_tpu builds on the host
// (plink_tpu/commands/glm.py:2438-2450), from 2 bytes a sample instead of 8.
//
// Bound: operations, as K2 / K3 (D(D+1)/2 = 105 multiply-adds a (variant,
// sample) pair for K17 at dc = 12; ~200 FP32 instructions for K18) against
// 2 bytes of input a pair.  Each thread reads its variant's dosages with
// one 2-byte load a sample through the read-only cache (a 128-byte line
// holds 64 samples of the row, which the thread walks in order); no
// tensor cores (JAX runs these at Precision.HIGH), no atomics.  A design
// wider than dc = 16 runs on K15 / K16's dense mode (glm_wide.cu).
#include "glm_irls.cuh"
#include "glm_moments.cuh"

// K17.  dos [vb, npad] u16; feat [npad, dc+2] f32 = [c | y | mask]; part
// [splits, NTRI, vb] f32 scratch; out [vb, dc+2, dc+2] over [c | y | g].
PT_EXPORT int pt_glm_dense_moments(const void* dos, int vb, const void* feat,
                                   long long npad, int dc, long long split_len,
                                   int splits, void* part, void* out,
                                   void* stream) {
#define PT_CASE(N)                                                           \
  case N:                                                                    \
    return launch_moments<N, 1, false, true>(                                \
        static_cast<const uint8_t*>(dos), 2 * npad, vb,                      \
        static_cast<const float*>(feat), npad, split_len, splits, nullptr,   \
        nullptr, static_cast<float*>(part), static_cast<float*>(out),        \
        static_cast<cudaStream_t>(stream));
  switch (dc) {
    PT_NC_CASES(PT_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef PT_CASE
}

// K18, mode 0 = logistic, 1 = firth2.  dos [vb, npad] u16; feat [npad,
// dc+2] f32 = [c | y | mask]; beta [vb, dc+1]; hinv [vb, d, d] (mode 1);
// active [vb] u8; part / part_ll scratch and outputs as pt_glm_irls_pass.
PT_EXPORT int pt_glm_dense_irls(const void* dos, int vb, const void* feat,
                                long long npad, int dc, int mode,
                                long long split_len, int splits,
                                const void* beta, const void* hinv,
                                const void* active, void* part, void* part_ll,
                                void* out_mat, void* out_vec, void* out_ll,
                                void* stream) {
  if (mode != 0 && mode != 1) return cudaErrorInvalidValue;
#define PT_CASE(N)                                                           \
  case N:                                                                    \
    return launch_irls<N, 0, 1, true>(                                       \
        static_cast<const uint8_t*>(dos), 2 * npad, vb,                      \
        static_cast<const float*>(feat), npad, mode, split_len, splits,      \
        nullptr, static_cast<const float*>(beta),                            \
        static_cast<const float*>(hinv), static_cast<const uint8_t*>(active),\
        nullptr, nullptr, nullptr, static_cast<float*>(part),                \
        static_cast<double*>(part_ll), static_cast<float*>(out_mat),         \
        static_cast<float*>(out_vec), static_cast<double*>(out_ll),          \
        static_cast<cudaStream_t>(stream));
  switch (dc) {
    PT_NC_CASES(PT_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef PT_CASE
}
