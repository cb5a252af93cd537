// K3 glm_irls_pass with two genotype predictor columns (P = 2): the
// genotypic (ADD, DOMDEV) and hethom (HOM, HET) models of --glm, over the
// plain design [c | G_1 G_2] (dc = 1..16) and the residualized design
// [G'_1 G'_2] of `genotypic cc-residualize` (dc = 0, with or without the
// per-sample multiplier), each in logistic and firth2 modes.  The kernel and
// its notes are in glm_irls.cuh; built apart from glm_irls.cu and
// glm_irls_x.cu so that nvcc compiles the three sets of instantiations in
// parallel.  At dc = 12 (SEX + 10 PCs) the design is d = 14: 105 + 14
// accumulators per thread.
#include "glm_irls.cuh"

// As pt_glm_irls_pass_x with gw [vb, 2, 3], beta [vb, dc+2], hinv
// [vb, d, d], gmean [vb, 2] (kResid); flags 0 (plain design, dc >= 1),
// kResid or kResid | kScale (dc = 0).
PT_EXPORT int pt_glm_irls_pass_p2(const void* packed, long long nb_bytes,
                                  int vb, const void* feat, long long npad,
                                  int dc, int mode, int flags,
                                  long long split_len, int splits,
                                  const void* gw, const void* beta,
                                  const void* hinv, const void* active,
                                  const void* sscale, const void* offset,
                                  const void* gmean, void* part, void* part_ll,
                                  void* out_mat, void* out_vec, void* out_ll,
                                  void* stream) {
  if (mode != 0 && mode != 1) return cudaErrorInvalidValue;
#define PT_ARGS                                                              \
  static_cast<const uint8_t*>(packed), nb_bytes, vb,                         \
      static_cast<const float*>(feat), npad, mode, split_len, splits,        \
      static_cast<const float*>(gw), static_cast<const float*>(beta),        \
      static_cast<const float*>(hinv), static_cast<const uint8_t*>(active),  \
      static_cast<const float*>(sscale), static_cast<const float*>(offset),  \
      static_cast<const float*>(gmean), static_cast<float*>(part),           \
      static_cast<double*>(part_ll), static_cast<float*>(out_mat),           \
      static_cast<float*>(out_vec), static_cast<double*>(out_ll),            \
      static_cast<cudaStream_t>(stream)
  if (flags == kResid && dc == 0) return launch_irls<0, kResid, 2>(PT_ARGS);
  if (flags == (kResid | kScale) && dc == 0)
    return launch_irls<0, kResid | kScale, 2>(PT_ARGS);
  if (flags != 0) return cudaErrorInvalidValue;
#define PT_CASE(N) \
  case N:          \
    return launch_irls<N, 0, 2>(PT_ARGS);
  switch (dc) {
    PT_NC_CASES(PT_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef PT_CASE
#undef PT_ARGS
}
