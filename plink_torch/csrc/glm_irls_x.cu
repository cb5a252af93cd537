// K3 glm_irls_pass, the scaled design [c | G s] of --xchr-model 1 (dc =
// 1..16) and the residualized design of cc-/firth-residualize (dc = 0, with
// or without s), each in logistic and firth2 modes.  The kernel and its
// notes are in glm_irls.cuh; built apart from glm_irls.cu so that nvcc
// compiles the two sets of instantiations in parallel.
#include "glm_irls.cuh"

// As pt_glm_irls_pass, plus flags (kScale = 1: sscale [npad] f32 multiplies
// G; kResid = 2: dc = 0, G' = (G - gmean[v]) * valid with gmean [vb] f32,
// and offset [npad] f32 added to the linear predictor).  Unused pointers
// may be null.
PT_EXPORT int pt_glm_irls_pass_x(const void* packed, long long nb_bytes, int vb,
                                 const void* feat, long long npad, int dc,
                                 int mode, int flags, long long split_len,
                                 int splits, const void* gw, const void* beta,
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
  if (flags == kResid && dc == 0) return launch_irls<0, kResid>(PT_ARGS);
  if (flags == (kResid | kScale) && dc == 0)
    return launch_irls<0, kResid | kScale>(PT_ARGS);
  if (flags != kScale) return cudaErrorInvalidValue;
#define PT_CASE(N) \
  case N:          \
    return launch_irls<N, kScale>(PT_ARGS);
  switch (dc) {
    PT_NC_CASES(PT_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef PT_CASE
#undef PT_ARGS
}
