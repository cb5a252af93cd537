// K3 glm_irls_pass, the plain design [c | G] of the main path (dc = 1..16,
// logistic and firth2 modes).  The kernel and its notes are in glm_irls.cuh;
// glm_irls_x.cu holds the scaled and residualized designs.
#include "glm_irls.cuh"

// mode 0 = logistic, 1 = firth2.  packed [vb, nb_bytes] u8; feat [npad, dc+2]
// f32 (npad = 4 * nb_bytes); gw [vb, 3]; beta [vb, dc+1]; hinv [vb, d, d]
// (mode 1 only); active [vb] u8; part [splits, NT, vb] f32 and part_ll
// [splits, vb] f64 scratch; out_mat [vb, d, d], out_vec [vb, d], out_ll [vb]
// f64.
PT_EXPORT int pt_glm_irls_pass(const void* packed, long long nb_bytes, int vb,
                               const void* feat, long long npad, int dc,
                               int mode, long long split_len, int splits,
                               const void* gw, const void* beta,
                               const void* hinv, const void* active, void* part,
                               void* part_ll, void* out_mat, void* out_vec,
                               void* out_ll, void* stream) {
  if (mode != 0 && mode != 1) return cudaErrorInvalidValue;
#define PT_CASE(N)                                                           \
  case N:                                                                    \
    return launch_irls<N, 0>(                                                \
        static_cast<const uint8_t*>(packed), nb_bytes, vb,                   \
        static_cast<const float*>(feat), npad, mode, split_len, splits,      \
        static_cast<const float*>(gw), static_cast<const float*>(beta),      \
        static_cast<const float*>(hinv), static_cast<const uint8_t*>(active),\
        nullptr, nullptr, nullptr,                                           \
        static_cast<float*>(part), static_cast<double*>(part_ll),            \
        static_cast<float*>(out_mat), static_cast<float*>(out_vec),          \
        static_cast<double*>(out_ll), static_cast<cudaStream_t>(stream));
  switch (dc) {
    PT_NC_CASES(PT_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef PT_CASE
}
