// K2 glm_moments, one model predictor (P = 1: the additive, dominant,
// recessive and hetonly designs of the main path; dc = 1..16).  The kernel
// and its notes are in glm_moments.cuh; glm_moments_p2.cu holds P = 2.
#include "glm_moments.cuh"

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
