// K2 glm_moments with two model predictors (P = 2: the genotypic and hethom
// models), so three predictor columns [G_1 G_2 ADD] after [c | y]: D = dc + 4
// (16 at dc = 12, 136 accumulators per thread).  The kernel and its notes
// are in glm_moments.cuh; built apart from glm_moments.cu so that nvcc
// compiles the two sets of instantiations in parallel.  No scaled mode: the
// diploid-only models never take the --xchr-model 1 multiplier in the CLI,
// and ops/glm.py sends a scaled P = 2 design to K15.
#include "glm_moments.cuh"

// As pt_glm_moments with gwm [vb, 3, 3] and out [vb, dc+4, dc+4].
PT_EXPORT int pt_glm_moments_p2(const void* packed, long long nb_bytes, int vb,
                                const void* feat, long long npad, int dc,
                                long long split_len, int splits,
                                const void* gwm, void* part, void* out,
                                void* stream) {
#define PT_CASE(N)                                                          \
  case N:                                                                   \
    return launch_moments<N, 3, false>(                                            \
        static_cast<const uint8_t*>(packed), nb_bytes, vb,                  \
        static_cast<const float*>(feat), npad, split_len, splits,           \
        static_cast<const float*>(gwm), nullptr, static_cast<float*>(part), \
        static_cast<float*>(out), static_cast<cudaStream_t>(stream));
  switch (dc) {
    PT_NC_CASES(PT_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef PT_CASE
}
