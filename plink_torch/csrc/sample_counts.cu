// K5 sample_counts: exact per-sample genotype-class counts over the variants
// of one or two variant masks, in one pass over the packed genotypes.
//
// Replaces (plink_tpu/ops/counts.py) `_sample_miss_counts` (:72) and
// `_sample_het_hom_counts` (:84): for each mask g and sample s, the number
// of variants v with vmask[v, g] > 0 whose code at s is missing (mode 0),
// or the (het, hom-ALT, missing) counts (mode 1).  --mind and --missing's
// .smiss (a non-Y and a Y mask, so G = 2) take mode 0.
//
// Bound: bytes.  Every packed byte is read once (512 MB for 4,096 variants
// of 500,000 samples, ~0.15 ms at 3.35 TB/s); the work per byte is a few
// integer operations.  Design: it is a column reduction, so one thread per
// packed byte (4 samples) walks a chunk of variant rows, neighbouring
// threads on neighbouring bytes of the same row (coalesced), with the row's
// mask values read once per row by the whole block.  A thread per 4-byte
// word would leave 31,250 threads at 500,000 samples, under two blocks of
// 128 per SM; a thread per byte gives 125,000, and the variant axis is cut
// into chunks of kRowsPerBlock rows (blockIdx.y) so that enough blocks are
// in flight.  Chunks are added with integer atomics: integer sums are
// exact in any order, so two runs give identical bytes.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 256;

template <int G, int K>
__global__ void __launch_bounds__(kThreads)
sample_counts_kernel(const uint8_t* __restrict__ packed, int64_t nb_bytes,
                     int nvar, const float* __restrict__ vmask,
                     int* __restrict__ out) {
  __shared__ float smask[kRowsPerBlock * G];
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int v0 = blockIdx.y * kRowsPerBlock;
  const int nrows = min(kRowsPerBlock, nvar - v0);
  for (int i = threadIdx.x; i < nrows * G; i += kThreads)
    smask[i] = vmask[static_cast<int64_t>(v0) * G + i];
  __syncthreads();
  if (b >= nb_bytes) return;
  // cnt[g][k][j]: class k (mode 0: missing; mode 1: het, hom-ALT, missing)
  // of sample 4b + j
  int cnt[G][K][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) cnt[g][k][j] = 0;
  const uint8_t* p = packed + static_cast<int64_t>(v0) * nb_bytes + b;
  for (int r = 0; r < nrows; ++r, p += nb_bytes) {
    bool any = false;
#pragma unroll
    for (int g = 0; g < G; ++g) any |= smask[r * G + g] > 0.f;
    if (!any) continue;
    const uint32_t x = *p;
    const uint32_t lo = x & 0x55u, hi = (x >> 1) & 0x55u;
    uint32_t cls[3];
    if (K == 1) {
      cls[0] = lo & hi;
    } else {
      cls[0] = lo & ~hi;
      cls[1] = hi & ~lo;
      cls[2] = lo & hi;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int on = smask[r * G + g] > 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          cnt[g][k][j] += on & static_cast<int>((cls[k] >> (2 * j)) & 1u);
    }
  }
  const int64_t npad = 4 * nb_bytes;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (cnt[g][k][j])
          atomicAdd(out + (static_cast<int64_t>(g) * K + k) * npad + 4 * b + j,
                    cnt[g][k][j]);
}

template <int G, int K>
cudaError_t launch_sample_counts(const uint8_t* packed, int64_t nb_bytes,
                                 int nvar, const float* vmask, int* out,
                                 cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((nb_bytes + kThreads - 1) / kThreads),
                  (nvar + kRowsPerBlock - 1) / kRowsPerBlock);
  sample_counts_kernel<G, K><<<grid, kThreads, 0, stream>>>(
      packed, nb_bytes, nvar, vmask, out);
  return cudaGetLastError();
}

}  // namespace

// packed [nvar, nb_bytes] u8; vmask [nvar, G] f32 (> 0 = variant counted);
// out [G, K, 4 * nb_bytes] i32, zeroed by the caller; K = 1 (mode 0,
// missing) or 3 (mode 1: het, hom-ALT, missing).
PT_EXPORT int pt_sample_counts(const void* packed, long long nb_bytes, int nvar,
                               const void* vmask, int groups, int mode,
                               void* out, void* stream) {
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const float* m = static_cast<const float*>(vmask);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nvar == 0 || nb_bytes == 0) return cudaSuccess;
  if (groups == 1 && mode == 0) return launch_sample_counts<1, 1>(p, nb_bytes, nvar, m, o, s);
  if (groups == 2 && mode == 0) return launch_sample_counts<2, 1>(p, nb_bytes, nvar, m, o, s);
  if (groups == 1 && mode == 1) return launch_sample_counts<1, 3>(p, nb_bytes, nvar, m, o, s);
  if (groups == 2 && mode == 1) return launch_sample_counts<2, 3>(p, nb_bytes, nvar, m, o, s);
  return cudaErrorInvalidValue;
}
