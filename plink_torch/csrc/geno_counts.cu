// K1 geno_counts: exact per-variant genotype counts for up to three sample
// masks in one pass over the packed genotypes.
//
// Replaces (plink_tpu/ops/counts.py) `_geno_counts_multimask` (:98) as
// `_geno_counts_scan` (:134) runs it over the block tensor: for each mask g
// and variant v, (hom-REF, het, hom-ALT, missing) counts over the samples of
// the mask, hom-REF taken as |mask| minus the other three as there.
//
// Bound: bytes.  Every packed byte is read once (2.05 GB for 16,384 variants
// of 500,000 samples, ~0.6 ms at 3.35 TB/s); the work per byte is a few
// integer operations.  Design: one block per variant row; threads stride
// over 32-bit words (16 samples) of the row, AND each word with the mask
// expanded to 2 bits per sample (0b11 = in the mask, read from L2/L1 since
// it is shared by every row), and count het / hom-ALT / missing codes with
// popcounts of the low and high bit lanes.  Per-thread integer counters are
// summed by a fixed-order tree in shared memory; no atomics.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int G>
__global__ void __launch_bounds__(kThreads)
geno_counts_kernel(const uint8_t* __restrict__ packed, int64_t nb_bytes,
                   const uint8_t* __restrict__ mask2,
                   const int* __restrict__ nmask, int nvar,
                   int* __restrict__ out) {
  __shared__ int red[G * 3][kThreads];
  const int v = blockIdx.x;
  const int tid = threadIdx.x;
  const uint8_t* row = packed + static_cast<int64_t>(v) * nb_bytes;
  int cnt[G][3];
#pragma unroll
  for (int g = 0; g < G; ++g) cnt[g][0] = cnt[g][1] = cnt[g][2] = 0;
  const bool aligned = ((nb_bytes & 3) == 0) &&
                       ((reinterpret_cast<uintptr_t>(packed) & 3) == 0) &&
                       ((reinterpret_cast<uintptr_t>(mask2) & 3) == 0);
  if (aligned) {
    const int64_t nw = nb_bytes >> 2;
    const uint32_t* rw = reinterpret_cast<const uint32_t*>(row);
    const uint32_t* mw = reinterpret_cast<const uint32_t*>(mask2);
    for (int64_t i = tid; i < nw; i += kThreads) {
      const uint32_t w = rw[i];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const uint32_t x = w & mw[g * nw + i];
        const uint32_t lo = x & 0x55555555u;
        const uint32_t hi = (x >> 1) & 0x55555555u;
        cnt[g][0] += __popc(lo & ~hi);
        cnt[g][1] += __popc(hi & ~lo);
        cnt[g][2] += __popc(lo & hi);
      }
    }
  } else {
    for (int64_t i = tid; i < nb_bytes; i += kThreads) {
      const uint32_t w = row[i];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const uint32_t x = w & mask2[g * nb_bytes + i];
        const uint32_t lo = x & 0x55u;
        const uint32_t hi = (x >> 1) & 0x55u;
        cnt[g][0] += __popc(lo & ~hi);
        cnt[g][1] += __popc(hi & ~lo);
        cnt[g][2] += __popc(lo & hi);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < 3; ++c) red[g * 3 + c][tid] = cnt[g][c];
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (tid < half)
#pragma unroll
      for (int e = 0; e < G * 3; ++e) red[e][tid] += red[e][tid + half];
    __syncthreads();
  }
  if (tid < G) {
    const int het = red[tid * 3][0], alt = red[tid * 3 + 1][0],
              miss = red[tid * 3 + 2][0];
    int* o = out + (static_cast<int64_t>(tid) * nvar + v) * 4;
    o[0] = nmask[tid] - het - alt - miss;
    o[1] = het;
    o[2] = alt;
    o[3] = miss;
  }
}

template <int G>
cudaError_t launch_counts(const uint8_t* packed, int64_t nb_bytes,
                          const uint8_t* mask2, const int* nmask, int nvar,
                          int* out, cudaStream_t stream) {
  geno_counts_kernel<G><<<nvar, kThreads, 0, stream>>>(packed, nb_bytes, mask2,
                                                       nmask, nvar, out);
  return cudaGetLastError();
}

}  // namespace

// packed [nvar, nb_bytes] u8; mask2 [G, nb_bytes] u8 with 0b11 in the 2-bit
// field of every sample inside the mask; nmask [G] i32 mask sizes;
// out [G, nvar, 4] i32.
PT_EXPORT int pt_geno_counts(const void* packed, long long nb_bytes,
                             const void* mask2, const void* nmask, int groups,
                             int nvar, void* out, void* stream) {
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const uint8_t* m = static_cast<const uint8_t*>(mask2);
  const int* n = static_cast<const int*>(nmask);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nvar == 0) return cudaSuccess;
  switch (groups) {
    case 1: return launch_counts<1>(p, nb_bytes, m, n, nvar, o, s);
    case 2: return launch_counts<2>(p, nb_bytes, m, n, nvar, o, s);
    case 3: return launch_counts<3>(p, nb_bytes, m, n, nvar, o, s);
    default: return cudaErrorInvalidValue;
  }
}
