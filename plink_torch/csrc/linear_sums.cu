// K6 linear_sums: per-variant plane-weighted sufficient statistics of the
// linear GLM.
//
// Replaces (plink_tpu/ops/glm.py) `_linear_sums_body` (:46) as
// `linear_sums_scan` (:94) runs it per variant block: over the het (H),
// hom-ALT (A) and missing (m) planes of each variant, the sums of c_j c_k
// (hcc/acc/mcc), of c_j y (hcy/acy/mcy) and of y^2 (myy; only the missing
// plane's is used).  The host assembles any model's X^T X and X^T y from
// them and the sample-set totals.
//
// A1 orientation: for a variant flagged in `a1_ref` (its A1 allele is REF)
// the kernel swaps the hom-REF and hom-ALT codes as it decodes, so the
// second plane holds the hom-A1 samples for every variant and the host
// assembles each model from the A1 weights alone.  plink_tpu sums the
// hom-ALT plane and forms such a variant's A1 dosage as 2 valid - het -
// 2 hom-ALT: for a rare REF allele that cancels the f32 sums of nearly
// every sample down to a few carriers (2e-3 in P on interaction designs
// at n = 2,000).
//
// Bound: operations.  The planes are mutually exclusive and c_j c_k is
// symmetric, so each (variant, sample) pair whose code is not the unsummed
// homozygote (hom-REF, or hom-ALT where swapped) adds one feature row
// [c_j c_k (j <= k) | c_j y | y^2] of NF = dc(dc+1)/2 + dc + 1 entries
// (91 at dc = 12) to one of three accumulator rows: ~1e11 FP32
// adds for 2,048 variants of 500,000 samples against 256 MB of packed
// input.  Design: a small GEMM of the 0/1 plane indicators by the feature
// table.  A block takes 32 variants (8 per warp) and one split of at most
// 2,048 samples (blockIdx.y); 64-sample tiles of the feature table are
// staged in shared memory, padded to whole warps.  Within a warp every lane
// sees the same variant and sample, so the plane choice is uniform across
// the warp, and lane l accumulates entries l, l + 32, ... of the row: each
// feature value read from shared memory serves the warp's 8 variants.  The
// sums of a split stay in f32 (at most 2,048 terms); a second kernel adds
// the splits in f64 in index order and writes the full symmetric layout.
// No atomics: two runs give identical bytes.
//
// Any width: a row of more than 160 entries (dc > 16, e.g. `interaction`
// over many covariates) is cut into chunks of 160 over a third grid axis;
// each block of the axis decodes the same codes and sums its own chunk.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kWarpVariants = 8;
constexpr int kBlockVariants = kWarps * kWarpVariants;
constexpr int kLinTile = 64;  // samples per shared-memory tile

// EPL = feature entries per lane (NF <= 32 * EPL)
template <int EPL>
__global__ void __launch_bounds__(kWarps * 32)
linear_sums_kernel(const uint8_t* __restrict__ packed, int64_t nb_bytes,
                   int vb, const uint8_t* __restrict__ a1_ref,
                   const float* __restrict__ feat, int nf, int64_t npad,
                   int64_t split_len, float* __restrict__ part) {
  constexpr int NFP = EPL * 32;
  __shared__ float sfeat[kLinTile * NFP];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int vbase = blockIdx.x * kBlockVariants + warp * kWarpVariants;
  const int split = blockIdx.y;
  const int f0 = blockIdx.z * NFP;  // this block's chunk of the feature row
  const int64_t s0 = static_cast<int64_t>(split) * split_len;
  const int64_t s1 = min(npad, s0 + split_len);
  const bool aligned = ((nb_bytes & 3) == 0) &&
                       ((reinterpret_cast<uintptr_t>(packed) & 3) == 0);
  const uint8_t* rows[kWarpVariants];
  uint32_t swap[kWarpVariants];  // all ones: swap codes 0 and 2
#pragma unroll
  for (int w = 0; w < kWarpVariants; ++w) {
    const int v = min(vbase + w, vb - 1);
    rows[w] = packed + static_cast<int64_t>(v) * nb_bytes;
    swap[w] = (a1_ref != nullptr && a1_ref[v]) ? 0xffffffffu : 0u;
  }
  float acc[3][kWarpVariants][EPL];
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int w = 0; w < kWarpVariants; ++w)
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[p][w][e] = 0.f;

  for (int64_t t0 = s0; t0 < s1; t0 += kLinTile) {
    const int tn = static_cast<int>(min(static_cast<int64_t>(kLinTile), s1 - t0));
    __syncthreads();
    for (int i = threadIdx.x; i < kLinTile * NFP; i += kWarps * 32) {
      const int r = i / NFP, e = i - r * NFP;
      sfeat[i] = (r < tn && f0 + e < nf) ? feat[(t0 + r) * nf + f0 + e] : 0.f;
    }
    __syncthreads();
    // Tiles and splits start on multiples of 16 samples, so a 16-sample
    // word never straddles two of them; its samples past the row's end
    // decode as hom-REF (code 0, or 2 when swapped) and add nothing, as
    // their feature rows are zero.
    for (int j0 = 0; j0 < tn; j0 += 16) {
      uint32_t codes[kWarpVariants];
#pragma unroll
      for (int w = 0; w < kWarpVariants; ++w) {
        const uint32_t c = load_codes16(rows[w], nb_bytes, t0 + j0, aligned);
        // flip the high bit of every 2-bit code whose low bit is 0: 0 <-> 2
        codes[w] = c ^ ((~c & 0x55555555u) << 1 & swap[w]);
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        float f[EPL];
#pragma unroll
        for (int e = 0; e < EPL; ++e) f[e] = sfeat[(j0 + k) * NFP + e * 32 + lane];
#pragma unroll
        for (int w = 0; w < kWarpVariants; ++w) {
          const uint32_t code = (codes[w] >> (2 * k)) & 3u;
          if (code == 1u) {
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[0][w][e] += f[e];
          } else if (code == 2u) {
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[1][w][e] += f[e];
          } else if (code == 3u) {
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[2][w][e] += f[e];
          }
        }
      }
    }
  }
  // part [splits][3][vb][nf]: neighbouring lanes on neighbouring entries
#pragma unroll
  for (int w = 0; w < kWarpVariants; ++w) {
    const int v = vbase + w;
    if (v >= vb) continue;
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int ent = f0 + e * 32 + lane;
        if (ent < nf)
          part[((static_cast<int64_t>(split) * 3 + p) * vb + v) * nf + ent] =
              acc[p][w][e];
      }
  }
}

// out [3][vb][W], W = dc*dc + dc + 1: per plane the full symmetric c c^T,
// then c y, then y^2.  One thread per (plane, variant, entry); splits are
// added in f64 in index order.
__global__ void linear_reduce_kernel(const float* __restrict__ part, int splits,
                                     int vb, int nf, int dc,
                                     double* __restrict__ out) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t per_split = 3LL * vb * nf;
  if (idx >= per_split) return;
  double s = 0.0;
  for (int sp = 0; sp < splits; ++sp) s += part[sp * per_split + idx];
  const int e = static_cast<int>(idx % nf);
  const int64_t pv = idx / nf;  // p * vb + v
  const int ntri = dc * (dc + 1) / 2;
  double* o = out + pv * (dc * dc + dc + 1);
  if (e < ntri) {
    int j = 0, r = e;
    while (r >= dc - j) {
      r -= dc - j;
      ++j;
    }
    const int k = j + r;
    o[j * dc + k] = s;
    o[k * dc + j] = s;
  } else {
    o[dc * dc + (e - ntri)] = s;
  }
}

template <int EPL>
cudaError_t launch_linear(const uint8_t* packed, int64_t nb_bytes, int vb,
                          const uint8_t* a1_ref, const float* feat, int nf,
                          int dc, int64_t npad,
                          int64_t split_len, int splits, float* part,
                          double* out, cudaStream_t stream) {
  const dim3 grid((vb + kBlockVariants - 1) / kBlockVariants, splits,
                  (nf + 32 * EPL - 1) / (32 * EPL));
  linear_sums_kernel<EPL><<<grid, kWarps * 32, 0, stream>>>(
      packed, nb_bytes, vb, a1_ref, feat, nf, npad, split_len, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = 3LL * vb * nf;
  const int threads = 256;
  linear_reduce_kernel<<<static_cast<unsigned>((total + threads - 1) / threads),
                         threads, 0, stream>>>(part, splits, vb, nf, dc, out);
  return cudaGetLastError();
}

}  // namespace

// packed [vb, nb_bytes] u8; a1_ref [vb] u8 (1: swap the variant's hom-REF
// and hom-ALT codes) or null; feat [npad, nf] f32 with npad = 4 * nb_bytes
// and nf = dc(dc+1)/2 + dc + 1 (rows: c_j c_k for j <= k, c_j y, y^2; zero
// for padding samples); part [splits, 3, vb, nf] f32 scratch; out
// [3, vb, dc*dc + dc + 1] f64 (planes het, hom-A1, missing).
PT_EXPORT int pt_linear_sums(const void* packed, long long nb_bytes, int vb,
                             const void* a1_ref, const void* feat, int dc,
                             long long split_len,
                             int splits, void* part, void* out, void* stream) {
  const int nf = dc * (dc + 1) / 2 + dc + 1;
  const int64_t npad = 4 * static_cast<int64_t>(nb_bytes);
  if (vb == 0) return cudaSuccess;
#define PT_CASE(E)                                                           \
  case E:                                                                    \
    return launch_linear<E>(static_cast<const uint8_t*>(packed), nb_bytes,   \
                            vb, static_cast<const uint8_t*>(a1_ref),         \
                            static_cast<const float*>(feat), nf, dc,         \
                            npad, split_len, splits,                         \
                            static_cast<float*>(part),                       \
                            static_cast<double*>(out),                       \
                            static_cast<cudaStream_t>(stream));
  switch (min((nf + 31) / 32, 5)) {  // wider rows: chunks of 5 x 32
    PT_CASE(1)
    PT_CASE(2)
    PT_CASE(3)
    PT_CASE(4)
    PT_CASE(5)
    default:
      return cudaErrorInvalidValue;
  }
#undef PT_CASE
}
