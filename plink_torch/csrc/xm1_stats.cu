// K14 xm1_stats: the --xchr-model 1 allele-observation statistics of the
// logistic --glm, one pass over the packed genotypes.
//
// Replaces (plink_tpu/ops/glm.py) `xm1_stats_scan` (:895): per variant v,
// over the samples valid for v (call not missing, inside the mask),
//   sum_s w0(s), sum_s w1(s), het count, hom-ALT count,
// with w = [s, s*y] (s = 0.5 for males, y the case indicator): 2 * sum w0
// is the allele observation count, 2 * sum w1 the case allele count, and
// the counts feed plink2's raw-genocount const-allele rule.
//
// Bound: bytes.  Every packed byte is read once (the 500,000 x 4,096 panel
// is 512 MB, 0.155 ms at 3.35 TB/s); the work per 32-bit word (16 samples)
// is two popcounts and, per missing call (2% of them on a biobank panel),
// one subtraction.  Design: a block takes 64 variants x one split of 4,096
// samples (256 words); it copies the split's mask-weighted w (laid out
// [2][16][256] by the wrapper, so the copy and the reads are conflict-free)
// and mask bits into shared memory once and sums w over each word's 16
// samples.  Each warp then walks 8 variant rows; a lane takes every 32nd
// word, adds the word's w sum, subtracts w of the word's missing calls
// (their bits, ANDed with the mask, found with __ffs), and counts het /
// hom-ALT with popcounts as K1 does.  Lane sums are added by a fixed-order
// shuffle tree, the (variant, split) partials land in [split][stat][v], and
// a second kernel adds the splits in f64 in split order: no atomics, and the
// sums of w values in {0, 0.5, 1} are exact (multiples of 0.5 far below
// 2^23), so the result equals the plain version's float32 product exactly.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;       // 8 warps
constexpr int kSplitWords = 256;    // 32-bit words (16 samples each) per split
constexpr int kVarsPerBlock = 64;   // 8 rows per warp

__global__ void __launch_bounds__(kThreads)
xm1_stats_kernel(const uint8_t* __restrict__ packed, int64_t nb_bytes, int nvar,
                 int64_t nwords, const uint32_t* __restrict__ mask2,
                 const float* __restrict__ wt, float* __restrict__ part) {
  __shared__ float sw[2][16][kSplitWords];  // w of sample 16 i + k at [.][k][i]
  __shared__ float swsum[2][kSplitWords];   // sum over each word's samples
  __shared__ uint32_t smask[kSplitWords];
  const int tid = threadIdx.x;
  const int split = blockIdx.y;
  const int64_t w0 = static_cast<int64_t>(split) * kSplitWords;
  const int nw = static_cast<int>(min(static_cast<int64_t>(kSplitWords), nwords - w0));

  const float* src = wt + static_cast<int64_t>(split) * 2 * 16 * kSplitWords;
  float* dst = &sw[0][0][0];
  for (int e = tid; e < 2 * 16 * kSplitWords; e += kThreads) dst[e] = src[e];
  for (int i = tid; i < kSplitWords; i += kThreads) smask[i] = mask2[w0 + i];
  __syncthreads();
  for (int i = tid; i < kSplitWords; i += kThreads) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      a += sw[0][k][i];
      b += sw[1][k][i];
    }
    swsum[0][i] = a;
    swsum[1][i] = b;
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool aligned = ((nb_bytes & 3) == 0) &&
                       ((reinterpret_cast<uintptr_t>(packed) & 3) == 0);
  for (int j = 0; j < kVarsPerBlock / (kThreads / 32); ++j) {
    const int v = blockIdx.x * kVarsPerBlock + warp + (kThreads / 32) * j;
    if (v >= nvar) break;  // uniform over the warp
    const uint8_t* row = packed + static_cast<int64_t>(v) * nb_bytes;
    float s0 = 0.f, s1 = 0.f;
    int het = 0, hom = 0;
    for (int i = lane; i < nw; i += 32) {
      const uint32_t x = load_codes16(row, nb_bytes, 16 * (w0 + i), aligned) & smask[i];
      const uint32_t lo = x & 0x55555555u;
      const uint32_t hi = (x >> 1) & 0x55555555u;
      het += __popc(lo & ~hi);
      hom += __popc(hi & ~lo);
      float a = swsum[0][i], b = swsum[1][i];
      for (uint32_t miss = lo & hi; miss; miss &= miss - 1) {
        const int k = (__ffs(miss) - 1) >> 1;
        a -= sw[0][k][i];
        b -= sw[1][k][i];
      }
      s0 += a;
      s1 += b;
    }
    float hf = static_cast<float>(het), af = static_cast<float>(hom);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s0 += __shfl_down_sync(0xffffffffu, s0, off);
      s1 += __shfl_down_sync(0xffffffffu, s1, off);
      hf += __shfl_down_sync(0xffffffffu, hf, off);
      af += __shfl_down_sync(0xffffffffu, af, off);
    }
    if (lane == 0) {
      float* p = part + static_cast<int64_t>(split) * 4 * nvar + v;
      p[0] = s0;
      p[nvar] = s1;
      p[2 * static_cast<int64_t>(nvar)] = hf;
      p[3 * static_cast<int64_t>(nvar)] = af;
    }
  }
}

// out[e][v] = sum over splits of part[split][e][v], in f64, in split order.
__global__ void xm1_reduce_kernel(const float* __restrict__ part, int splits,
                                  int nvar, float* __restrict__ out) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= 4 * static_cast<int64_t>(nvar)) return;
  double s = 0.0;
  for (int sp = 0; sp < splits; ++sp)
    s += part[static_cast<int64_t>(sp) * 4 * nvar + idx];
  out[idx] = static_cast<float>(s);
}

}  // namespace

// packed [nvar, nb_bytes] u8; mask2 [splits * 256] u32 words with 0b11 in the
// 2-bit field of every sample inside the mask (0 past the last sample); wt
// [splits, 2, 16, 256] f32: mask * w of sample 16 (256 split + i) + k at
// [split][c][k][i]; part [splits, 4, nvar] f32 scratch; out [4, nvar] f32 =
// (sum w0, sum w1, het, hom-ALT) over valid samples.
PT_EXPORT int pt_xm1_stats(const void* packed, long long nb_bytes, int nvar,
                           const void* mask2, const void* wt, int splits,
                           void* part, void* out, void* stream) {
  if (nvar == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t nwords = (nb_bytes + 3) / 4;
  if (splits != static_cast<int>((nwords + kSplitWords - 1) / kSplitWords))
    return cudaErrorInvalidValue;
  const dim3 grid((nvar + kVarsPerBlock - 1) / kVarsPerBlock, splits);
  xm1_stats_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(packed), nb_bytes, nvar, nwords,
      static_cast<const uint32_t*>(mask2), static_cast<const float*>(wt),
      static_cast<float*>(part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = 4 * static_cast<int64_t>(nvar);
  xm1_reduce_kernel<<<static_cast<int>((total + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part), splits, nvar, static_cast<float*>(out));
  return cudaGetLastError();
}
