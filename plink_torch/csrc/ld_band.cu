// The LD band kernels of one subcontig: K11 ld_band_bits (the
// --indep-pairwise r^2 decisions) and K12 ld_band_stats (the six pair
// statistics of the band, for --r2/--r tables).  K13 ld_gram_pair, the RAV
// plane Gram of two variant chunks, is in ld_gram.cu.
//
// K11 replaces (plink_tpu/ops/ld.py) `_ld_band_bits_scan` (:127): for every
// variant i and offset d in 1..w with i + d < n, over the masked samples,
//   dot = RR - RA - AR + AA,  nm = VV,
//   s_i = RV - AV, q_i = RV + AV,  s_j = VR - VA, q_j = VR + VA
// (R = hom-REF, A = hom-ALT, V = valid planes; j = i + d), then the f64
// decision in plink_tpu's order (:159-165):
//   cov = dot nm - s_i s_j,  var1 = q_i nm - s_i^2,  var2 = q_j nm - s_j^2,
//   exceeds = cov * cov > (r2t * var1) * var2   (strict >)
// with __dmul_rn / __dsub_rn so nvcc cannot contract them into FMAs: the
// products pass 2^53 at n = 10,000 and the rounding order decides ties.
// Also the d = 0 diagonal: nm1 = VV, homref1 = RV, homalt1 = AV (:166-168).
// K12 replaces `_ld_band_scan` (:73): the same band, d = 0 included, written
// out as the six exact int32 statistics [6][n][w + 1] in the order dot, nm,
// sum_i, ssq_i, sum_j, ssq_j (0 where i + d >= n), with the same diagonal
// counts; the f64 arithmetic stays on the host.
// Counts are exact int32.
//
// plink_tpu forms two [3c, 3c] plane Grams per chunk, most of them outside
// the band; K11/K12 count the band directly from global variant indices.
// Design (plink2's own, plink2_ld.cc:194-414): a first pass packs each
// variant's samples into 32-sample bit words of R, A and V (sample-masked),
// laid out [plane][word][variant]; the band kernel takes a 64 (i) x 64 (d)
// tile a block, 4 x 4 pairs a thread, stages 8 words of the tile's 64 rows
// and 128 columns (j = i + d) in shared memory, and counts each pair with
// AND + popcount: dot as two popcounts of (R&R | A&A) and (R&A | A&R), then
// VV, RV, AV, VR, VA: seven popcounts per pair and 32 samples.
// Bound: operations.  The six plane products on int8 tensor cores, 6 * 2 *
// n * w * samples (7.9e11 at 32,768 x 200 x 10,000: 0.40 ms at 1,979
// TOPS); bytes (82 MB packed in; 6.6 MB of bits out for K11, 158 MB of
// int32 statistics for K12) 0.03-0.07 ms.  The popcount unit (16 a clock
// per SM) sets this design's pace.
#include "common.cuh"

namespace {

constexpr int kRows = 64;             // variants i a block
constexpr int kDs = 64;               // offsets d a block
constexpr int kCols = kRows + kDs;    // column variants j = i + d a block
constexpr int kW = 8;                 // 32-sample words a shared stage
constexpr int kThreads = 256;         // 16 x 16 threads, 4 x 4 pairs each

// Sample-mask bits: word w, bit q = smask[32 w + q] != 0.
__global__ void ld_smask_kernel(const int8_t* __restrict__ smask, int64_t npad,
                                int64_t nwords, uint32_t* __restrict__ mbits) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (w >= nwords) return;
  uint32_t m = 0;
  for (int q = 0; q < 32; ++q) {
    const int64_t s = w * 32 + q;
    if (s < npad && smask[s] != 0) m |= 1u << q;
  }
  mbits[w] = m;
}

// Bits 0, 2, .., 62 of x -> bits 0..31.
__device__ __forceinline__ uint32_t even_bits(uint64_t x) {
  x &= 0x5555555555555555ull;
  x = (x | (x >> 1)) & 0x3333333333333333ull;
  x = (x | (x >> 2)) & 0x0F0F0F0F0F0F0F0Full;
  x = (x | (x >> 4)) & 0x00FF00FF00FF00FFull;
  x = (x | (x >> 8)) & 0x0000FFFF0000FFFFull;
  x = (x | (x >> 16)) & 0x00000000FFFFFFFFull;
  return static_cast<uint32_t>(x);
}

// planes [3][nwords][n]: one thread per (variant, word), neighbouring
// threads on neighbouring variants so the writes coalesce.
__global__ void ld_planes_kernel(const uint8_t* __restrict__ packed, int64_t nb_bytes,
                                 int64_t n, int64_t nwords,
                                 const uint32_t* __restrict__ mbits,
                                 uint32_t* __restrict__ planes) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n * nwords) return;
  const int64_t v = idx % n, w = idx / n;
  const uint8_t* row = packed + v * nb_bytes;
  const int64_t b0 = w * 8;  // 32 samples = 8 bytes
  uint64_t x = 0;
  const bool aligned = ((nb_bytes & 3) == 0) &&
                       ((reinterpret_cast<uintptr_t>(packed) & 3) == 0);
  if (aligned && b0 + 8 <= nb_bytes) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(row + b0);
    x = static_cast<uint64_t>(p[0]) | (static_cast<uint64_t>(p[1]) << 32);
  } else {
    for (int i = 0; i < 8; ++i)
      if (b0 + i < nb_bytes) x |= static_cast<uint64_t>(row[b0 + i]) << (8 * i);
  }
  const uint64_t lo = x & 0x5555555555555555ull;
  const uint64_t hi = (x >> 1) & 0x5555555555555555ull;
  const uint32_t m = mbits[w];
  const uint32_t r = even_bits(~(lo | hi)) & m;     // code 0: hom-REF
  const uint32_t a = even_bits(hi & ~lo) & m;       // code 2: hom-ALT
  const uint32_t valid = ~even_bits(lo & hi) & m;   // not code 3
  planes[(0 * nwords + w) * n + v] = r;
  planes[(1 * nwords + w) * n + v] = a;
  planes[(2 * nwords + w) * n + v] = valid;
}

// kStats false: K11's decision bits into `exceeds` [n][w + 1]; true: K12's
// six statistics into `stats` [6][n][w + 1].
template <bool kStats>
__global__ void __launch_bounds__(kThreads)
ld_band_kernel(const uint32_t* __restrict__ planes, int64_t n, int64_t nwords,
               int width, double r2t, uint8_t* __restrict__ exceeds,
               int* __restrict__ stats, int* __restrict__ nm1,
               int* __restrict__ homref1, int* __restrict__ homalt1) {
  __shared__ __align__(16) uint32_t rs[3][kW][kRows];
  __shared__ __align__(16) uint32_t cs[3][kW][kCols];
  const int t = threadIdx.x;
  const int tx = t & 15, ty = t >> 4;  // d = d0 + 4 tx + b, i = i0 + 4 ty + a
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int d0 = blockIdx.y * kDs;
  const int64_t j0 = i0 + d0;
  int dot[4][4], nm[4][4], rv[4][4], av[4][4], vr[4][4], va[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      dot[a][b] = nm[a][b] = rv[a][b] = av[a][b] = vr[a][b] = va[a][b] = 0;

  for (int64_t w0 = 0; w0 < nwords; w0 += kW) {
    __syncthreads();
    for (int e = t; e < 3 * kW * kRows; e += kThreads) {
      const int c = e % kRows, ww = (e / kRows) % kW, p = e / (kRows * kW);
      const int64_t i = i0 + c, w = w0 + ww;
      rs[p][ww][c] = (i < n && w < nwords) ? planes[(p * nwords + w) * n + i] : 0u;
    }
    for (int e = t; e < 3 * kW * kCols; e += kThreads) {
      const int c = e % kCols, ww = (e / kCols) % kW, p = e / (kCols * kW);
      const int64_t j = j0 + c, w = w0 + ww;
      cs[p][ww][c] = (j < n && w < nwords) ? planes[(p * nwords + w) * n + j] : 0u;
    }
    __syncthreads();
#pragma unroll 2
    for (int ww = 0; ww < kW; ++ww) {
      const uint4 r4 = *reinterpret_cast<const uint4*>(&rs[0][ww][4 * ty]);
      const uint4 a4 = *reinterpret_cast<const uint4*>(&rs[1][ww][4 * ty]);
      const uint4 v4 = *reinterpret_cast<const uint4*>(&rs[2][ww][4 * ty]);
      const uint32_t Ri[4] = {r4.x, r4.y, r4.z, r4.w};
      const uint32_t Ai[4] = {a4.x, a4.y, a4.z, a4.w};
      const uint32_t Vi[4] = {v4.x, v4.y, v4.z, v4.w};
      // the 7 column words j = 4 (ty + tx) + 0..6 this thread's pairs use
      const int cbase = 4 * (ty + tx);
      uint32_t Rj[8], Aj[8], Vj[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 r = *reinterpret_cast<const uint4*>(&cs[0][ww][cbase + 4 * h]);
        const uint4 a = *reinterpret_cast<const uint4*>(&cs[1][ww][cbase + 4 * h]);
        const uint4 v = *reinterpret_cast<const uint4*>(&cs[2][ww][cbase + 4 * h]);
        Rj[4 * h] = r.x; Rj[4 * h + 1] = r.y; Rj[4 * h + 2] = r.z; Rj[4 * h + 3] = r.w;
        Aj[4 * h] = a.x; Aj[4 * h + 1] = a.y; Aj[4 * h + 2] = a.z; Aj[4 * h + 3] = a.w;
        Vj[4 * h] = v.x; Vj[4 * h + 1] = v.y; Vj[4 * h + 2] = v.z; Vj[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int c = a + b;
          dot[a][b] += __popc((Ri[a] & Rj[c]) | (Ai[a] & Aj[c])) -
                       __popc((Ri[a] & Aj[c]) | (Ai[a] & Rj[c]));
          nm[a][b] += __popc(Vi[a] & Vj[c]);
          rv[a][b] += __popc(Ri[a] & Vj[c]);
          av[a][b] += __popc(Ai[a] & Vj[c]);
          vr[a][b] += __popc(Vi[a] & Rj[c]);
          va[a][b] += __popc(Vi[a] & Aj[c]);
        }
    }
  }

  const int64_t stride = static_cast<int64_t>(width) + 1;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int64_t i = i0 + 4 * ty + a;
    if (i >= n) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int d = d0 + 4 * tx + b;
      if (d > width) continue;
      if (d == 0) {
        nm1[i] = nm[a][b];
        homref1[i] = rv[a][b];
        homalt1[i] = av[a][b];
      }
      if constexpr (kStats) {
        const int64_t plane = n * stride;
        int* o = stats + i * stride + d;
        const bool in = i + d < n;  // columns past the subcontig counted 0
        o[0] = in ? dot[a][b] : 0;
        o[plane] = in ? nm[a][b] : 0;
        o[2 * plane] = in ? rv[a][b] - av[a][b] : 0;
        o[3 * plane] = in ? rv[a][b] + av[a][b] : 0;
        o[4 * plane] = in ? vr[a][b] - va[a][b] : 0;
        o[5 * plane] = in ? vr[a][b] + va[a][b] : 0;
        continue;
      }
      uint8_t ex = 0;
      if (d >= 1 && i + d < n) {
        const double vv = static_cast<double>(nm[a][b]);
        const double dt = static_cast<double>(dot[a][b]);
        const double s_i = static_cast<double>(rv[a][b] - av[a][b]);
        const double q_i = static_cast<double>(rv[a][b] + av[a][b]);
        const double s_j = static_cast<double>(vr[a][b] - va[a][b]);
        const double q_j = static_cast<double>(vr[a][b] + va[a][b]);
        const double cov = __dsub_rn(__dmul_rn(dt, vv), __dmul_rn(s_i, s_j));
        const double var1 = __dsub_rn(__dmul_rn(q_i, vv), __dmul_rn(s_i, s_i));
        const double var2 = __dsub_rn(__dmul_rn(q_j, vv), __dmul_rn(s_j, s_j));
        ex = __dmul_rn(cov, cov) > __dmul_rn(__dmul_rn(r2t, var1), var2) ? 1 : 0;
      }
      exceeds[i * stride + d] = ex;
    }
  }
}

// The sample-mask bits and the R/A/V bit planes [3][nwords][n] of n packed
// rows (the first two passes of both entry points).
cudaError_t pack_planes(const void* packed, long long nb_bytes, long long n,
                        const void* smask, long long npad, void* mbits, void* planes,
                        cudaStream_t st) {
  const int64_t nwords = (npad + 31) / 32;
  ld_smask_kernel<<<static_cast<unsigned>((nwords + 255) / 256), 256, 0, st>>>(
      static_cast<const int8_t*>(smask), npad, nwords, static_cast<uint32_t*>(mbits));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = n * nwords;
  if (total == 0) return cudaSuccess;
  ld_planes_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
      static_cast<const uint8_t*>(packed), nb_bytes, n, nwords,
      static_cast<const uint32_t*>(mbits), static_cast<uint32_t*>(planes));
  return cudaGetLastError();
}

template <bool kStats>
cudaError_t launch_band(const void* packed, long long nb_bytes, long long n,
                        const void* smask, long long npad, int width, double r2t,
                        void* mbits, void* planes, void* exceeds, void* stats,
                        void* nm1, void* homref1, void* homalt1, cudaStream_t st) {
  if (n <= 0) return cudaSuccess;
  if (npad != 4 * nb_bytes || width < 0) return cudaErrorInvalidValue;
  const cudaError_t err = pack_planes(packed, nb_bytes, n, smask, npad, mbits,
                                      planes, st);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((n + kRows - 1) / kRows), (width + kDs) / kDs);
  ld_band_kernel<kStats><<<grid, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(planes), n, (npad + 31) / 32, width, r2t,
      static_cast<uint8_t*>(exceeds), static_cast<int*>(stats),
      static_cast<int*>(nm1), static_cast<int*>(homref1), static_cast<int*>(homalt1));
  return cudaGetLastError();
}

}  // namespace

// packed [n, nb_bytes] u8 (the subcontig's rows, npad = 4 * nb_bytes
// samples), smask [npad] i8 -> exceeds [n, width + 1] u8 and nm1 / homref1
// / homalt1 [n] i32.  Scratch: mbits u32 [ceil(npad / 32)], planes u32
// [3 * ceil(npad / 32) * n].
PT_EXPORT int pt_ld_band_bits(const void* packed, long long nb_bytes, long long n,
                              const void* smask, long long npad, int width,
                              double r2t, void* mbits, void* planes, void* exceeds,
                              void* nm1, void* homref1, void* homalt1, void* stream) {
  return launch_band<false>(packed, nb_bytes, n, smask, npad, width, r2t, mbits,
                            planes, exceeds, nullptr, nm1, homref1, homalt1,
                            static_cast<cudaStream_t>(stream));
}

// K12: as pt_ld_band_bits, but stats [6, n, width + 1] i32 (dot, nm, sum_i,
// ssq_i, sum_j, ssq_j) in place of the decision bits.
PT_EXPORT int pt_ld_band_stats(const void* packed, long long nb_bytes, long long n,
                               const void* smask, long long npad, int width,
                               void* mbits, void* planes, void* stats, void* nm1,
                               void* homref1, void* homalt1, void* stream) {
  return launch_band<true>(packed, nb_bytes, n, smask, npad, width, 0.0, mbits,
                           planes, nullptr, stats, nm1, homref1, homalt1,
                           static_cast<cudaStream_t>(stream));
}
