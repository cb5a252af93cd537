// K19 linear_perm_xty and K20 linear_perm_stat: the permuted linear scan of
// --glm mperm= / aperm on quantitative phenotypes.
//
// Replaces (plink_tpu/ops/glm.py) `_linear_perm_body` (:1031) and
// `_linear_perm_multi_body` (:1137), as `linear_perm_scan` (:1092) and
// `linear_perm_multi_scan` (:1208) run them per variant block: the design
// [c | G_1..G_P] of a variant is fixed across permutations, so X^T X and its
// inverse (K2 / K15, then K4) are formed once per block, while X^T y_b and
// y_b^T y_b of every permuted phenotype column y_b of Y [npad, B] are plane
// contractions with the permutation axis as the batch axis.
//
// K19 computes, per variant v and permutation b,
//   xty[v, j, b]      = sum_s valid(v,s) c_j(s) Y(s,b)          (j < dc)
//   xty[v, dc + p, b] = sum_s G_p(v,s) Y(s,b)                   (p < P)
//   yy[v, b]          = sum_s valid(v,s) Y(s,b)^2
// with valid the non-missing plane times the sample mask and G_p = (wH het +
// wA homalt + wV valid) * c[:, covj_p] (when covj_p >= 0) * sscale, as
// `_plane_cols` forms them.  Every row of that left operand is the variant's
// code-indexed weight times a per-sample factor: row r = (w[code] for code
// 0..3) * F_r(s), with w = (1, 1, 1, 0) and F = c_j mask for a covariate row,
// w = (wV, wH + wV, wA + wV, 0) and F = c_covj sscale mask for a genotype
// row, and w = (1, 1, 1, 0), F = mask against Y^2 for the yy row.  The
// weights are small integers (0, +-1, +-2), so w * F equals plink_tpu's
// ((w mask) c) s exactly.
//
// Bound: operations.  2 * vb * npad * (dc + P + 1) * B FP32 flops (3.8e12
// for 2,048 variants x 500,000 samples x 14 rows x 134 permutations, ~57 ms
// at 67 TFLOP/s; plain FP32 FMAs, as plink_tpu contracts at HIGHEST) against
// 256 MB of packed codes and 268 MB of Y.  Design: a CTA of 128 threads
// takes 32 variants x 64 permutations x one chunk of 4 design rows (grid:
// variant tile, permutation tile x row chunk) and streams every sample.  Per
// 128-sample tile it stages Y [128 x 64], the chunk's factors F [128 x 4]
// and the 32 variants' code words in shared memory; a thread holds one
// variant x 16 permutations x 4 rows of f32 accumulators, so each Y value it
// reads serves 4 FMAs and each decoded code 64.  c (*) Y is never formed.
// The f32 accumulators hold at most one 2,048-sample split; at each split's
// end they are added into the thread's f64 accumulators (in shared memory),
// so splits add in f64 in index order: no float atomics, and two runs give
// identical bytes.
//
// K20 runs one thread per (variant, permutation): beta = inv xty, rss = yy -
// beta . xty, sigma^2 = rss / max(nm - d, 1), and either t = beta_tc /
// sqrt(max(sigma^2 inv_tc,tc, 0)) (q = 0) or the joint F = ((rss0 - rss) /
// q) / max(sigma^2, 1e-30) from the reduced design's inverse inv0 over the
// rows [0, dc) and [dc + q, d) (q > 0).  It takes the f32 inputs in f64 and
// rounds the statistic to f32: rss and rss0 are differences of sums of
// size yy, so plink_tpu's f32 arithmetic there (which the plain version
// keeps) leaves an absolute rounding of ~n eps / q in F; here only the
// inputs' own rounding is left.  A NaN inverse (a singular design) gives
// NaN, as there.
#include "common.cuh"

namespace {

constexpr int kVT = 32;        // variants per CTA
constexpr int kBT = 64;        // permutations per CTA
constexpr int kKC = 4;         // design rows per CTA (a chunk)
constexpr int kTB = 16;        // permutations per thread
constexpr int kST = 128;       // samples per shared-memory tile
constexpr int kThreads = 128;  // 4 warps: 8 variants x 4 permutation quads
constexpr int kWords = kST / 16;
constexpr size_t kSmemBytes = sizeof(float) * kST * kBT + sizeof(float) * kST * kKC +
                              sizeof(uint32_t) * kVT * kWords +
                              sizeof(double) * kKC * kTB * kThreads;

__global__ void __launch_bounds__(kThreads, 2)
linear_perm_xty_kernel(const uint8_t* __restrict__ packed, int64_t nb, int vb,
                       const float* __restrict__ gw, int P,
                       const float* __restrict__ c, int dc,
                       const float* __restrict__ Y, int B,
                       const float* __restrict__ mask,
                       const int* __restrict__ covj,
                       const float* __restrict__ sscale, int64_t split_len,
                       float* __restrict__ xty, float* __restrict__ yy) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sY = reinterpret_cast<float*>(smem);      // [kST][kBT]
  float* sF = sY + kST * kBT;                       // [kST][kKC]
  uint32_t* sCode = reinterpret_cast<uint32_t*>(sF + kST * kKC);  // [kVT][kWords]
  double* sAcc = reinterpret_cast<double*>(sCode + kVT * kWords);
  // sAcc[(r * kTB + i) * kThreads + tid]: the thread's f64 sums

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int vloc = (tid >> 5) * 8 + (lane >> 2);
  const int pq = lane & 3;  // permutations 16 i + 4 pq + {0..3}
  const int v = blockIdx.x * kVT + vloc;
  const int vv = min(v, vb - 1);
  const int n_bt = (B + kBT - 1) / kBT;
  const int b0 = (blockIdx.y % n_bt) * kBT;
  const int r0 = (blockIdx.y / n_bt) * kKC;
  const int n_lin = dc + P;  // rows against Y; row n_lin is yy (against Y^2)
  const int64_t npad = 4 * nb;
  const bool aligned = ((nb & 3) == 0) &&
                       ((reinterpret_cast<uintptr_t>(packed) & 3) == 0);

  // per row of the chunk: the variant's weight of each code
  float wc[kKC][4];
#pragma unroll
  for (int r = 0; r < kKC; ++r) {
    const int rr = r0 + r;
    if (rr < dc || rr == n_lin) {
      wc[r][0] = wc[r][1] = wc[r][2] = 1.f;
    } else if (rr < n_lin) {
      const float* w = gw + (static_cast<int64_t>(vv) * P + (rr - dc)) * 3;
      wc[r][0] = w[2];
      wc[r][1] = w[0] + w[2];
      wc[r][2] = w[1] + w[2];
    } else {
      wc[r][0] = wc[r][1] = wc[r][2] = 0.f;
    }
    wc[r][3] = 0.f;
  }
  const int yyr = n_lin - r0;  // the yy row's place in the chunk (if 0..3)

#pragma unroll
  for (int e = 0; e < kKC * kTB; ++e) sAcc[e * kThreads + tid] = 0.0;
  float acc[kKC][kTB];
#pragma unroll
  for (int r = 0; r < kKC; ++r)
#pragma unroll
    for (int i = 0; i < kTB; ++i) acc[r][i] = 0.f;

  for (int64_t t0 = 0; t0 < npad; t0 += kST) {
    const int tn = static_cast<int>(min(static_cast<int64_t>(kST), npad - t0));
    __syncthreads();
    for (int i = tid; i < kST * kBT; i += kThreads) {
      const int s = i / kBT, b = i - s * kBT;
      sY[i] = (s < tn && b0 + b < B) ? Y[(t0 + s) * B + b0 + b] : 0.f;
    }
    for (int i = tid; i < kST * kKC; i += kThreads) {
      const int s = i / kKC, rr = r0 + (i - s * kKC);
      float f = 0.f;
      if (s < tn) {
        const int64_t g = t0 + s;
        const float m = mask[g];
        if (rr < dc) {
          f = c[g * dc + rr] * m;
        } else if (rr < n_lin) {
          const int j = covj[rr - dc];
          f = j >= 0 ? c[g * dc + j] : 1.f;
          if (sscale != nullptr) f *= sscale[g];
          f *= m;
        } else if (rr == n_lin) {
          f = m;
        }
      }
      sF[i] = f;
    }
    for (int i = tid; i < kVT * kWords; i += kThreads) {
      const int vl = i / kWords, w = i - vl * kWords;
      const int vr = min(blockIdx.x * kVT + vl, vb - 1);
      sCode[i] = 16 * w < tn ? load_codes16(packed + static_cast<int64_t>(vr) * nb,
                                            nb, t0 + 16 * w, aligned)
                             : 0u;
    }
    __syncthreads();
    // samples past the row's end decode as code 0 and add nothing: their
    // factors and Y are zero
    for (int j0 = 0; j0 < tn; j0 += 16) {
      const uint32_t word = sCode[vloc * kWords + j0 / 16];
#pragma unroll 4
      for (int k = 0; k < 16; ++k) {
        const int s = j0 + k;
        const uint32_t code = (word >> (2 * k)) & 3u;
        const float4 f = *reinterpret_cast<const float4*>(sF + s * kKC);
        const float fr[kKC] = {f.x, f.y, f.z, f.w};
        float y[kTB];
#pragma unroll
        for (int i = 0; i < kTB / 4; ++i) {
          const float4 q =
              *reinterpret_cast<const float4*>(sY + s * kBT + 16 * i + 4 * pq);
          y[4 * i] = q.x;
          y[4 * i + 1] = q.y;
          y[4 * i + 2] = q.z;
          y[4 * i + 3] = q.w;
        }
#pragma unroll
        for (int r = 0; r < kKC; ++r) {
          const float w = code == 0u ? wc[r][0]
                          : code == 1u ? wc[r][1]
                          : code == 2u ? wc[r][2] : 0.f;
          const float l = w * fr[r];
          if (r == yyr) {  // l is 0 or 1: (l y) y = valid y^2
#pragma unroll
            for (int i = 0; i < kTB; ++i) acc[r][i] = fmaf(l * y[i], y[i], acc[r][i]);
          } else {
#pragma unroll
            for (int i = 0; i < kTB; ++i) acc[r][i] = fmaf(l, y[i], acc[r][i]);
          }
        }
      }
    }
    // a split ends: its f32 sums join the f64 sums, in split order
    if ((t0 + kST) % split_len == 0 || t0 + kST >= npad) {
#pragma unroll
      for (int r = 0; r < kKC; ++r)
#pragma unroll
        for (int i = 0; i < kTB; ++i) {
          sAcc[(r * kTB + i) * kThreads + tid] += static_cast<double>(acc[r][i]);
          acc[r][i] = 0.f;
        }
    }
  }
  if (v >= vb) return;
#pragma unroll
  for (int r = 0; r < kKC; ++r) {
    const int rr = r0 + r;
    if (rr > n_lin) break;
#pragma unroll
    for (int i = 0; i < kTB; ++i) {
      const int b = b0 + 16 * (i / 4) + 4 * pq + (i % 4);
      if (b >= B) continue;
      const float s = static_cast<float>(sAcc[(r * kTB + i) * kThreads + tid]);
      if (rr < n_lin)
        xty[(static_cast<int64_t>(v) * n_lin + rr) * B + b] = s;
      else
        yy[static_cast<int64_t>(v) * B + b] = s;
    }
  }
}

// NaN-propagating max(x, lo) (fmax would drop a NaN x)
__device__ __forceinline__ double max_keep_nan(double x, double lo) {
  return x < lo ? lo : x;
}

__global__ void linear_perm_stat_kernel(const float* __restrict__ inv,
                                        const float* __restrict__ xty,
                                        const float* __restrict__ yy,
                                        const float* __restrict__ nm,
                                        const float* __restrict__ inv0,
                                        int d, int tc, int q, int B,
                                        float* __restrict__ out) {
  const int v = blockIdx.x;
  const int b = blockIdx.y * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* iv = inv + static_cast<int64_t>(v) * d * d;
  const float* xv = xty + static_cast<int64_t>(v) * d * B + b;
  double bx = 0.0, beta_t = 0.0;
  for (int i = 0; i < d; ++i) {
    double s = 0.0;
    for (int j = 0; j < d; ++j)
      s = fma(static_cast<double>(__ldg(iv + i * d + j)),
              static_cast<double>(xv[j * B]), s);
    if (i == tc) beta_t = s;
    bx = fma(s, static_cast<double>(xv[i * B]), bx);
  }
  const double yyv = yy[static_cast<int64_t>(v) * B + b];
  const double rss = yyv - bx;
  const double dof = fmax(static_cast<double>(nm[v]) - d, 1.0);
  const double sigma2 = rss / dof;
  double stat;
  if (q == 0) {
    const double se2 = sigma2 * __ldg(iv + tc * d + tc);
    stat = beta_t / sqrt(max_keep_nan(se2, 0.0));
  } else {
    const int d0 = d - q;
    const float* i0 = inv0 + static_cast<int64_t>(v) * d0 * d0;
    double bx0 = 0.0;
    for (int i = 0; i < d0; ++i) {
      double s = 0.0;
      for (int j = 0; j < d0; ++j)
        s = fma(static_cast<double>(__ldg(i0 + i * d0 + j)),
                static_cast<double>(xv[(j < tc ? j : j + q) * B]), s);
      bx0 = fma(s, static_cast<double>(xv[(i < tc ? i : i + q) * B]), bx0);
    }
    const double rss0 = yyv - bx0;
    stat = ((rss0 - rss) / q) / max_keep_nan(sigma2, 1e-30);
  }
  out[static_cast<int64_t>(v) * B + b] = static_cast<float>(stat);
}

}  // namespace

// packed [vb, nb] u8; gw [vb, P, 3] f32; c [4 nb, dc] f32; Y [4 nb, B] f32;
// mask [4 nb] f32; covj [P] i32 (the c column multiplying G_p, or -1);
// sscale [4 nb] f32 or null; split_len: samples per f32 split (a multiple
// of 128); xty [vb, dc + P, B] f32; yy [vb, B] f32.
PT_EXPORT int pt_linear_perm_xty(const void* packed, long long nb, int vb,
                                 const void* gw, int P, const void* c, int dc,
                                 const void* Y, int B, const void* mask,
                                 const void* covj, const void* sscale,
                                 long long split_len, void* xty, void* yy,
                                 void* stream) {
  if (vb == 0 || B == 0) return cudaSuccess;
  if (split_len <= 0 || split_len % kST != 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      linear_perm_xty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const int rows = dc + P + 1;
  const dim3 grid((vb + kVT - 1) / kVT,
                  ((B + kBT - 1) / kBT) * ((rows + kKC - 1) / kKC));
  linear_perm_xty_kernel<<<grid, kThreads, kSmemBytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), nb, vb, static_cast<const float*>(gw),
      P, static_cast<const float*>(c), dc, static_cast<const float*>(Y), B,
      static_cast<const float*>(mask), static_cast<const int*>(covj),
      static_cast<const float*>(sscale), split_len, static_cast<float*>(xty),
      static_cast<float*>(yy));
  return cudaGetLastError();
}

// inv [vb, d, d] f32; xty [vb, d, B] f32; yy [vb, B] f32; nm [vb] f32;
// inv0 [vb, d - q, d - q] f32 (q > 0) or null; tc: the t-statistic's column
// (q = 0) or the first constrained column (q > 0); out [vb, B] f32.
PT_EXPORT int pt_linear_perm_stat(const void* inv, const void* xty,
                                  const void* yy, const void* nm,
                                  const void* inv0, int vb, int d, int tc,
                                  int q, int B, void* out, void* stream) {
  if (vb == 0 || B == 0) return cudaSuccess;
  if (q > 0 && inv0 == nullptr) return cudaErrorInvalidValue;
  const int threads = 128;
  const dim3 grid(vb, (B + threads - 1) / threads);
  linear_perm_stat_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(inv), static_cast<const float*>(xty),
      static_cast<const float*>(yy), static_cast<const float*>(nm),
      static_cast<const float*>(inv0), d, tc, q, B, static_cast<float*>(out));
  return cudaGetLastError();
}
