// K9 pca_x and K10 pca_xt: the two streamed products of randomized PCA over
// one variant block of the standardised genotype matrix.
//
// Replace (plink_tpu/ops/pca.py) the block bodies of `xtx_apply` (:37),
// `x_apply` (:64) and `xt_apply` (:82), with `_normed_block` (:22) as the
// decode on the load: Z[v, i] = coef[v, class(code)] * smask[i], 0 for a
// missing call (excluded and padded variants carry coef 0).  Z is never
// written to device memory.
//   K9:  T[v, l]    = sum_i Z[v, i] q[i, l]   (contracts the sample axis)
//   K10: acc[i, l] += sum_v Z[v, i] b[v, l]   (contracts the block's variants)
//
// Numerics follow JAX's HIGHEST contract: full f32 products (no TF32 or
// bf16), at most 2,048 terms per f32 accumulator, the runs added in f64.
// K9 splits the samples into 2,048-sample runs, one block of the grid
// each, writes the f32 run sums to a scratch buffer, and a second kernel
// adds the runs in f64 in index order; K10 keeps each run's f32 sum, adds
// it to an f64 register, and adds that to the f64 accumulator, which the
// caller carries across blocks in block order.  No atomics: two runs give
// identical bytes.
//
// Bound: operations, 2 * vb * n * L FP32 multiply-adds a launch (8.2e9 at
// vb = 2,048, n = 100,000, L = 20: 0.122 ms at 67 TFLOP/s outside the
// tensor cores); the packed block is 51 MB, 0.015 ms at 3.35 TB/s.  Design:
// a shared-memory tiled SGEMM, 128 (variants in K9, samples in K10) x 32 (L)
// outputs a block, 4 x 4 a thread, 32 contraction steps a stage; the packed
// codes are decoded and looked up in coef on the way into shared memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;     // 32 x 8 threads, 4 x 4 outputs each
constexpr int kBM = 128;          // output rows a block
constexpr int kBL = 32;           // output columns (of L) a block
constexpr int kK = 32;            // contraction terms a stage
constexpr int kPad = kBM + 4;     // shared row stride of the Z tile (floats)
constexpr int kLPad = kBL + 4;    // shared row stride of the q / b tile
constexpr int kRun = 2048;        // terms per f32 accumulator

__device__ __forceinline__ float zval(uint32_t code, float c0, float c1, float c2) {
  return code == 0u ? c0 : code == 1u ? c1 : code == 2u ? c2 : 0.f;
}

__device__ __forceinline__ void fma44(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// K9, first pass: grid (variant tiles, L tiles, 2,048-sample runs).  part
// [runs][nvar][L] holds each run's f32 sums.
__global__ void __launch_bounds__(kThreads)
pca_x_kernel(const uint8_t* __restrict__ packed, int64_t nb_bytes, int64_t nvar,
             const float* __restrict__ coef, const float* __restrict__ smask,
             int64_t npad, const float* __restrict__ q, int L,
             float* __restrict__ part) {
  __shared__ __align__(16) float zs[kK][kPad];    // [sample][variant]
  __shared__ __align__(16) float qs[kK][kLPad];   // [sample][l]
  __shared__ float ms[kRun];                      // the run's sample mask
  const int t = threadIdx.x;
  const int tx = t & 7, ty = t >> 3;
  const int64_t vt = static_cast<int64_t>(blockIdx.x) * kBM;
  const int l0 = blockIdx.y * kBL;
  const int64_t s_begin = static_cast<int64_t>(blockIdx.z) * kRun;
  const int64_t s_end = min(s_begin + kRun, npad);
  const bool base_aligned = ((nb_bytes & 3) == 0) &&
                            ((reinterpret_cast<uintptr_t>(packed) & 3) == 0);
  // staging role: variant vl of the tile, samples 16 * half .. + 16 of a stage
  const int vl = t >> 1, half = t & 1;
  const int64_t v = vt + vl;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f;
  if (v < nvar) {
    c0 = coef[v * 3];
    c1 = coef[v * 3 + 1];
    c2 = coef[v * 3 + 2];
  }
  for (int i = t; i < kRun; i += kThreads) {
    const int64_t s = s_begin + i;
    ms[i] = s < s_end ? smask[s] : 0.f;
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = s_begin; k0 < s_end; k0 += kK) {
    __syncthreads();
    {
      const int64_t s0 = k0 + 16 * half;
      uint32_t x = 0;
      if (v < nvar && s0 < s_end)
        x = load_codes16(packed + v * nb_bytes, nb_bytes, s0, base_aligned);
      const int sl = static_cast<int>(k0 - s_begin) + 16 * half;
#pragma unroll
      for (int qq = 0; qq < 16; ++qq)
        zs[16 * half + qq][vl] = zval((x >> (2 * qq)) & 3u, c0, c1, c2) * ms[sl + qq];
    }
    for (int i = t; i < kK * kBL; i += kThreads) {
      const int kk = i / kBL, ll = i % kBL;
      const int64_t s = k0 + kk;
      const int l = l0 + ll;
      qs[kk][ll] = (s < s_end && l < L) ? q[s * L + l] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kK; ++kk)
      fma44(acc, *reinterpret_cast<const float4*>(&zs[kk][ty * 4]),
            *reinterpret_cast<const float4*>(&qs[kk][tx * 4]));
  }

  float* out = part + static_cast<int64_t>(blockIdx.z) * nvar * L;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t vv = vt + ty * 4 + i;
    if (vv >= nvar) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int l = l0 + tx * 4 + j;
      if (l < L) out[vv * L + l] = acc[i][j];
    }
  }
}

// K9, second pass: out[e] = f32(sum over runs of part[run][e]), the runs
// added in f64 in index order.
__global__ void pca_x_reduce_kernel(const float* __restrict__ part, int runs,
                                    int64_t count, float* __restrict__ out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= count) return;
  double s = 0.0;
  for (int r = 0; r < runs; ++r) s += static_cast<double>(part[r * count + e]);
  out[e] = static_cast<float>(s);
}

// K10: grid (sample tiles, L tiles); acc [npad][L] f64 += this block's sums.
__global__ void __launch_bounds__(kThreads)
pca_xt_kernel(const uint8_t* __restrict__ packed, int64_t nb_bytes, int64_t nvar,
              const float* __restrict__ coef, const float* __restrict__ smask,
              int64_t npad, const float* __restrict__ b, int L,
              double* __restrict__ acc_out) {
  __shared__ __align__(16) float zs[kK][kPad];    // [variant][sample]
  __shared__ __align__(16) float bs[kK][kLPad];   // [variant][l]
  __shared__ float ms[kBM];                       // the tile's sample mask
  const int t = threadIdx.x;
  const int tx = t & 7, ty = t >> 3;
  const int64_t it = static_cast<int64_t>(blockIdx.x) * kBM;
  const int l0 = blockIdx.y * kBL;
  const bool base_aligned = ((nb_bytes & 3) == 0) &&
                            ((reinterpret_cast<uintptr_t>(packed) & 3) == 0);
  // staging role: variant vk of a stage, samples 16 * w .. + 16 of the tile
  const int vk = t >> 3, w = t & 7;
  const int64_t s0 = it + 16 * w;
  if (t < kBM) ms[t] = it + t < npad ? smask[it + t] : 0.f;
  float acc[4][4];
  double acc64[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] = 0.f;
      acc64[i][j] = 0.0;
    }

  for (int64_t v0 = 0; v0 < nvar; v0 += kK) {
    __syncthreads();
    {
      const int64_t v = v0 + vk;
      uint32_t x = 0;
      float c0 = 0.f, c1 = 0.f, c2 = 0.f;
      if (v < nvar) {
        c0 = coef[v * 3];
        c1 = coef[v * 3 + 1];
        c2 = coef[v * 3 + 2];
        if (s0 < npad) x = load_codes16(packed + v * nb_bytes, nb_bytes, s0, base_aligned);
      }
      float z[16];
#pragma unroll
      for (int qq = 0; qq < 16; ++qq)
        z[qq] = zval((x >> (2 * qq)) & 3u, c0, c1, c2) * ms[16 * w + qq];
#pragma unroll
      for (int qq = 0; qq < 16; qq += 4)
        *reinterpret_cast<float4*>(&zs[vk][16 * w + qq]) =
            make_float4(z[qq], z[qq + 1], z[qq + 2], z[qq + 3]);
    }
    for (int i = t; i < kK * kBL; i += kThreads) {
      const int kk = i / kBL, ll = i % kBL;
      const int64_t v = v0 + kk;
      const int l = l0 + ll;
      bs[kk][ll] = (v < nvar && l < L) ? b[v * L + l] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kK; ++kk)
      fma44(acc, *reinterpret_cast<const float4*>(&zs[kk][ty * 4]),
            *reinterpret_cast<const float4*>(&bs[kk][tx * 4]));
    if ((v0 + kK) % kRun == 0 || v0 + kK >= nvar) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc64[i][j] += static_cast<double>(acc[i][j]);
          acc[i][j] = 0.f;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = it + ty * 4 + i;
    if (row >= npad) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int l = l0 + tx * 4 + j;
      if (l < L) acc_out[row * L + l] += acc64[i][j];
    }
  }
}

}  // namespace

// K9 on one block: packed [nvar, nb_bytes] u8 (npad = 4 * nb_bytes samples),
// coef [nvar, 3] f32, smask [npad] f32, q [npad, L] f32 -> out [nvar, L]
// f32.  part: f32 scratch of ceil(npad / 2048) * nvar * L.
PT_EXPORT int pt_pca_x(const void* packed, long long nb_bytes, long long nvar,
                       const void* coef, const void* smask, long long npad,
                       const void* q, int L, void* part, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nvar <= 0 || L <= 0) return cudaSuccess;
  if (npad != 4 * nb_bytes) return cudaErrorInvalidValue;
  const int runs = static_cast<int>((npad + kRun - 1) / kRun);
  const dim3 grid(static_cast<unsigned>((nvar + kBM - 1) / kBM), (L + kBL - 1) / kBL, runs);
  pca_x_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(packed), nb_bytes, nvar,
      static_cast<const float*>(coef), static_cast<const float*>(smask), npad,
      static_cast<const float*>(q), L, static_cast<float*>(part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t count = static_cast<int64_t>(nvar) * L;
  pca_x_reduce_kernel<<<static_cast<unsigned>((count + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), runs, count, static_cast<float*>(out));
  return cudaGetLastError();
}

// K10 on one block: packed [nvar, nb_bytes] u8, coef [nvar, 3] f32, smask
// [npad] f32, b [nvar, L] f32; acc [npad, L] f64 += Z^T b.
PT_EXPORT int pt_pca_xt(const void* packed, long long nb_bytes, long long nvar,
                        const void* coef, const void* smask, long long npad,
                        const void* b, int L, void* acc, void* stream) {
  if (nvar <= 0 || L <= 0) return cudaSuccess;
  if (npad != 4 * nb_bytes) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((npad + kBM - 1) / kBM), (L + kBL - 1) / kBL);
  pca_xt_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), nb_bytes, nvar,
      static_cast<const float*>(coef), static_cast<const float*>(smask), npad,
      static_cast<const float*>(b), L, static_cast<double*>(acc));
  return cudaGetLastError();
}
