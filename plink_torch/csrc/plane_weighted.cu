// K21 sample_plane_weighted and K22 variant_plane_weighted: weighted sums of
// the four genotype planes, per sample (K21) or per variant (K22), for K
// weight sets in one launch, accumulated in the caller's precision (f64, or
// f32 weights and sums; K21 adds its f32 splits in f64 and returns f64).
//
// Replace (plink_tpu/ops/counts.py) `_sample_plane_weighted` (:195-223) and
// `_variant_plane_weighted` (:237-257), which --het, --check-sex /
// --impute-sex, --score, --sample-counts and --variant-score call:
// - K21: out[k, s] = sum_v sum_p wts[v, p, k] * plane_p(v, s), planes
//   (hom-REF, het, hom-ALT, missing);
// - K22: out[v, k, q] = sum_s plane_q(v, s) * w[s, k], planes (het, hom-ALT,
//   valid = not missing).
// plink_tpu takes each plane's product with a dot, so a non-finite weight
// times a 0 entry of its plane is NaN: one NaN (or +-Inf) weight in a column
// makes that column NaN wherever the weight's plane is 0.  Both kernels keep
// that: K21 folds it into the weight a sample's class selects (below), K22
// multiplies by the 0/1 plane instead of selecting.
//
// K21 bound: operations at K >~ 3 in f64 (one add per sample, variant and
// weight set, 2.05e9 x K at 500,000 x 4,096) beside the 512 MB of packed
// bytes.  Design: one thread per packed byte (4 samples), neighbouring
// threads on neighbouring bytes; the block stages a tile of 64 variants'
// weights in shared memory as "effective" weights eff[v][c][k] = w[v][c][k]
// + 0 * (the other three planes' weights) -- exactly w[v][c][k] when those
// are finite, NaN when any is not, which is what the four products give --
// so the inner loop is one shared load (the sample's class picks the word;
// lanes of one class share it) and one add per sample and weight set.  The
// variant axis is cut into splits (grid.y) so enough blocks are in flight at
// 500,000 samples; a second pass adds the splits in index order.  In f32
// each split sums at most 2^24 variants (the wrapper sets the split count),
// and the second pass adds the f32 splits in f64 into an f64 output, as
// plink_tpu adds its f32 blocks on the host: 0/1 sums stay exact integers at
// any variant count.
//
// K22 bound: operations (three FMAs per sample, variant and weight set,
// 6.1e9 x K at 500,000 x 4,096).  Design: one warp per group of kVT = 4
// variants, lanes on neighbouring bytes; each lane loads its four samples'
// weights once (vector loads of the [K, npad] transpose) and uses them for
// the warp's four variants, multiplying by the 0/1 planes (so 0 * NaN stays
// NaN, as in the dots).  The sample axis is cut into splits (grid.y) for
// occupancy.  A warp's sums are reduced by a fixed xor-butterfly, the
// splits by a second pass in index order: no float atomics, so two runs
// give identical bytes.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileV = 64;  // K21: variants per shared-memory weight tile
constexpr int kVT = 4;      // K22: variants per warp

// K21.  wts [nvar, 4, K]; part [splits, K, 4 * nb] (the output itself when
// there is one split).  grid: (byte blocks, splits, weight-set chunks of KT).
template <typename T, int KT>
__global__ void __launch_bounds__(kThreads)
sample_plane_weighted_kernel(const uint8_t* __restrict__ packed, int64_t nb,
                             int nvar, const T* __restrict__ wts, int K,
                             int rows_per_split, T* __restrict__ part) {
  constexpr int CS = KT + 1;  // class stride: the 4 classes in distinct banks
  __shared__ T sw[kTileV][4 * CS];
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int k0 = blockIdx.z * KT;
  const int vbeg = blockIdx.y * rows_per_split;
  const int vend = min(nvar, vbeg + rows_per_split);
  T acc[4][KT];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) acc[j][kk] = T(0);
  for (int t0 = vbeg; t0 < vend; t0 += kTileV) {
    const int n = min(kTileV, vend - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < n * 4 * KT; i += kThreads) {
      const int r = i / (4 * KT), c = (i / KT) % 4, kk = i % KT;
      T e = T(0);
      if (k0 + kk < K) {
        const T* w = wts + static_cast<int64_t>(t0 + r) * 4 * K + k0 + kk;
        e = w[c * K];
#pragma unroll
        for (int p = 0; p < 4; ++p)
          if (p != c) e += T(0) * w[p * K];
      }
      sw[r][c * CS + kk] = e;
    }
    __syncthreads();
    if (b < nb) {
      const uint8_t* p = packed + static_cast<int64_t>(t0) * nb + b;
#pragma unroll 4
      for (int r = 0; r < n; ++r) {
        const uint32_t x = __ldg(p + static_cast<int64_t>(r) * nb);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const T* e = &sw[r][((x >> (2 * j)) & 3u) * CS];
#pragma unroll
          for (int kk = 0; kk < KT; ++kk) acc[j][kk] += e[kk];
        }
      }
    }
  }
  if (b >= nb) return;
  const int64_t npad = 4 * nb;
  T* o = part + static_cast<int64_t>(blockIdx.y) * K * npad;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    if (k0 + kk >= K) break;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[static_cast<int64_t>(k0 + kk) * npad + 4 * b + j] = acc[j][kk];
  }
}

// Four consecutive weights of one weight set (16-byte aligned: npad is a
// multiple of 4 and the row starts are).
__device__ __forceinline__ void load4(const double* p, double (&w)[4]) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 c = __ldg(reinterpret_cast<const double2*>(p) + 1);
  w[0] = a.x; w[1] = a.y; w[2] = c.x; w[3] = c.y;
}
__device__ __forceinline__ void load4(const float* p, float (&w)[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
}

// K22.  wt [K, npad] (the weights' transpose); part [splits, nvar, K, 3]
// (the output itself when there is one split).  grid: (variant groups of
// 8 warps x kVT, splits, weight-set chunks of KT).
template <typename T, int KT>
__global__ void __launch_bounds__(kThreads)
variant_plane_weighted_kernel(const uint8_t* __restrict__ packed, int64_t nb,
                              int nvar, const T* __restrict__ wt, int K,
                              int64_t bytes_per_split, T* __restrict__ part) {
  const int lane = threadIdx.x & 31;
  const int v0 = (blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * kVT;
  const int k0 = blockIdx.z * KT;
  if (v0 >= nvar) return;  // whole warps: no barrier below
  const int64_t npad = 4 * nb;
  const int64_t bbeg = blockIdx.y * bytes_per_split;
  const int64_t bend = min(nb, bbeg + bytes_per_split);
  T acc[kVT][KT][3];
#pragma unroll
  for (int i = 0; i < kVT; ++i)
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) acc[i][kk][0] = acc[i][kk][1] = acc[i][kk][2] = T(0);
  for (int64_t b = bbeg + lane; b < bend; b += 32) {
    uint32_t x[kVT];
#pragma unroll
    for (int i = 0; i < kVT; ++i)
      x[i] = v0 + i < nvar ? __ldg(packed + static_cast<int64_t>(v0 + i) * nb + b) : 0u;
    T w[KT][4];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      if (k0 + kk < K) {
        load4(wt + static_cast<int64_t>(k0 + kk) * npad + 4 * b, w[kk]);
      } else {
        w[kk][0] = w[kk][1] = w[kk][2] = w[kk][3] = T(0);
      }
    }
#pragma unroll
    for (int i = 0; i < kVT; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t c = (x[i] >> (2 * j)) & 3u;
        const T het = c == 1u ? T(1) : T(0);
        const T alt = c == 2u ? T(1) : T(0);
        const T valid = c != 3u ? T(1) : T(0);
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          acc[i][kk][0] = fma(w[kk][j], het, acc[i][kk][0]);
          acc[i][kk][1] = fma(w[kk][j], alt, acc[i][kk][1]);
          acc[i][kk][2] = fma(w[kk][j], valid, acc[i][kk][2]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kVT; ++i)
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        T s = acc[i][kk][q];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        acc[i][kk][q] = s;
      }
  if (lane != 0) return;
  T* o = part + static_cast<int64_t>(blockIdx.y) * nvar * K * 3;
#pragma unroll
  for (int i = 0; i < kVT; ++i) {
    if (v0 + i >= nvar) break;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      if (k0 + kk >= K) break;
#pragma unroll
      for (int q = 0; q < 3; ++q)
        o[(static_cast<int64_t>(v0 + i) * K + k0 + kk) * 3 + q] = acc[i][kk][q];
    }
  }
}

// out[i] = sum over splits (in index order) of part[split, i], in TO.
template <typename T, typename TO>
__global__ void sum_splits_kernel(const T* __restrict__ part, int splits,
                                  int64_t n, TO* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  TO s = part[i];
  for (int sp = 1; sp < splits; ++sp) s += part[static_cast<int64_t>(sp) * n + i];
  out[i] = s;
}

template <typename T, typename TO>
cudaError_t sum_splits(const T* part, int splits, int64_t n, TO* out,
                       cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  sum_splits_kernel<T, TO><<<blocks, kThreads, 0, stream>>>(part, splits, n, out);
  return cudaGetLastError();
}

// weight sets a chunk: K split into ceil(K / KMAX) near-equal chunks
inline int chunk_width(int K, int kmax) {
  const int chunks = (K + kmax - 1) / kmax;
  return (K + chunks - 1) / chunks;
}

// T the weights' and splits' type, double the output's: f64 with one split
// writes the output directly; f32 always goes through the f64 split sum.
template <typename T, int KT>
cudaError_t launch_spw(const uint8_t* packed, int64_t nb, int nvar, const T* w,
                       int K, int splits, T* part, double* out, cudaStream_t s) {
  const int rows = (nvar + splits - 1) / splits;
  const dim3 grid(static_cast<unsigned>((nb + kThreads - 1) / kThreads), splits,
                  (K + KT - 1) / KT);
  const bool direct = splits == 1 && sizeof(T) == sizeof(double);
  sample_plane_weighted_kernel<T, KT><<<grid, kThreads, 0, s>>>(
      packed, nb, nvar, w, K, rows, direct ? reinterpret_cast<T*>(out) : part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || direct) return err;
  return sum_splits<T, double>(part, splits, static_cast<int64_t>(K) * 4 * nb, out, s);
}

template <typename T>
cudaError_t dispatch_spw(const uint8_t* p, int64_t nb, int nvar, const T* w, int K,
                         int splits, T* part, double* out, cudaStream_t s) {
  switch (chunk_width(K, 8)) {
#define PT_SPW(KT) case KT: return launch_spw<T, KT>(p, nb, nvar, w, K, splits, part, out, s);
    PT_SPW(1) PT_SPW(2) PT_SPW(3) PT_SPW(4) PT_SPW(5) PT_SPW(6) PT_SPW(7) PT_SPW(8)
#undef PT_SPW
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int KT>
cudaError_t launch_vpw(const uint8_t* packed, int64_t nb, int nvar, const T* wt,
                       int K, int splits, T* part, T* out, cudaStream_t s) {
  const int64_t per = (((nb + splits - 1) / splits) + 31) / 32 * 32;
  const int per_block = (kThreads / 32) * kVT;
  const dim3 grid((nvar + per_block - 1) / per_block, splits, (K + KT - 1) / KT);
  variant_plane_weighted_kernel<T, KT><<<grid, kThreads, 0, s>>>(
      packed, nb, nvar, wt, K, per, splits == 1 ? out : part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return sum_splits<T, T>(part, splits, static_cast<int64_t>(nvar) * K * 3, out, s);
}

template <typename T>
cudaError_t dispatch_vpw(const uint8_t* p, int64_t nb, int nvar, const T* wt, int K,
                         int splits, T* part, T* out, cudaStream_t s) {
  switch (chunk_width(K, 4)) {
#define PT_VPW(KT) case KT: return launch_vpw<T, KT>(p, nb, nvar, wt, K, splits, part, out, s);
    PT_VPW(1) PT_VPW(2) PT_VPW(3) PT_VPW(4)
#undef PT_VPW
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// K21.  packed [nvar, nb] u8; wts [nvar, 4, K] f64 (is_f64) or f32; part
// [splits, K, 4 * nb] scratch of the weights' type (unused with one split in
// f64); out [K, 4 * nb] f64.
PT_EXPORT int pt_sample_plane_weighted(const void* packed, long long nb, int nvar,
                                       const void* wts, int K, int is_f64,
                                       int splits, void* part, void* out,
                                       void* stream) {
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb == 0 || K == 0) return cudaSuccess;
  if (splits < 1 || splits > 65535 || ((splits > 1 || !is_f64) && part == nullptr))
    return cudaErrorInvalidValue;
  if (nvar == 0)
    return cudaMemsetAsync(out, 0, static_cast<size_t>(K) * 4 * nb * 8, s);
  double* o = static_cast<double*>(out);
  if (is_f64)
    return dispatch_spw<double>(p, nb, nvar, static_cast<const double*>(wts), K,
                                splits, static_cast<double*>(part), o, s);
  return dispatch_spw<float>(p, nb, nvar, static_cast<const float*>(wts), K, splits,
                             static_cast<float*>(part), o, s);
}

// K22.  packed [nvar, nb] u8; wt [K, 4 * nb] f64 (is_f64) or f32, 16-byte
// aligned; part [splits, nvar, K, 3] scratch (unused with one split); out
// [nvar, K, 3].
PT_EXPORT int pt_variant_plane_weighted(const void* packed, long long nb, int nvar,
                                        const void* wt, int K, int is_f64,
                                        int splits, void* part, void* out,
                                        void* stream) {
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nvar == 0 || K == 0) return cudaSuccess;
  if (splits < 1 || splits > 65535 || (splits > 1 && part == nullptr) ||
      (reinterpret_cast<uintptr_t>(wt) & 15) != 0)
    return cudaErrorInvalidValue;
  if (nb == 0) {
    const size_t bytes = static_cast<size_t>(nvar) * K * 3 * (is_f64 ? 8 : 4);
    return cudaMemsetAsync(out, 0, bytes, s);
  }
  if (is_f64)
    return dispatch_vpw<double>(p, nb, nvar, static_cast<const double*>(wt), K,
                                splits, static_cast<double*>(part),
                                static_cast<double*>(out), s);
  return dispatch_vpw<float>(p, nb, nvar, static_cast<const float*>(wt), K, splits,
                             static_cast<float*>(part), static_cast<float*>(out), s);
}
