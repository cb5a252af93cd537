// Shared pieces of the plink_torch CUDA kernels: the 2-bit pgen decode and
// the fixed-order second pass that sums per-split partial sums.
//
// Every kernel is exported through a plain C entry point (loaded with
// ctypes), launches on the stream it is given, allocates nothing, and
// returns the cudaError_t of its launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define PT_EXPORT extern "C" __attribute__((visibility("default")))

// Each kernel source builds into its own shared library, so each carries
// this once.
PT_EXPORT const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Samples per shared-memory tile of the per-sample table.
constexpr int kTileSamples = 128;
// Variants per block in the thread-per-variant kernels (K2, K3).
constexpr int kTileVariants = 64;

// Sixteen 2-bit codes (pgen order: sample 4*b + k sits in bits 2k..2k+1 of
// byte b) starting at sample `s` of a packed row of `nb` bytes.  `s` is a
// multiple of 16.  Word loads when the row is 4-byte aligned, else bytes;
// bytes past the row end read as 0 (hom-REF), which callers mask anyway.
__device__ __forceinline__ uint32_t load_codes16(const uint8_t* row, int64_t nb,
                                                 int64_t s, bool aligned) {
  const int64_t b = s >> 2;
  if (aligned) return *reinterpret_cast<const uint32_t*>(row + b);
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (b + i < nb) w |= static_cast<uint32_t>(row[b + i]) << (8 * i);
  return w;
}

// Sample s's uint16 A1 dosage from a variant's dosage row (the column
// source of the dense mode of K2 / K3, i.e. K17 / K18 in glm_dense.cu, and
// of K15 / K16: g = u / 16384, 65535 = missing).
__device__ __forceinline__ uint32_t load_dosage(const uint8_t* row, int64_t s) {
  return __ldg(reinterpret_cast<const uint16_t*>(row) + s);
}

// Second pass of the split-sample kernels: out[v, j, k] (full symmetric,
// from the packed upper triangle), vec[v, j] and ll[v] from per-split
// partials laid out [split][entry][variant].  One thread per (entry,
// variant), neighbouring threads on neighbouring variants so the partial
// reads coalesce; splits are summed in f64 in index order, so the bytes do
// not depend on scheduling and the sum over splits adds no f32 drift.
template <int D>
__global__ void reduce_splits_kernel(const float* __restrict__ part,
                                     const double* __restrict__ part_ll,
                                     int splits, int vb, int has_vec,
                                     float* __restrict__ out_mat,
                                     float* __restrict__ out_vec,
                                     double* __restrict__ out_ll) {
  constexpr int NTRI = D * (D + 1) / 2;
  const int nt = NTRI + (has_vec ? D : 0);
  const int per_v = D * D + (has_vec ? D : 0) + (part_ll ? 1 : 0);
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(vb) * per_v) return;
  const int e = static_cast<int>(idx / vb);
  const int v = static_cast<int>(idx % vb);
  if (e < D * D) {
    int j = e / D, k = e % D;
    if (j > k) { int t = j; j = k; k = t; }
    const int tri = j * D - j * (j - 1) / 2 + (k - j);
    double s = 0.0;
    for (int sp = 0; sp < splits; ++sp)
      s += part[(static_cast<int64_t>(sp) * nt + tri) * vb + v];
    out_mat[static_cast<int64_t>(v) * D * D + e] = static_cast<float>(s);
  } else if (has_vec && e < D * D + D) {
    const int j = e - D * D;
    double s = 0.0;
    for (int sp = 0; sp < splits; ++sp)
      s += part[(static_cast<int64_t>(sp) * nt + NTRI + j) * vb + v];
    out_vec[static_cast<int64_t>(v) * D + j] = static_cast<float>(s);
  } else {
    double s = 0.0;
    for (int sp = 0; sp < splits; ++sp)
      s += part_ll[static_cast<int64_t>(sp) * vb + v];
    out_ll[v] = s;
  }
}

template <int D>
inline cudaError_t launch_reduce(const float* part, const double* part_ll,
                                 int splits, int vb, int has_vec,
                                 float* out_mat, float* out_vec, double* out_ll,
                                 cudaStream_t stream) {
  const int per_v = D * D + (has_vec ? D : 0) + (part_ll ? 1 : 0);
  const int64_t total = static_cast<int64_t>(vb) * per_v;
  const int threads = 256;
  const int blocks = static_cast<int>((total + threads - 1) / threads);
  reduce_splits_kernel<D><<<blocks, threads, 0, stream>>>(
      part, part_ll, splits, vb, has_vec, out_mat, out_vec, out_ll);
  return cudaGetLastError();
}

// Expands a compile-time dispatch over the number of covariate columns.
#define PT_NC_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) \
  X(14) X(15) X(16)
