// K4 chol_small: batched Cholesky factor, solve, inverse and log-determinant
// of small SPD matrices, one matrix per variant.
//
// Replaces (plink_tpu/ops/glm.py) `_chol_small` (:125), `_chol_solve_small`
// (:154), `_chol_inv_small` (:173), hence `_solve_psd` / `_inv_psd`
// (:221-239), and the Cholesky log-determinant of `_firth_core` (:537-542).
// Same arithmetic order as `_chol_small`.  A row whose pivot is not > 0 (not
// positive definite, or NaN input) yields NaN in every requested output, as
// the unrolled JAX factor and LAPACK's failed potrf do; the IRLS callers
// detect failure from that NaN.
//
// Bound: latency.  ~d^3/2 flops per matrix (1.5 MFLOP for 2,048 matrices of
// d = 13), far below any throughput limit; the card is mostly idle for the
// few microseconds it runs.  Design, d <= 48: one thread per matrix, the
// factor and its inverse in per-thread (local) arrays sized by a
// compile-time bound on d, no shared memory and no synchronisation.
// d > 48 (the wide --glm designs): one 128-thread block per matrix with the
// packed factor L, its inverse and the solve's vector in dynamic shared
// memory (2 x 18.6 KB at d = 96; two f32 triangles fit the 227 KB up to d =
// 236); each column of the factor is one pivot and a parallel update of the
// rows below it, each column of L^-1 one thread, each entry of the inverse
// one thread, the triangular solves one thread, every sum in the one-thread
// kernel's order.  Above the shared-memory limit the same block keeps them
// in a device-memory workspace the caller provides (one slice a matrix), so
// no width is refused.
#include "common.cuh"

namespace {

template <int MAXD>
__global__ void chol_small_kernel(const float* __restrict__ h, int vb, int d,
                                  const float* __restrict__ rhs,
                                  float* __restrict__ x,
                                  float* __restrict__ inv,
                                  float* __restrict__ logdet) {
  constexpr int T = MAXD * (MAXD + 1) / 2;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= vb) return;
  const float* a = h + static_cast<int64_t>(v) * d * d;
  float L[T];  // lower triangle, row-major: (i, j) at i(i+1)/2 + j
  bool ok = true;
  for (int j = 0; j < d && ok; ++j) {
    const int jj = j * (j + 1) / 2;
    float s = a[j * d + j];
    for (int k = 0; k < j; ++k) s -= L[jj + k] * L[jj + k];
    if (!(s > 0.f)) {
      ok = false;
      break;
    }
    const float ljj = sqrtf(s);
    L[jj + j] = ljj;
    const float rinv = 1.f / ljj;
    for (int i = j + 1; i < d; ++i) {
      const int ii = i * (i + 1) / 2;
      float t = a[i * d + j];
      for (int k = 0; k < j; ++k) t -= L[ii + k] * L[jj + k];
      L[ii + j] = t * rinv;
    }
  }
  const float nan = __int_as_float(0x7fc00000);
  if (logdet) {
    float s = 0.f;
    if (ok)
      for (int j = 0; j < d; ++j) s += logf(L[j * (j + 1) / 2 + j]);
    logdet[v] = ok ? 2.f * s : nan;
  }
  if (x) {
    float* xo = x + static_cast<int64_t>(v) * d;
    if (!ok) {
      for (int i = 0; i < d; ++i) xo[i] = nan;
    } else {
      const float* g = rhs + static_cast<int64_t>(v) * d;
      float y[MAXD];
      for (int i = 0; i < d; ++i) {
        const int ii = i * (i + 1) / 2;
        float s = g[i];
        for (int k = 0; k < i; ++k) s -= L[ii + k] * y[k];
        y[i] = s / L[ii + i];
      }
      for (int i = d - 1; i >= 0; --i) {
        float s = y[i];
        for (int k = i + 1; k < d; ++k) s -= L[k * (k + 1) / 2 + i] * y[k];
        y[i] = s / L[i * (i + 1) / 2 + i];  // y[k > i] already hold x
      }
      for (int i = 0; i < d; ++i) xo[i] = y[i];
    }
  }
  if (inv) {
    float* io = inv + static_cast<int64_t>(v) * d * d;
    if (!ok) {
      for (int i = 0; i < d * d; ++i) io[i] = nan;
      return;
    }
    float M[T];  // L^-1, lower triangle
    for (int j = 0; j < d; ++j) {
      M[j * (j + 1) / 2 + j] = 1.f / L[j * (j + 1) / 2 + j];
      for (int i = j + 1; i < d; ++i) {
        const int ii = i * (i + 1) / 2;
        float s = 0.f;
        for (int k = j; k < i; ++k) s += L[ii + k] * M[k * (k + 1) / 2 + j];
        M[ii + j] = -s / L[ii + i];
      }
    }
    for (int i = 0; i < d; ++i)
      for (int j = 0; j <= i; ++j) {
        float s = 0.f;
        for (int k = i; k < d; ++k) {
          const int kk = k * (k + 1) / 2;
          s += M[kk + i] * M[kk + j];
        }
        io[i * d + j] = s;
        io[j * d + i] = s;
      }
  }
}

constexpr int kCholWideThreads = 128;
constexpr size_t kCholSmemMax = 227 * 1024 - 64;  // less the static ok flag

// floats of one matrix's L, L^-1 and solve vector
__host__ __device__ inline int64_t chol_wide_floats(int d) {
  return static_cast<int64_t>(d) * (d + 1) + d;
}

__global__ void __launch_bounds__(kCholWideThreads)
chol_wide_kernel(const float* __restrict__ h, int d,
                 const float* __restrict__ rhs, float* __restrict__ x,
                 float* __restrict__ inv, float* __restrict__ logdet,
                 float* __restrict__ ws) {
  extern __shared__ float dsm[];
  __shared__ int ok_s;
  const int v = blockIdx.x;
  const int tid = threadIdx.x;
  // shared memory, or the matrix's slice of the workspace
  float* L = ws ? ws + static_cast<int64_t>(v) * chol_wide_floats(d) : dsm;
  float* M = L + d * (d + 1) / 2;  // L^-1; both row-major lower triangles
  float* y = M + d * (d + 1) / 2;
  const float* a = h + static_cast<int64_t>(v) * d * d;
  if (tid == 0) ok_s = 1;
  __syncthreads();
  for (int j = 0; j < d; ++j) {
    const int jj = j * (j + 1) / 2;
    if (tid == 0) {
      float s = a[j * d + j];
      for (int k = 0; k < j; ++k) s -= L[jj + k] * L[jj + k];
      if (!(s > 0.f)) ok_s = 0;
      L[jj + j] = sqrtf(s);
    }
    __syncthreads();
    if (!ok_s) break;
    const float rinv = 1.f / L[jj + j];
    for (int i = j + 1 + tid; i < d; i += kCholWideThreads) {
      const int ii = i * (i + 1) / 2;
      float t = a[i * d + j];
      for (int k = 0; k < j; ++k) t -= L[ii + k] * L[jj + k];
      L[ii + j] = t * rinv;
    }
    __syncthreads();
  }
  const bool ok = ok_s != 0;
  const float nan = __int_as_float(0x7fc00000);
  if (logdet && tid == 0) {
    float s = 0.f;
    if (ok)
      for (int j = 0; j < d; ++j) s += logf(L[j * (j + 1) / 2 + j]);
    logdet[v] = ok ? 2.f * s : nan;
  }
  if (x && tid == 0) {
    float* xo = x + static_cast<int64_t>(v) * d;
    if (!ok) {
      for (int i = 0; i < d; ++i) xo[i] = nan;
    } else {
      const float* g = rhs + static_cast<int64_t>(v) * d;
      for (int i = 0; i < d; ++i) {
        const int ii = i * (i + 1) / 2;
        float s = g[i];
        for (int k = 0; k < i; ++k) s -= L[ii + k] * y[k];
        y[i] = s / L[ii + i];
      }
      for (int i = d - 1; i >= 0; --i) {
        float s = y[i];
        for (int k = i + 1; k < d; ++k) s -= L[k * (k + 1) / 2 + i] * y[k];
        y[i] = s / L[i * (i + 1) / 2 + i];
      }
      for (int i = 0; i < d; ++i) xo[i] = y[i];
    }
  }
  if (!inv) return;
  float* io = inv + static_cast<int64_t>(v) * d * d;
  if (!ok) {
    for (int i = tid; i < d * d; i += kCholWideThreads) io[i] = nan;
    return;
  }
  for (int j = tid; j < d; j += kCholWideThreads) {  // column j of L^-1
    M[j * (j + 1) / 2 + j] = 1.f / L[j * (j + 1) / 2 + j];
    for (int i = j + 1; i < d; ++i) {
      const int ii = i * (i + 1) / 2;
      float s = 0.f;
      for (int k = j; k < i; ++k) s += L[ii + k] * M[k * (k + 1) / 2 + j];
      M[ii + j] = -s / L[ii + i];
    }
  }
  __syncthreads();
  for (int e = tid; e < d * (d + 1) / 2; e += kCholWideThreads) {
    int i = 0;
    while ((i + 1) * (i + 2) / 2 <= e) ++i;
    const int j = e - i * (i + 1) / 2;  // j <= i
    float s = 0.f;
    for (int k = i; k < d; ++k) {
      const int kk = k * (k + 1) / 2;
      s += M[kk + i] * M[kk + j];
    }
    io[i * d + j] = s;
    io[j * d + i] = s;
  }
}

template <int MAXD>
cudaError_t launch_chol(const float* h, int vb, int d, const float* rhs,
                        float* x, float* inv, float* logdet,
                        cudaStream_t stream) {
  const int threads = 64;
  chol_small_kernel<MAXD><<<(vb + threads - 1) / threads, threads, 0, stream>>>(
      h, vb, d, rhs, x, inv, logdet);
  return cudaGetLastError();
}

}  // namespace

// h [vb, d, d] f32.  Each output is written when its pointer is not null:
// x [vb, d] = h^-1 rhs (rhs [vb, d]), inv [vb, d, d], logdet [vb].  ws: f32
// [vb, d(d+1) + d] scratch where one matrix's d(d+1) + d floats exceed
// kCholSmemMax bytes (d > 240), else null.

PT_EXPORT int pt_chol_small(const void* h, int vb, int d, const void* rhs,
                            void* x, void* inv, void* logdet, void* ws,
                            void* stream) {
  if (d < 1 || (x && !rhs)) return cudaErrorInvalidValue;
  const float* hp = static_cast<const float*>(h);
  const float* rp = static_cast<const float*>(rhs);
  float* xp = static_cast<float*>(x);
  float* ip = static_cast<float*>(inv);
  float* lp = static_cast<float*>(logdet);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 16) return launch_chol<16>(hp, vb, d, rp, xp, ip, lp, s);
  if (d <= 48) return launch_chol<48>(hp, vb, d, rp, xp, ip, lp, s);
  float* wp = static_cast<float*>(ws);
  const size_t smem = wp ? 0 : sizeof(float) * chol_wide_floats(d);
  if (smem > kCholSmemMax) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chol_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  chol_wide_kernel<<<vb, kCholWideThreads, smem, s>>>(hp, d, rp, xp, ip, lp,
                                                       wp);
  return cudaGetLastError();
}
