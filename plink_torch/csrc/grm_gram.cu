// K8 grm_gram: one [s, c] block of the genomic relationship matrix, summed
// over every variant in one launch.
//
// Replaces (plink_tpu/ops/pairwise.py) `grm_tile` (:215) and `grm_chunk`
// (:355, = `_grm_chunk_local` :303 + `_grm_chunk_finish` :343).  For row
// sample i and column sample j of the tile:
//   acc_ij = sum_v Z_vi Z_vj,  Z_vi = coef[v, code_vi] (0 when missing)
//   jm_ij  = #(variants in vmask missing at both i and j)
//   nm_ij  = Mv - m_i - m_j + jm_ij   (valid pairs; m = per-sample missing
//            counts over vmask, K5; Mv = variants in vmask)
// Chunk mode (the streaming --make-grm-bin) writes g = f32(acc / nm), the
// division in f64 on the device, and nm as f32, the .grm.N.bin value (exact:
// nm < 2^24), so the host only packs the triangle; tile mode writes acc
// (f64, or f32) and nm (int32).
//
// Numerics follow JAX's HIGHEST contract: full f32 products (no TF32 or
// bf16), at most 2,048 variants per f32 accumulator, the runs added in
// f64.  Bound: operations, 2 s c V FP32 (16.4 ms per 2,048 x 8,192 chunk
// at V = 32,768 and 67 TFLOP/s outside the tensor cores).  Design: a
// shared-memory tiled SGEMM, 128 x 128 outputs a block, 8 x 8 a thread,
// 32 variants per step.  The packed codes are decoded and looked up in coef
// on the way into shared memory (warp = 16 samples, lane = variant); the
// same warps take each sample's 32-variant missing word with one ballot,
// so jm is one AND + popcount per pair and step.  The f64 run sums live in
// dynamic shared memory (128 KB a block), each thread owning its cells.
// No atomics on floats: two runs give identical bytes.
#include "common.cuh"

namespace {

constexpr int kBM = 128;          // rows (and columns) a block
constexpr int kK = 32;            // variants a step
constexpr int kPad = kBM + 4;     // shared row stride (floats)
constexpr int kRun = 2048;        // variants per f32 accumulator
constexpr int kThreads = 256;     // 16 x 16 threads, 8 x 8 outputs each
constexpr size_t kSmem = sizeof(double) * kBM * kBM + 2 * sizeof(float) * kK * kPad +
                         2 * sizeof(uint32_t) * kBM;

// Decode 16 samples of one variant (lane) into shared Z and the warp's
// 16 missing words.
__device__ __forceinline__ void stage_side(const uint8_t* __restrict__ packed,
                                          int64_t nb_bytes, bool base_aligned,
                                          int64_t v, bool in_v, bool vm,
                                          float c0, float c1, float c2,
                                          int64_t first, int local, int len,
                                          int lane, int slot,
                                          float* __restrict__ z,
                                          uint32_t* __restrict__ mword) {
  uint32_t x = 0;
  if (in_v && local < len) {
    const bool aligned = base_aligned && ((first & 15) == 0);
    x = load_codes16(packed + v * nb_bytes, nb_bytes, first, aligned);
  }
  uint32_t mine = 0;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const uint32_t code = (x >> (2 * q)) & 3u;
    const bool ok = in_v && (local + q < len);
    const float val = code == 0u ? c0 : code == 1u ? c1 : code == 2u ? c2 : 0.f;
    z[lane * kPad + slot + q] = ok ? val : 0.f;
    const uint32_t m = __ballot_sync(0xffffffffu, ok && vm && code == 3u);
    if (lane == q) mine = m;
  }
  if (lane < 16) mword[slot + lane] = mine;
}

// mode 0: chunk (g f32, nm f32); mode 1/2: tile (acc f64 / f32, nm int32).
__global__ void __launch_bounds__(kThreads, 1)
grm_gram_kernel(const uint8_t* __restrict__ packed, int64_t nb_bytes,
                int64_t nvar, const int8_t* __restrict__ vmask,
                const float* __restrict__ coef, const int* __restrict__ miss,
                int64_t mv, int64_t row0, int s, int64_t col0, int c, int mode,
                void* __restrict__ out_val, void* __restrict__ out_cnt) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* acc64 = reinterpret_cast<double*>(smem);
  float* za = reinterpret_cast<float*>(acc64 + kBM * kBM);
  float* zb = za + kK * kPad;
  uint32_t* ma = reinterpret_cast<uint32_t*>(zb + kK * kPad);
  uint32_t* mb = ma + kBM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int rb = blockIdx.y * kBM, cb = blockIdx.x * kBM;
  const bool base_aligned = ((nb_bytes & 3) == 0) &&
                            ((reinterpret_cast<uintptr_t>(packed) & 3) == 0);
  float acc[8][8];
  int jm[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[i][j] = 0.f;
      jm[i][j] = 0;
      acc64[(ty * 8 + i) * kBM + tx * 8 + j] = 0.0;
    }

  for (int64_t v0 = 0; v0 < nvar; v0 += kK) {
    const int64_t v = v0 + lane;
    const bool in_v = v < nvar;
    float c0 = 0.f, c1 = 0.f, c2 = 0.f;
    bool vm = false;
    if (in_v) {
      c0 = coef[v * 3];
      c1 = coef[v * 3 + 1];
      c2 = coef[v * 3 + 2];
      vm = vmask[v] != 0;
    }
    __syncthreads();
    const int slot = 16 * warp;
    stage_side(packed, nb_bytes, base_aligned, v, in_v, vm, c0, c1, c2,
               row0 + rb + slot, rb + slot, s, lane, slot, za, ma);
    stage_side(packed, nb_bytes, base_aligned, v, in_v, vm, c0, c1, c2,
               col0 + cb + slot, cb + slot, c, lane, slot, zb, mb);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(za + k * kPad + ty * 8);
      const float4 a1 = *reinterpret_cast<const float4*>(za + k * kPad + ty * 8 + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(zb + k * kPad + tx * 8);
      const float4 b1 = *reinterpret_cast<const float4*>(zb + k * kPad + tx * 8 + 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    {
      const uint4 r0 = *reinterpret_cast<const uint4*>(ma + ty * 8);
      const uint4 r1 = *reinterpret_cast<const uint4*>(ma + ty * 8 + 4);
      const uint4 q0 = *reinterpret_cast<const uint4*>(mb + tx * 8);
      const uint4 q1 = *reinterpret_cast<const uint4*>(mb + tx * 8 + 4);
      const uint32_t mr[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
      const uint32_t mc[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) jm[i][j] += __popc(mr[i] & mc[j]);
    }
    if ((v0 + kK) % kRun == 0 || v0 + kK >= nvar) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc64[(ty * 8 + i) * kBM + tx * 8 + j] += static_cast<double>(acc[i][j]);
          acc[i][j] = 0.f;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rb + ty * 8 + i;
    if (r >= s) continue;
    const int mi = miss[row0 + r];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = cb + tx * 8 + j;
      if (col >= c) continue;
      const int mj = miss[col0 + col];
      const int64_t o = static_cast<int64_t>(r) * c + col;
      const double a = acc64[(ty * 8 + i) * kBM + tx * 8 + j];
      const int q = jm[i][j];
      if (mode == 0) {
        // _grm_chunk_finish: (Mv - m_i - m_j) + jm in f64, then acc / nm
        const double nm = __dadd_rn(__dsub_rn(__dsub_rn(static_cast<double>(mv),
                                                        static_cast<double>(mi)),
                                              static_cast<double>(mj)),
                                    static_cast<double>(q));
        static_cast<float*>(out_val)[o] = __double2float_rn(__ddiv_rn(a, nm));
        static_cast<float*>(out_cnt)[o] = static_cast<float>(nm);
      } else {
        if (mode == 1)
          static_cast<double*>(out_val)[o] = a;
        else
          static_cast<float*>(out_val)[o] = __double2float_rn(a);
        static_cast<int*>(out_cnt)[o] = static_cast<int>(mv - mi - mj + q);
      }
    }
  }
}

}  // namespace

// packed [nvar, nb_bytes] u8 (the [nb, vb, NB] blocks, flattened); vmask
// [nvar] i8; coef [nvar, 3] f32; miss [npad] i32 (K5's per-sample missing
// counts over vmask); mv = variants in vmask.  The tile is samples [row0,
// row0 + s) x [col0, col0 + c), both inside the packed rows.  Mode 0: g f32
// and nm f32 [s, c]; mode 1: acc f64 and nm int32 [s, c]; mode 2: acc f32
// and nm int32.
PT_EXPORT int pt_grm_gram(const void* packed, long long nb_bytes, long long nvar,
                          const void* vmask, const void* coef, const void* miss,
                          long long mv, long long row0, int s, long long col0,
                          int c, int mode, void* out_val, void* out_cnt,
                          void* stream) {
  if (s <= 0 || c <= 0) return cudaSuccess;
  if (mode < 0 || mode > 2) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      grm_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((c + kBM - 1) / kBM, (s + kBM - 1) / kBM);
  grm_gram_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), nb_bytes, nvar,
      static_cast<const int8_t*>(vmask), static_cast<const float*>(coef),
      static_cast<const int*>(miss), mv, row0, s, col0, c, mode, out_val,
      out_cnt);
  return cudaGetLastError();
}
