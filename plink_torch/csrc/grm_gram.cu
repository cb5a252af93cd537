// K8 grm_gram: one [s, c] block of the genomic relationship matrix, summed
// over every variant in one launch, on Hopper's bf16 tensor cores.
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
// Numerics: JAX's HIGHEST contract, no TF32 and no bf16 rounding of a Z.
// Each Z (one of a variant's three coefficients) is the exact sum of three
// bf16 parts hi + mid + lo (`hop::split_bf16x3`: each part the leading 8
// bits of what is left, |mid| < 2^-7 |Z|, |lo| < 2^-14 |Z|), so a product
// of two parts is exact on the tensor cores and only the f32 accumulation
// rounds.  K8 takes six of the nine part pairs: it leaves out
// mid lo, lo mid and lo lo, each below 2^-21 |Z_i Z_j| (on the diagonal of
// one sign: mid and lo keep Z's sign).  The tensor cores truncate as they
// accumulate, so a long f32 sum drifts low: hi hi goes into its own
// accumulator, the smaller part pairs into another (its drift 2^-7 as
// large), and at the end of every kRun-variant run the two are added (f32)
// into f64 sums, in variant order: no float atomics, two runs give
// identical bytes.  The drift sets the error, not the left-out pairs:
// tools/grm_breakdown.py times and measures the nine-product scheme and
// longer runs from patched copies of this file (PERF.md has its numbers).
// Runs of 128 keep a 2,048 x 8,192 chunk over 32,768 variants well inside
// chip_smoke's limit (2e-6 of sqrt(sum Z_i^2 sum Z_j^2)), and the GRM's
// .grm.bin parity case (2e-6 absolute on g, the diagonal near 2) inside
// its own, where runs of 256 missed it on a 2,000 x 800 panel.  jm is one
// more product, of
// the 0/1 missing planes (code 3 of a variant in vmask): exact in its own
// f32 accumulator, which goes into int32 sums every 2^22 variants.
//
// Bound: operations.  2 s c V per product: at a 2,048 x 8,192 chunk over
// V = 32,768 (bench.py's grm_50k) 1.10e12, 6.7 ms for six bf16 products at
// 989 TFLOP/s (10.0 ms for nine), plus jm as an int8 product 0.56 ms; 16.4
// ms for one f32 product at the FP32 rate (the SIMT kernel this replaced
// ran at 48 ms).  The bytes (84 MB of codes, 134 MB of outputs) take 0.07
// ms.
//
// Design.  A CTA is two warpgroups, 128 row samples (two wgmma M = 64) by 64
// column samples (wgmma N), and streams every variant in stages of 128
// (eight k16 steps; 207 KB of shared memory):
//  - cp.async copies the stage's code bytes (rows and columns), its
//    coefficients and vmask into a ring of four stages, in 16-byte pieces
//    when every source is 16-byte aligned (the commands' tiles are), else
//    by plain loads;
//  - the threads turn the next stage's coefficients into a table: for each
//    variant and code, its three bf16 parts and its missing flag (8 bytes);
//  - every thread decodes four 8-variant chunks of the column side into the
//    four B planes (hi, mid, lo, missing; bf16, K-major, 2 KB each a k16
//    step) of the next stage, two table reads and four prmt a variant pair,
//    while the current stage's wgmmas run;
//  - each thread forms its two rows' A fragments (the four parts, 16
//    registers a k16 step) straight from the staged code bytes and the
//    table, and its warpgroup issues seven wgmma m64n64k16 (RS) a k16
//    step (six products, jm) into three sets of 32 f32 accumulators (hi
//    hi, the rest, jm);
//    the fragments alternate between two register sets, so a step's are
//    formed while the step before it runs (ptxas reports no serialization);
//  - a run's end waits for the wgmmas and adds the two accumulators (f32)
//    into the thread's 32 f64 sums in registers.
// One CTA an SM (255 registers a thread, none spilled).  What sets the time
// (tools/grm_breakdown.py, PERF.md): the fragment formation and plane decode,
// the wgmmas and the stage loop (copies, table, barriers) add up rather than
// overlap: with two warps an SM sub-partition, in step with each other,
// little hides the latency of each; longer stages (64 -> 128 variants)
// halve the barriers and table builds a variant.
// K8_CUT_{DECODE,WGMMA,JM,FLUSH} leave one part out, for
// tools/grm_breakdown.py's timings only (the sums are then wrong).
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kRun = 128;       // variants an f32 run
constexpr int kKT = 128;        // variants a stage
constexpr int kSteps = kKT / 16; // k16 steps a stage
constexpr int kWgs = 2;         // warpgroups a CTA
constexpr int kRowsCta = 64 * kWgs;  // row samples a CTA (wgmma M = 64 each)
constexpr int kCols = 64;        // column samples a CTA (wgmma N)
constexpr int kThreads = 128 * kWgs;
constexpr int kNst = 4;          // ring stages
constexpr int kRowBytes = kRowsCta / 4;  // code bytes of a variant's rows
// their shared stride: 16-byte pieces, the A fragments' word reads (variants
// 2q, 2q + 8) on distinct banks
constexpr int kRowStride = 48;
constexpr int kColBytes = kCols / 4;
// a ring slot: row codes [kKT][kRowStride], column codes [kKT][16], coef [kKT][3]
// f32, vmask [kKT] i8
constexpr int kSlotCol = kKT * kRowStride;
constexpr int kSlotCoef = kSlotCol + kKT * kColBytes;
constexpr int kSlotVm = kSlotCoef + kKT * 3 * 4;
constexpr int kSlotStride = (kSlotVm + kKT + 127) / 128 * 128;
static_assert(kSteps % 2 == 0 && kNst >= 3 && kRun % kKT == 0, "stage shape");
// B planes: [buffer 2][k16 step][part 4][2 KB]; part 0 hi, 1 mid, 2 lo,
// 3 missing
constexpr int kPartBytes = kCols * 16 * 2;
constexpr int kStepBytes = 4 * kPartBytes;
constexpr int kBufBytes = kSteps * kStepBytes;
constexpr int kTabBytes = kKT * 4 * 8;  // [kKT variants][4 codes] uint2
constexpr int kOffTab = 2 * kBufBytes;
constexpr int kOffRing = kOffTab + 2 * kTabBytes;
constexpr int kOffJm = kOffRing + kNst * kSlotStride;
constexpr int kSmem = kOffJm + 32 * kThreads * 4;  // + jm int32 sums [32][256]
constexpr int kJmStages = (1 << 22) / kKT;         // stages between jm flushes

struct Params {
  const uint8_t* packed;
  int64_t nb;    // code bytes a variant
  int64_t nvar;
  const int8_t* vmask;
  const float* coef;
  const int* miss;
  int64_t mv, row0, col0;
  int s, c, mode;
  int nstages, run_stages;
  bool fast;  // 16-byte cp.async copies (every source 16-byte aligned)
  void* out_val;
  void* out_cnt;
};

__device__ __forceinline__ unsigned char* slot_at(unsigned char* smem, int t) {
  return smem + kOffRing + (t % kNst) * kSlotStride;
}

// The copies of stage t into its ring slot: bytes past the tile's samples
// or the variants are zero (code 0 at coefficient 0, vmask 0).
__device__ void issue_stage(const Params& p, unsigned char* smem, int rb, int cb, int t) {
  unsigned char* slot = slot_at(smem, t);
  const int tid = threadIdx.x;
  const int64_t v0 = static_cast<int64_t>(t) * kKT;
  const int rbytes = min(kRowBytes, (p.s - rb) / 4);
  const int cbytes = min(kColBytes, (p.c - cb) / 4);
  if (p.fast) {
    // 16 bytes a copy: a variant's 32 row code bytes in two, its 16 column
    // code bytes in one, the stage's coefficients and vmask back to back
    constexpr int kRowPieces = kRowBytes / 16;
    constexpr int kRowCp = kKT * kRowPieces, kColCp = kKT, kCoefCp = kKT * 12 / 16;
    for (int i = tid; i < kRowCp + kColCp + kCoefCp + kKT / 16; i += kThreads) {
      if (i < kRowCp + kColCp) {
        const bool row = i < kRowCp;
        const int v = row ? i / kRowPieces : i - kRowCp, k = row ? (i % kRowPieces) * 16 : 0;
        const int64_t g = v0 + v;
        const int n = g < p.nvar ? max(0, min(16, (row ? rbytes : cbytes) - k)) : 0;
        const int64_t a0 = row ? (p.row0 + rb) / 4 : (p.col0 + cb) / 4;
        hop::cp_async<16>(slot + (row ? v * kRowStride : kSlotCol + v * kColBytes) + k,
                          n ? p.packed + g * p.nb + a0 + k : p.packed, n);
      } else if (i < kRowCp + kColCp + kCoefCp) {
        const int k = (i - kRowCp - kColCp) * 16;  // bytes into the stage's coef
        const int64_t rem = (p.nvar - v0) * 12 - k;
        const int n = rem <= 0 ? 0 : rem >= 16 ? 16 : static_cast<int>(rem);
        hop::cp_async<16>(slot + kSlotCoef + k,
                          n ? reinterpret_cast<const uint8_t*>(p.coef + v0 * 3) + k
                            : reinterpret_cast<const uint8_t*>(p.coef), n);
      } else {
        const int k = (i - kRowCp - kColCp - kCoefCp) * 16;
        const int64_t rem = p.nvar - v0 - k;
        const int n = rem <= 0 ? 0 : rem >= 16 ? 16 : static_cast<int>(rem);
        hop::cp_async<16>(slot + kSlotVm + k, n ? p.vmask + v0 + k : p.vmask, n);
      }
    }
    return;
  }
  // rows off 16-byte alignment: plain loads, stored before the stage is read
  for (int i = tid; i < kKT * (kRowBytes + kColBytes + 1); i += kThreads) {
    const int v = i % kKT, k = i / kKT;
    const int64_t g = v0 + v;
    const bool in_v = g < p.nvar;
    if (k < kRowBytes) {
      slot[v * kRowStride + k] =
          in_v && k < rbytes ? p.packed[g * p.nb + (p.row0 + rb) / 4 + k] : 0;
    } else if (k < kRowBytes + kColBytes) {
      const int kc = k - kRowBytes;
      slot[kSlotCol + v * kColBytes + kc] =
          in_v && kc < cbytes ? p.packed[g * p.nb + (p.col0 + cb) / 4 + kc] : 0;
    } else {
      slot[kSlotVm + v] = in_v ? p.vmask[g] : 0;
      float* cf = reinterpret_cast<float*>(slot + kSlotCoef) + 3 * v;
      cf[0] = in_v ? p.coef[3 * g] : 0.f;
      cf[1] = in_v ? p.coef[3 * g + 1] : 0.f;
      cf[2] = in_v ? p.coef[3 * g + 2] : 0.f;
    }
  }
}

// Entry e = 4 v + code of stage t's table (variant v): x = hi in the upper half, mid in the lower; y = lo upper,
// bf16 1.0 lower when the code is a missing call of a variant in vmask.
__device__ __forceinline__ void build_table(unsigned char* smem, int t) {
  const unsigned char* slot = slot_at(smem, t);
  for (int e = threadIdx.x; e < kKT * 4; e += kThreads) {
    const int v = e >> 2, code = e & 3;
    const float z =
        code == 3 ? 0.f : reinterpret_cast<const float*>(slot + kSlotCoef)[3 * v + code];
    uint32_t hi, mid, lo;
    hop::split_bf16x3(z, hi, mid, lo);
    const bool m = code == 3 && slot[kSlotVm + v] != 0;
    reinterpret_cast<uint2*>(smem + kOffTab + (t & 1) * kTabBytes)[e] =
        make_uint2(hi | (mid >> 16), lo | (m ? 0x3F80u : 0u));
  }
}

// Two variants' table entries as one register of each part (the lower
// variant in the lower half).
__device__ __forceinline__ void pack_pair(uint2 e0, uint2 e1, uint32_t& hi, uint32_t& mid,
                                          uint32_t& lo, uint32_t& m) {
  hi = __byte_perm(e0.x, e1.x, 0x7632);
  mid = __byte_perm(e0.x, e1.x, 0x5410);
  lo = __byte_perm(e0.y, e1.y, 0x7632);
  m = __byte_perm(e0.y, e1.y, 0x5410);
}

// This thread's chunks of stage t's B planes: chunk ch (column ch % 64,
// variants 8 ((ch / 64) % 2) .. + 7 of k16 step ch / 128) for ch = tid,
// tid + 256, ...
__device__ __forceinline__ void decode_b(unsigned char* smem, int t) {
  const uint2* tb = reinterpret_cast<const uint2*>(smem + kOffTab + (t & 1) * kTabBytes);
#pragma unroll 1
  for (int ch = threadIdx.x; ch < 128 * kSteps; ch += kThreads) {
    const int n = ch & 63, kh = (ch >> 6) & 1, ks = ch >> 7;
    const unsigned char* cols = slot_at(smem, t) + kSlotCol + (n >> 4) * 4;
    const int sh = 2 * (n & 15);
    uint32_t o[4][4];
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      const int v = ks * 16 + kh * 8 + 2 * jp;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(cols + v * kColBytes);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(cols + (v + 1) * kColBytes);
      pack_pair(tb[v * 4 + ((w0 >> sh) & 3)], tb[(v + 1) * 4 + ((w1 >> sh) & 3)],
                o[0][jp], o[1][jp], o[2][jp], o[3][jp]);
    }
    unsigned char* dst = smem + (t & 1) * kBufBytes + ks * kStepBytes + (n >> 3) * 256 +
                         kh * 128 + (n & 7) * 16;
#pragma unroll
    for (int pt = 0; pt < 4; ++pt)
      *reinterpret_cast<uint4*>(dst + pt * kPartBytes) =
          make_uint4(o[pt][0], o[pt][1], o[pt][2], o[pt][3]);
  }
}

// The A fragments of k16 step ks of stage t for rows r1 = 64 g + 16 w + l/4
// and r2 = r1 + 8 (`wofs` = the byte of their code word, `sh` = r1's field):
// register j = 2 h + (row r2), variants 2q + 8h and + 1.
__device__ __forceinline__ void form_a(const unsigned char* smem, int t, int ks, int wofs,
                                       int sh, int q, uint32_t (&a)[4][4]) {
#ifdef K8_CUT_DECODE  // the fragments read whole from a fixed place
#pragma unroll
  for (int pt = 0; pt < 4; ++pt) {
    const uint4 w =
        reinterpret_cast<const uint4*>(smem + kOffTab)[(threadIdx.x & 31) + (ks + 3) * pt];
    a[pt][0] = w.x;
    a[pt][1] = w.y;
    a[pt][2] = w.z;
    a[pt][3] = w.w;
  }
  return;
#endif
  const unsigned char* rows = slot_at(const_cast<unsigned char*>(smem), t) + wofs;
  const uint2* tb = reinterpret_cast<const uint2*>(smem + kOffTab + (t & 1) * kTabBytes);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int v = ks * 16 + 2 * q + 8 * h;
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(rows + v * kRowStride);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(rows + (v + 1) * kRowStride);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int f = sh + 16 * rr;
      pack_pair(tb[v * 4 + ((w0 >> f) & 3)], tb[(v + 1) * 4 + ((w1 >> f) & 3)],
                a[0][2 * h + rr], a[1][2 * h + rr], a[2][2 * h + rr], a[3][2 * h + rr]);
    }
  }
}

__device__ __forceinline__ void fence_frag(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int pt = 0; pt < 4; ++pt)
#pragma unroll
    for (int j = 0; j < 4; ++j) hop::fence_operand(a[pt][j]);
}

// One k16 step: hi hi into `big`, the other five part pairs into
// `small`, the missing planes into `jm`.  d[pt] describes B plane pt of the
// step.
__device__ __forceinline__ void step_products(float (&big)[32], float (&small)[32],
                                         float (&jm)[32], uint32_t (&a)[4][4],
                                         uint32_t b0) {
#ifndef K8_CUT_WGMMA
  const uint64_t d[3] = {hop::desc_kmajor(b0, 128, 256),
                         hop::desc_kmajor(b0 + kPartBytes, 128, 256),
                         hop::desc_kmajor(b0 + 2 * kPartBytes, 128, 256)};
  hop::wgmma_m64n64k16_bf16_rs(big, a[0], d[0]);
  hop::wgmma_m64n64k16_bf16_rs(small, a[0], d[1]);
#ifndef K8_CUT_JM
  hop::wgmma_m64n64k16_bf16_rs(jm, a[3], hop::desc_kmajor(b0 + 3 * kPartBytes, 128, 256));
#endif
  hop::wgmma_m64n64k16_bf16_rs(small, a[1], d[0]);
  hop::wgmma_m64n64k16_bf16_rs(small, a[1], d[1]);
  hop::wgmma_m64n64k16_bf16_rs(small, a[0], d[2]);
  hop::wgmma_m64n64k16_bf16_rs(small, a[2], d[0]);
#else
  big[0] += __uint_as_float(a[0][0] ^ a[1][1] ^ a[2][2] ^ b0);
  small[0] += __uint_as_float(a[0][1] ^ a[1][2] ^ a[2][3] ^ a[0][3]);
  jm[0] += __uint_as_float(a[3][0] ^ a[3][1] ^ a[3][2] ^ a[3][3]);
#endif
}

// mode 0: chunk (g f32, nm f32); mode 1/2: tile (acc f64 / f32, nm int32).
__global__ void __launch_bounds__(kThreads, 1) grm_gram_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  int* jm_sum = reinterpret_cast<int*>(smem + kOffJm);  // [i][tid]
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int q = lane & 3, r = lane >> 2;
  const int rb = blockIdx.y * kRowsCta, cb = blockIdx.x * kCols;
  const int wofs = (4 * wg + warp) * 4, sh = 2 * r;
  const uint32_t bplanes = hop::smem_u32(smem);

  float big[32], small[32], jm[32];
  double acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    big[i] = small[i] = jm[i] = 0.f;
    acc[i] = 0.0;
    jm_sum[i * kThreads + tid] = 0;
  }

  const int ns = p.nstages;
  for (int t = 0; t < kNst - 1; ++t) {
    if (t < ns) issue_stage(p, smem, rb, cb, t);
    hop::cp_async_commit();
  }
  hop::cp_async_wait<kNst - 2>();
  __syncthreads();
  build_table(smem, 0);
  __syncthreads();
#ifndef K8_CUT_DECODE
  decode_b(smem, 0);
#endif
  hop::fence_proxy_async();

  uint32_t a0[4][4] = {}, a1[4][4] = {};
  int jm_from = 0;  // the stage jm's f32 sums start from
  // runs of run_stages stages, the f64 flush after each run's loop: ptxas
  // (CUDA 12.9) crashed on the same flush as a conditional inside one loop
  for (int t0 = 0; t0 < ns; t0 += p.run_stages) {
    const int t1 = min(t0 + p.run_stages, ns);
    for (int t = t0; t < t1; ++t) {
      // stage t + 1's copies are in, stage t's planes and table are
      // written, and every thread is past stage t - 1's decode
      hop::cp_async_wait<kNst - 3>();
      __syncthreads();
      if (t + kNst - 1 < ns) issue_stage(p, smem, rb, cb, t + kNst - 1);
      hop::cp_async_commit();
      const bool more = t + 1 < ns;
      if (more) build_table(smem, t + 1);
      const uint32_t b0 = bplanes + (t & 1) * kBufBytes;
      // each k16 step's fragments are formed while the step before it
      // runs: wait until only the last group is in flight (the one that
      // reads the other fragment registers)
#pragma unroll
      for (int ks = 0; ks < kSteps; ks += 2) {
        hop::wgmma_wait<1>();
        fence_frag(a0);
        form_a(smem, t, ks, wofs, sh, q, a0);
        fence_frag(a0);
        hop::wgmma_fence();
        step_products(big, small, jm, a0, b0 + ks * kStepBytes);
        hop::wgmma_commit();
        hop::wgmma_wait<1>();
        fence_frag(a1);
        form_a(smem, t, ks + 1, wofs, sh, q, a1);
        fence_frag(a1);
        hop::wgmma_fence();
        step_products(big, small, jm, a1, b0 + (ks + 1) * kStepBytes);
        hop::wgmma_commit();
      }
      // stage t + 1's table is written, and every warpgroup is done with
      // stage t - 1's planes, whose buffer stage t + 1's take
      __syncthreads();
#ifndef K8_CUT_DECODE
      if (more) decode_b(smem, t + 1);
#endif
      hop::fence_proxy_async();
    }
    hop::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      hop::fence_operand(big[i]);
      hop::fence_operand(small[i]);
      hop::fence_operand(jm[i]);
    }
    // the run's end: its two f32 sums into f64
#ifndef K8_CUT_FLUSH
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc[i] += static_cast<double>(big[i] + small[i]);
      big[i] = small[i] = 0.f;
    }
#endif
    if (t1 - jm_from > kJmStages - p.run_stages || t1 == ns) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        jm_sum[i * kThreads + tid] += __float2int_rn(jm[i]);
        jm[i] = 0.f;
      }
      jm_from = t1;
    }
  }
#ifdef K8_CUT_FLUSH
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = static_cast<double>(big[i] + small[i]);
#endif

  // element i: row 16 warp + l/4 + 8 ((i / 2) % 2) of the warpgroup's 64,
  // column 8 (i / 4) + 2 q + i % 2
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = rb + 64 * wg + 16 * warp + r + 8 * ((i >> 1) & 1);
    const int col = cb + 8 * (i >> 2) + 2 * q + (i & 1);
    if (row >= p.s || col >= p.c) continue;
    const int mi = p.miss[p.row0 + row], mj = p.miss[p.col0 + col];
    const int64_t o = static_cast<int64_t>(row) * p.c + col;
    const int jq = jm_sum[i * kThreads + tid];
    if (p.mode == 0) {
      // _grm_chunk_finish: (Mv - m_i - m_j) + jm in f64, then acc / nm
      const double nm = __dadd_rn(__dsub_rn(__dsub_rn(static_cast<double>(p.mv),
                                                      static_cast<double>(mi)),
                                            static_cast<double>(mj)),
                                  static_cast<double>(jq));
      static_cast<float*>(p.out_val)[o] = __double2float_rn(__ddiv_rn(acc[i], nm));
      static_cast<float*>(p.out_cnt)[o] = static_cast<float>(nm);
    } else {
      if (p.mode == 1)
        static_cast<double*>(p.out_val)[o] = acc[i];
      else
        static_cast<float*>(p.out_val)[o] = __double2float_rn(acc[i]);
      static_cast<int*>(p.out_cnt)[o] = static_cast<int>(p.mv - mi - mj + jq);
    }
  }
}

}  // namespace

// packed [nvar, nb_bytes] u8 (the [nb, vb, NB] blocks, flattened); vmask
// [nvar] i8; coef [nvar, 3] f32; miss [npad] i32 (K5's per-sample missing
// counts over vmask); mv = variants in vmask.  The tile is samples [row0,
// row0 + s) x [col0, col0 + c), both inside the packed rows, row0, col0, s
// and c multiples of 4.  Mode 0: g f32 and nm f32 [s, c]; mode 1: acc f64
// and nm int32; mode 2: acc f32 and nm int32.
PT_EXPORT int pt_grm_gram(const void* packed, long long nb_bytes, long long nvar,
                          const void* vmask, const void* coef, const void* miss,
                          long long mv, long long row0, int s, long long col0,
                          int c, int mode, void* out_val, void* out_cnt,
                          void* stream) {
  if (s <= 0 || c <= 0) return cudaSuccess;
  if (mode < 0 || mode > 2 || row0 % 4 || col0 % 4 || s % 4 || c % 4)
    return cudaErrorInvalidValue;
  Params p{};
  p.packed = static_cast<const uint8_t*>(packed);
  p.nb = nb_bytes;
  p.nvar = nvar;
  p.vmask = static_cast<const int8_t*>(vmask);
  p.coef = static_cast<const float*>(coef);
  p.miss = static_cast<const int*>(miss);
  p.mv = mv;
  p.row0 = row0;
  p.col0 = col0;
  p.s = s;
  p.c = c;
  p.mode = mode;
  p.nstages = static_cast<int>(std::max<long long>(1, (nvar + kKT - 1) / kKT));
  p.run_stages = kRun / kKT;
  p.fast = nb_bytes % 16 == 0 && row0 % 64 == 0 && col0 % 64 == 0 &&
           reinterpret_cast<uintptr_t>(packed) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(vmask) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(coef) % 16 == 0;
  p.out_val = out_val;
  p.out_cnt = out_cnt;
  auto kernel = grm_gram_kernel;
  const int smem = kSmem;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((c + kCols - 1) / kCols, (s + kRowsCta - 1) / kRowsCta);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
