// K7 king_gram: KING-robust counters and kinship of one sample tile, summed
// over every variant in one launch, as int8 plane Grams on the tensor cores.
//
// Replaces (plink_tpu/ops/pairwise.py) `king_gram_tile` (:60), the int8
// H/A/V plane Gram [3s, 3t] accumulated over the variant blocks, and
// `king_tile_stats` (:173), the counters, f64 kinship, lower-triangle +
// filter mask and pass count computed from it.  The [3s, 3t] Gram never
// exists here: five plane products give the counters directly.
//
// Three int8 planes per sample and variant, each 0 where the call is
// missing or the variant masked: H = het, O = hom (REF or ALT), D = hom-ALT
// - hom-REF in {-1, 0, +1}.  For row sample i and column sample j, summed
// over the variants,
//   hethet      = H_i H_j,   het_r_hom_c = H_i O_j,   het_c_hom_r = O_i H_j
//   ibs0        = (O_i O_j - D_i D_j) / 2   (O_i O_j - D_i D_j = 2 (A_i R_j +
//                                            R_i A_j), A / R = hom-ALT / REF)
//   nsnp        = HH + HO + OH + OO,  homhom = OO - ibs0
// the same integers as plink_tpu's linear combinations of the plane Gram;
// every sum is exact in int32 (at most the variant count).
//
// Bound: operations.  Five s t V int8 multiply-adds on the tensor cores,
// 0.694 ms a 2,048 x 2,048 tile at V = 32,768 and 1,979 TOPS; the bytes
// (33.5 MB of codes in, 88 MB of outputs) 0.036 ms.
//
// Design.  The products run over variants (K), but the packed rows are
// variant-major, and Hopper's s8 wgmma takes K-major operands only.  So:
//  - king_codes_kernel writes the tile's s + t samples' 2-bit codes
//    sample-major (4 variants a byte, masked variants and samples past the
//    tile as code 3), 128 variants x 128 samples a block through shared
//    memory with a 4 x 4 transpose of 2-bit fields in a register: 33.5 MB at
//    the KING tile;
//  - king_gram_kernel takes a 128 (rows) x 64 (columns) pair tile a CTA of
//    two warpgroups (64 rows each).  Stages of 128 variants: cp.async
//    copies the 192 samples' 32 code bytes into a ring of three stages, two
//    ahead; the 256 threads decode them (one prmt per four codes and plane,
//    hop::code_plane) into the K-major H / O / D tiles of the stage, in one
//    of two buffers; each warpgroup issues per k32 step H_r x [H_c; O_c] and
//    O_r x [H_c; O_c] (m64n128k32) and D_r x D_c (m64n64k32) into 160 s32
//    accumulators a thread, and the next stage's decode runs while they do
//    (wgmma waits for the stage before).  The epilogue follows
//    king_tile_stats: kinship in f64 in the same order of operations (-inf
//    where the denominator is 0), the strict-lower-triangle and filter mask,
//    and the tile's pass count (integer atomics, exact in any order).  No
//    float atomics: two runs give identical bytes.
// K7_CUT_{COPIES,DECODE,WGMMA} leave one part of the stage out, and
// K7_CUT_GRAM the whole second kernel, for tools/gram_breakdown.py's timings
// only (a cut build's counts are wrong).
#include "common.cuh"
#include "hopper.cuh"

namespace {

// transpose pass
constexpr int kTV = 128;  // variants a block
constexpr int kTS = 128;  // samples a block

// main kernel
constexpr int kKS = 128;                  // variants a stage: four k32 steps
constexpr int kStageBytes = kKS / 4;      // code bytes a sample a stage
constexpr int kRowsT = 128;               // row samples a CTA
constexpr int kColsT = 64;                // column samples a CTA
constexpr int kSide = kRowsT + kColsT;    // staged samples
constexpr int kThreads = 256;             // two warpgroups
constexpr int kCodeStride = 48;           // bytes a staged sample (16 pad)
constexpr int kSlots = 3;                 // stages in the code ring
constexpr int kCodeSlot = kSide * kCodeStride;
constexpr int kRowPlane = kRowsT / 8 * 256;   // one plane of the rows, one k32
constexpr int kColPlane = kColsT / 8 * 256;
constexpr int kStep = 3 * kRowPlane + 3 * kColPlane;  // H, O, D rows; H, O, D cols
constexpr int kBuf = 4 * kStep;                       // a stage's planes
constexpr int kSmem = 2 * kBuf + kSlots * kCodeSlot;  // 175,104 bytes
static_assert(4 * kSide % kThreads == 0, "whole decode items a thread");
// plane tables (byte k: value for code k = hom-REF, het, hom-ALT, missing)
constexpr uint32_t kTabH = 0x00000100u;  // 0, 1, 0, 0
constexpr uint32_t kTabO = 0x00010001u;  // 1, 0, 1, 0
constexpr uint32_t kTabD = 0x000100FFu;  // -1, 0, +1, 0

// codes_t [s128 + t128][vbytes]: row k < s128 holds row sample k, row
// s128 + k column sample k; byte b of a row holds variants 4b..4b+3 (2 bits
// each, pgen order), code 3 for a masked variant, a variant past nvar or a
// sample past the tile.
__global__ void __launch_bounds__(256)
king_codes_kernel(const uint8_t* __restrict__ packed, int64_t nb_bytes, int64_t nvar,
                  const int8_t* __restrict__ vmask, int64_t row0, int s, int64_t col0,
                  int t, int s128, int64_t vbytes, uint8_t* __restrict__ codes_t) {
  __shared__ __align__(16) uint32_t in[kTS / 16][kTV + 4];  // [16-sample word][variant]
  __shared__ __align__(16) uint8_t out[kTS][kTV / 4];       // [sample][variant byte]
  const int tid = threadIdx.x;
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * kTV;
  const int k0 = blockIdx.y * kTS;  // first row of codes_t
  const bool is_row = k0 < s128;
  const int kk0 = is_row ? k0 : k0 - s128;  // first sample within its side
  const int len = is_row ? s : t;
  const int64_t first = (is_row ? row0 : col0) + kk0;  // packed sample index
  const bool aligned = ((nb_bytes & 3) == 0) && ((first & 15) == 0) &&
                       ((reinterpret_cast<uintptr_t>(packed) & 3) == 0);
  for (int e = tid; e < kTV * (kTS / 16); e += 256) {
    const int vi = e >> 3, w = e & 7;  // eight threads read a row's 32 bytes
    const int64_t v = v0 + vi;
    uint32_t x = 0xFFFFFFFFu;
    if (v < nvar && vmask[v] != 0 && kk0 + 16 * w < len)
      x = load_codes16(packed + v * nb_bytes, nb_bytes, first + 16 * w, aligned);
    in[w][vi] = x;
  }
  __syncthreads();
  {
    // variants 4 vg..4 vg + 3, samples 16 sg..16 sg + 15
    const int vg = tid & 31, sg = tid >> 5;
    const uint4 w4 = *reinterpret_cast<const uint4*>(&in[sg][4 * vg]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // byte i of x: samples 16 sg + 4j..+3 of variant 4 vg + i
      const uint32_t sel = j | ((4 + j) << 4);
      uint32_t x = __byte_perm(__byte_perm(w4.x, w4.y, sel), __byte_perm(w4.z, w4.w, sel),
                               0x5410);
      // transpose the 4 x 4 matrix of 2-bit fields: byte k of x then holds
      // sample 16 sg + 4j + k of the four variants
      uint32_t d = ((x >> 6) ^ x) & 0x00CC00CCu;
      x ^= d ^ (d << 6);
      d = ((x >> 12) ^ x) & 0x0000F0F0u;
      x ^= d ^ (d << 12);
#pragma unroll
      for (int k = 0; k < 4; ++k) out[16 * sg + 4 * j + k][vg] = (x >> (8 * k)) & 0xFFu;
    }
  }
  __syncthreads();
  const int r = tid >> 1, h = tid & 1;
  uint4 o = *reinterpret_cast<const uint4*>(&out[r][16 * h]);
  if (kk0 + r >= len) o = make_uint4(~0u, ~0u, ~0u, ~0u);
  *reinterpret_cast<uint4*>(codes_t + (k0 + r) * vbytes + v0 / 4 + 16 * h) = o;
}

// this thread's copies of stage `st` into its ring slot: 192 samples x 2
// pieces of 16 bytes
__device__ __forceinline__ void issue_stage(const uint8_t* __restrict__ codes_t,
                                            int64_t vbytes, int s128, int rb, int cb,
                                            int st, uint8_t* ring, int tid) {
  uint8_t* slot = ring + (st % kSlots) * kCodeSlot;
  for (int e = tid; e < 2 * kSide; e += kThreads) {
    const int r = e >> 1, h = e & 1;
    const int64_t row = r < kRowsT ? rb + r : s128 + cb + (r - kRowsT);
    hop::cp_async<16>(slot + r * kCodeStride + 16 * h,
                      codes_t + row * vbytes + static_cast<int64_t>(st) * kStageBytes + 16 * h);
  }
}

// decode stage `st`'s codes into the H / O / D tiles of `buf` (four k32
// steps): three items a thread, each one sample's 32 variants of one k32
// step; quarter-warps write whole core matrices (conflict-free)
__device__ __forceinline__ void decode_stage(const uint8_t* ring, int st, uint8_t* buf,
                                             int tid) {
  const uint8_t* slot = ring + (st % kSlots) * kCodeSlot;
  constexpr int kItems = 4 * kSide / kThreads;
  uint2 cw[kItems];
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const int e = tid + m * kThreads, r = e % kSide, ks = e / kSide;
    cw[m] = *reinterpret_cast<const uint2*>(slot + r * kCodeStride + 8 * ks);
  }
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const int e = tid + m * kThreads, r = e % kSide, ks = e / kSide;
    const bool col = r >= kRowsT;
    const int pstride = col ? kColPlane : kRowPlane;
    uint8_t* base = buf + ks * kStep + (col ? 3 * kRowPlane : 0) +
                    hop::s8_off(col ? r - kRowsT : r, 0);
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {  // variants 32 ks + 16 kc..+15
      uint32_t sel[4];
      hop::code_selectors(kc ? cw[m].y : cw[m].x, sel);
      uint8_t* dst = base + kc * 128;
      *reinterpret_cast<uint4*>(dst) = hop::code_plane(sel, kTabH);
      *reinterpret_cast<uint4*>(dst + pstride) = hop::code_plane(sel, kTabO);
      *reinterpret_cast<uint4*>(dst + 2 * pstride) = hop::code_plane(sel, kTabD);
    }
  }
}

// mode 0 (stats): kin f64, nsnp / hethet / ibs0 i32, pass u8 [s, t] and the
// pass count; mode 1 (counters): cnt i32 [6][s][t] = ibs0, hethet,
// het_r_hom_c, het_c_hom_r, homhom, nsnp.
__global__ void __launch_bounds__(kThreads, 1)
king_gram_kernel(const uint8_t* __restrict__ codes_t, int64_t vbytes, int nstages,
                 int s128, int s, int t, int64_t row0, int64_t col0, int64_t n,
                 double thresh, int mode, double* __restrict__ kin,
                 int* __restrict__ nsnp_out, int* __restrict__ hethet_out,
                 int* __restrict__ ibs0_out, uint8_t* __restrict__ pass_out,
                 int* __restrict__ pass_ct, int* __restrict__ cnt_out) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* planes = smem;            // two buffers of kBuf
  uint8_t* ring = smem + 2 * kBuf;   // kSlots stages of codes
  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // rows 64 wg..64 wg + 63 of the CTA's
  const int rb = blockIdx.y * kRowsT, cb = blockIdx.x * kColsT;
  int acc_h[64], acc_o[64], acc_d[32];  // H_r, O_r x [H_c; O_c]; D_r x D_c
#pragma unroll
  for (int i = 0; i < 64; ++i) acc_h[i] = acc_o[i] = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_d[i] = 0;

  for (int st = 0; st < 2; ++st) {
    if (st < nstages) issue_stage(codes_t, vbytes, s128, rb, cb, st, ring, tid);
    hop::cp_async_commit();
  }
  const uint32_t pbase = hop::smem_u32(planes);
  for (int st = 0; st < nstages; ++st) {
    // stage st's codes are in, and both warpgroups' wgmmas of stage st - 2
    // (the last readers of this stage's plane buffer) are done
    hop::cp_async_wait<1>();
    hop::wgmma_wait<1>();
    __syncthreads();
#ifndef K7_CUT_COPIES
    if (st + 2 < nstages) issue_stage(codes_t, vbytes, s128, rb, cb, st + 2, ring, tid);
#endif
    hop::cp_async_commit();
#ifndef K7_CUT_DECODE
    decode_stage(ring, st, planes + (st & 1) * kBuf, tid);
#endif
    hop::fence_proxy_async();
    __syncthreads();
    hop::wgmma_fence();
#ifndef K7_CUT_WGMMA
    const uint32_t b = pbase + (st & 1) * kBuf;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint32_t k0 = b + ks * kStep;
      const uint32_t a0 = k0 + wg * (kRowPlane / 2);
      const uint64_t dc = hop::desc_s8(k0 + 3 * kRowPlane);
      hop::wgmma_m64n128k32_s8_ss(acc_h, hop::desc_s8(a0), dc);
      hop::wgmma_m64n128k32_s8_ss(acc_o, hop::desc_s8(a0 + kRowPlane), dc);
      hop::wgmma_m64n64k32_s8_ss(acc_d, hop::desc_s8(a0 + 2 * kRowPlane),
                                 hop::desc_s8(k0 + 3 * kRowPlane + 2 * kColPlane));
    }
#endif
    hop::wgmma_commit();
  }
  hop::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    hop::fence_operand(acc_h[i]);
    hop::fence_operand(acc_o[i]);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) hop::fence_operand(acc_d[i]);

  // element i < 32 of each block: row 64 wg + 16 warp + lane / 4 + 8 ((i / 2)
  // % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2; acc_h / acc_o element i +
  // 32 is the same pair against O_c
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  int passed = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = rb + 64 * wg + 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
    const int c = cb + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    if (r >= s || c >= t) continue;
    const int hh = acc_h[i], h12 = acc_h[i + 32], h21 = acc_o[i];
    const int ib = (acc_o[i + 32] - acc_d[i]) >> 1;
    const int ns = hh + h12 + h21 + acc_o[i + 32];
    const int64_t o = static_cast<int64_t>(r) * t + c;
    if (mode == 1) {
      const int64_t st = static_cast<int64_t>(s) * t;
      cnt_out[o] = ib;
      cnt_out[st + o] = hh;
      cnt_out[2 * st + o] = h12;
      cnt_out[3 * st + o] = h21;
      cnt_out[4 * st + o] = acc_o[i + 32] - ib;
      cnt_out[5 * st + o] = ns;
      continue;
    }
    // king_tile_stats' order: f64 from the start (4 * ibs0 can pass int32)
    const double smaller = static_cast<double>(hh) + static_cast<double>(min(h12, h21));
    const double num = __dadd_rn(__dadd_rn(__dmul_rn(4.0, static_cast<double>(ib)),
                                           static_cast<double>(h12)),
                                 static_cast<double>(h21));
    const double k = __dsub_rn(0.5, __ddiv_rn(num, __dmul_rn(4.0, smaller)));
    const int64_t gr = row0 + r, gc = col0 + c;
    const bool ok = gr > gc && gr < n && gc < n && k >= thresh;
    kin[o] = k;
    nsnp_out[o] = ns;
    hethet_out[o] = hh;
    ibs0_out[o] = ib;
    pass_out[o] = ok ? 1 : 0;
    passed += ok;
  }
  if (mode == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) passed += __shfl_down_sync(0xffffffffu, passed, off);
    if (lane == 0 && passed) atomicAdd(pass_ct, passed);
  }
}

}  // namespace

// packed [nvar, nb_bytes] u8 (the [nb, vb, NB] blocks, flattened); vmask
// [nvar] i8; the tile is samples [row0, row0 + s) x [col0, col0 + t), both
// inside the packed rows.  codes: u8 scratch of (s128 + t128) * vbytes
// bytes, s128 / t128 = s / t rounded up to 128, vbytes = nvar rounded up to
// 128, over 4.  Mode 0 writes kin / nsnp / hethet / ibs0 / pass [s, t] and
// adds the tile's pass count to *pass_ct (zeroed by the caller); mode 1
// writes cnt [6, s, t].
PT_EXPORT int pt_king_gram(const void* packed, long long nb_bytes, long long nvar,
                           const void* vmask, long long row0, int s,
                           long long col0, int t, long long n, double thresh,
                           int mode, void* codes, void* kin, void* nsnp,
                           void* hethet, void* ibs0, void* pass, void* pass_ct,
                           void* cnt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s <= 0 || t <= 0) return cudaSuccess;
  const int s128 = (s + kTS - 1) / kTS * kTS;
  const int t128 = (t + kTS - 1) / kTS * kTS;
  const int64_t nstages = (nvar + kKS - 1) / kKS;
  const int64_t vbytes = nstages * kStageBytes;
  if (nstages == 0 || nstages > (1 << 30)) return cudaErrorInvalidValue;
  const dim3 g1(static_cast<unsigned>(nstages), (s128 + t128) / kTS);
  king_codes_kernel<<<g1, 256, 0, st>>>(
      static_cast<const uint8_t*>(packed), nb_bytes, nvar,
      static_cast<const int8_t*>(vmask), row0, s, col0, t, s128, vbytes,
      static_cast<uint8_t*>(codes));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
#ifdef K7_CUT_GRAM
  return cudaSuccess;
#endif
  err = cudaFuncSetAttribute(king_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return err;
  const dim3 g2((t + kColsT - 1) / kColsT, (s + kRowsT - 1) / kRowsT);
  king_gram_kernel<<<g2, kThreads, kSmem, st>>>(
      static_cast<const uint8_t*>(codes), vbytes, static_cast<int>(nstages), s128, s, t,
      row0, col0, n, thresh, mode, static_cast<double*>(kin), static_cast<int*>(nsnp),
      static_cast<int*>(hethet), static_cast<int*>(ibs0),
      static_cast<uint8_t*>(pass), static_cast<int*>(pass_ct),
      static_cast<int*>(cnt));
  return cudaGetLastError();
}
