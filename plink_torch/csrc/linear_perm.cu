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
// `_plane_cols` forms them.
//
// Exact on the tensor cores.  Every term is A_r(v, s) * Z_r(s, b): A_r is
// the variant's weight of its 2-bit code (w = (1, 1, 1, 0) for the dc
// covariate rows and the yy row, w = (wV, wH + wV, wA + wV, 0) for genotype
// row p), a small integer (0, +-1, +-2 for every model the permutation
// paths build), exact in bf16 (the wrapper checks); Z_r = mask Y c_j, mask
// Y^2, or mask Y c_covj sscale is one f32 rounding of the same products
// the plain version forms.  An f32 is the exact sum of three bf16 parts
// (`hop::split_bf16x3`), so each product A_r * Z_part is exact in a bf16
// wgmma and only the f32 accumulation rounds, as in an FP32 kernel: no TF32
// and no bf16 rounding of a value plink_tpu carries at HIGHEST.
//
// Bound: operations.  2 * vb * npad * (dc + P + 1) * B flops, 3.77e12 at
// 2,048 variants x 500,000 samples x 14 rows x 134 permutations: 56.2 ms at
// the FP32 rate (67 TFLOP/s), and three bf16 products per term 11.4 ms at
// the dense bf16 rate (989 TFLOP/s); the bytes (256 MB of codes, 268 MB of
// Y) take 0.16 ms.
//
// Design (the transposed product D^T = Z^T A^T: the operand built per
// permutation is the register operand, the one shared by every output
// column the shared-memory operand).  The output columns are tiled by 64
// (wgmma M): the dc + 1 valid-plane rows of every permutation flattened
// b-major (column b (dc + 1) + j; j = dc is yy), then each genotype row's B
// columns.  A CTA is one warpgroup: 128 variants (wgmma N) by one column
// tile, streaming every sample in stages of 32 (two k16 steps):
//  - cp.async copies the stage's code bytes, mask, sscale, the tile's Y
//    columns and c's rows into a ring of 2-3 stages, two ahead; each
//    thread's sources are fixed once (`Copier`), so a stage inside the
//    samples costs a few instructions a copy (the ragged last one takes a
//    checked path); B is a multiple of 4 and Y and c are 16-byte aligned
//    (the entry point refuses anything else), so Y's rows and c's row
//    blocks go in 16-byte pieces;
//  - the 128 threads decode the stage's codes into the plane w[code] (bf16,
//    K-major, 8 KB): one PRMT per pair of codes from the variant's weights;
//  - each thread forms its two tile rows' Z^T values (mask Y c_j, or Y^2;
//    three bf16 parts) in the A fragment's registers, and the warpgroup
//    issues 3 wgmma m64n128k16 per k16 step into one set of f32
//    accumulators, then waits for them: ptxas serializes the wgmmas of a
//    warpgroup whose register operands are written while any of its wgmmas
//    are in flight, so two CTAs share an SM (about 105 KB of shared memory
//    each) and one's decode and Z formation run while the other's wgmmas
//    do.
// What held the SIMT design back, and what this one does about it:
//  - FP32 on the CUDA cores: the products run on the tensor cores, bounded
//    at 11.4 ms instead of 56.2 ms;
//  - 80 B of shared loads per 64 FMAs: a wgmma reads its 128 x 16 bf16 B
//    tile once for 64 x 128 x 16 products, and Z never touches shared
//    memory;
//  - 30% idle permutation lanes (tiles of 64 over B = 134) and 12.5% idle
//    rows: the valid-plane columns run flattened over (b, j), so only the
//    last tile of each kind is ragged (1,876 columns run as 1,984 at P = 1);
//  - 256 passes over Y: each CTA reads only its tile's Y columns (about 8 of
//    the 136 for a valid-plane tile, 64 for a genotype tile), about 5 GB at
//    P = 1 against up to 69 GB;
//  - 8 warps an SM: still 8 (two CTAs of one warpgroup), which with the
//    stage's copies, decode and Z formation on the same threads leaves the
//    tensor cores idle most of the time (PERF.md has the measured split).
// Summation: the f32 accumulators hold one `split_len`-sample run (512
// from the wrapper: the tensor cores truncate as they add, so a run of
// positive terms drifts low with its length); at each run's end they are
// added into per-thread f64 sums in shared memory (64 KB), so runs add in
// f64 in index order: no float atomics, and two runs give identical bytes.
//
// K20 computes, per (variant, permutation): beta = inv xty, rss = yy -
// beta . xty, sigma^2 = rss / max(nm - d, 1), and either t = beta_tc /
// sqrt(max(sigma^2 inv_tc,tc, 0)) (q = 0) or the joint F = ((rss0 - rss) /
// q) / max(sigma^2, 1e-30) from the reduced design's inverse inv0 over the
// rows [0, dc) and [dc + q, d) (q > 0).  It takes the f32 inputs in f64 and
// rounds the statistic to f32: rss and rss0 are differences of sums of
// size yy, so plink_tpu's f32 arithmetic there (which the plain version
// keeps) leaves an absolute rounding of ~n eps / q in F; here only the
// inputs' own rounding is left.  A NaN inverse (a singular design) gives
// NaN, as there.  Bound: bytes (inv, inv0, xty, yy, nm read once, the
// statistic written), 5.7 us at d = 13 and B = 134 over 2,048 variants;
// its d^2 + d0^2 f64 FMAs a thread take about as long at the FP64 rate.
// Design: one CTA a variant, its threads the permutations (B rounded up to
// a warp, at most 256 threads a CTA: at B = 134, 160 threads, 26 idle
// lanes where a grid of 128-thread blocks ran 122); the variant's inverses
// are staged in shared memory once, converted to f64 there (an f32 to f64
// conversion runs at 16 a clock an SM, a quarter of the FP64 rate, and
// converting each entry at each use set the old kernel's pace), and read
// as 16-byte broadcasts; each thread holds its column of xty in registers,
// read once, coalesced across the warp, the loops unrolled over 16 or 32
// with uniform guards, and at 16 < d <= 32 takes two permutations, so each
// broadcast read serves two columns (tools/grm_breakdown.py measures it
// beside torch.bmm).  Above d = 32 a generic loop reads the inverses and
// xty from device memory as needed.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kKT = 32;        // samples per stage: two k16 steps
constexpr int kNV = 128;       // variants per CTA (wgmma N)
constexpr int kRows = 64;      // output columns per tile (wgmma M)
constexpr int kThreads = 128;  // one warpgroup
constexpr int kCodeBytes = kNV * (kKT / 4);
constexpr int kPlaneBytes = 2 * kNV * 16 * 2;  // a stage's plane: 8 KB
constexpr int kAccBytes = kRows * kNV * 8;     // f64 sums: 64 KB
constexpr int kLutOff = kAccBytes + kPlaneBytes;
constexpr int kStageOff = kLutOff + 64;
constexpr int kStageHead = kCodeBytes + 2 * kKT * 4;  // codes, mask, sscale
// shared memory of one CTA when two share an SM (228 KB, 1 KB reserved each)
constexpr int kTwoPerSm = 115712;
constexpr int kMaxSmem = 232448;

struct Params {
  const uint8_t* packed;
  int64_t nb;
  int vb;
  const float* gw;
  int P;
  const float* c;
  int dc;
  const float* Y;
  int B;
  const float* mask;
  const int* covj;
  const float* sscale;
  float* xty;
  float* yy;
  int ntiles;         // stages over the samples
  int tiles_per_run;  // stages per f32 run
  int Tv, Tg;         // valid-plane tiles, tiles of each genotype row
  int code_w;         // bytes per code-word copy: 8, 4 or 1 (synchronous)
  int ylg_v, ylg_g;   // log2 Y copies per sample row of each kind of tile
  int ystr_v, cstr_v, ystr_g;  // shared strides (floats) of each block
  int nst;            // stages in the ring
  int stage_bytes;
};

// The CTA's column tile: which staged columns its rows read
struct Tile {
  bool geno;
  int p, q0;    // genotype row; first flattened column (valid) or b
  int blo, nY;  // staged Y columns blo..blo+nY-1
  int jb, nC;   // staged c columns: (jb + i) mod (dc + 1), i < nC (valid);
                // covj[p] when nC = 1 (genotype)
};

__device__ __forceinline__ Tile make_tile(const Params& pr, int ti) {
  Tile t;
  const int dc1 = pr.dc + 1;
  t.geno = ti >= pr.Tv;
  if (!t.geno) {
    const int Qv = dc1 * pr.B;
    t.p = 0;
    t.q0 = ti * kRows;
    const int qe = min(t.q0 + kRows, Qv) - 1;
    t.blo = t.q0 / dc1 / 4 * 4;  // aligned for 16-byte copies
    t.nY = qe / dc1 - t.blo + 1;
    t.jb = dc1 <= kRows ? 0 : t.q0 % dc1;
    t.nC = min(dc1, kRows);
  } else {
    t.p = (ti - pr.Tv) / pr.Tg;
    t.q0 = (ti - pr.Tv) % pr.Tg * kRows;
    t.blo = t.q0;
    t.nY = min(kRows, pr.B - t.q0);
    t.jb = pr.covj[t.p];
    t.nC = t.jb >= 0 ? 1 : 0;
  }
  return t;
}

// One stage's copies of the tile's Y columns: four floats a copy, 2^lg
// copies per sample row, thread `tid` always on the same columns.
__device__ __forceinline__ void copy_y(const Params& pr, const Tile& t, float* ys,
                                       int ystr, int lg, int64_t s0, int tid) {
  const int k = (tid & ((1 << lg) - 1)) * 4;
  if (k >= t.nY) return;
  const int col = t.blo + k;
  const int64_t npad = 4 * pr.nb;
  for (int s = tid >> lg; s < kKT; s += kThreads >> lg) {
    const int64_t g = s0 + s;
    const bool in = g < npad;
    hop::cp_async<16>(ys + s * ystr + k, in ? pr.Y + g * pr.B + col : pr.Y, in ? 16 : 0);
  }
}

// One stage's copy of c's rows (all dc columns, contiguous in global and
// shared memory) for a valid-plane tile, in 16-byte pieces.
__device__ __forceinline__ void copy_c_block(const Params& pr, float* cs, int64_t s0,
                                             int tid) {
  const int64_t end = 4 * pr.nb * pr.dc;  // floats of c
  const float* src = pr.c + s0 * pr.dc;
  for (int k = tid * 4; k < kKT * pr.dc; k += kThreads * 4) {
    const bool in = s0 * pr.dc + k < end;
    hop::cp_async<16>(cs + k, in ? src + k : pr.c, in ? 16 : 0);
  }
}

// One stage's copies of the tile's c columns (4 bytes each): a genotype
// tile's one column, or a valid-plane tile's window of the columns when
// dc + 1 > 64.
__device__ __forceinline__ void copy_c(const Params& pr, const Tile& t, float* cs,
                                       int cstr, int lg, int64_t s0, int tid) {
  const int i = tid & ((1 << lg) - 1);
  if (i >= t.nC) return;
  const int j = t.geno ? t.jb : (t.jb + i) % (pr.dc + 1);
  if (j >= pr.dc) return;  // the yy row's slot: read, never used
  const int64_t npad = 4 * pr.nb;
  for (int s = tid >> lg; s < kKT; s += kThreads >> lg) {
    const int64_t g = s0 + s;
    const bool in = g < npad;
    hop::cp_async<4>(cs + s * cstr + i, in ? pr.c + g * pr.dc + j : pr.c, in ? 4 : 0);
  }
}

struct Stage {
  uint8_t* codes;  // [kNV][kKT / 4]
  float* m;        // [kKT]
  float* ss;       // [kKT]
  float* ys;       // Y [kKT][ystr], then c [kKT][cstr]
};

__device__ __forceinline__ Stage stage_at(unsigned char* smem, const Params& pr, int i) {
  unsigned char* base = smem + kStageOff + i * pr.stage_bytes;
  Stage st;
  st.codes = base;
  st.m = reinterpret_cast<float*>(base + kCodeBytes);
  st.ss = st.m + kKT;
  st.ys = st.ss + kKT;
  return st;
}

// A thread's share of the copies of a stage that lies wholly inside the
// samples, fixed for the whole run: each copy's source at stage 0 and its
// place in a ring slot (stage t reads 32 t rows further on).  Stages past
// the samples' end, and rows not 4-byte aligned, take `issue_stage`.
struct Copier {
  const uint8_t* code;  // the thread's variant's code bytes, or null
  const float* m;       // mask[tid] (tid < 32) or null
  const float* ss;      // sscale[tid - 32] (32 <= tid < 64) or null
  const float* y;       // Y copies: y + j ystep -> ys[ydst + j ydstep], j < ny
  int64_t ystep;
  int ny, ydst, ydstep;
  const float* c;       // c copies: c + j cstep -> cs[cdst + j cdstep], j < nc
  int64_t cstep;
  int nc, cdst, cdstep;
};

__device__ __forceinline__ Copier make_copier(const Params& pr, const Tile& t, int vt,
                                              int tid) {
  Copier cp{};
  const int v = vt * kNV + tid;
  cp.code = v < pr.vb ? pr.packed + static_cast<int64_t>(v) * pr.nb : nullptr;
  cp.m = tid < kKT ? pr.mask + tid : nullptr;
  cp.ss = tid >= kKT && tid < 2 * kKT && pr.sscale != nullptr ? pr.sscale + tid - kKT
                                                                : nullptr;
  const int lg = t.geno ? pr.ylg_g : pr.ylg_v;
  const int ystr = t.geno ? pr.ystr_g : pr.ystr_v;
  const int k = (tid & ((1 << lg) - 1)) * 4, s = tid >> lg, step = kThreads >> lg;
  if (k < t.nY && s < kKT) {
    cp.ny = (kKT - s + step - 1) / step;
    cp.y = pr.Y + static_cast<int64_t>(s) * pr.B + t.blo + k;
    cp.ystep = static_cast<int64_t>(step) * pr.B;
    cp.ydst = s * ystr + k;
    cp.ydstep = step * ystr;
  }
  if (t.geno) {  // the covariate column of genotype row p
    if (t.nC && tid < kKT) {
      cp.nc = 1;
      cp.c = pr.c + static_cast<int64_t>(tid) * pr.dc + t.jb;
      cp.cdst = tid * 4;
    }
  } else if (pr.dc + 1 > kRows) {  // a window of 64 columns, from jb
    const int i = tid & (kRows - 1), j = (t.jb + i) % (pr.dc + 1);
    if (j < pr.dc) {
      cp.nc = kKT / 2;
      cp.c = pr.c + static_cast<int64_t>(tid >> 6) * pr.dc + j;
      cp.cstep = 2 * pr.dc;
      cp.cdst = (tid >> 6) * pr.cstr_v + i;
      cp.cdstep = 2 * pr.cstr_v;
    }
  } else {  // the stage's rows of c back to back, four floats a copy
    cp.nc = (kKT * pr.dc - tid * 4 + kThreads * 4 - 1) / (kThreads * 4);
    cp.c = pr.c + tid * 4;
    cp.cstep = kThreads * 4;
    cp.cdst = tid * 4;
    cp.cdstep = kThreads * 4;
  }
  return cp;
}

__device__ __forceinline__ void copy_y_fast(const Copier& cp, float* ys, int64_t off) {
  for (int j = 0; j < cp.ny; ++j)
    hop::cp_async<16>(ys + cp.ydst + j * cp.ydstep, cp.y + off + j * cp.ystep);
}

template <int W>
__device__ __forceinline__ void copy_c_fast(const Copier& cp, float* cs, int64_t off) {
  for (int j = 0; j < cp.nc; ++j)
    hop::cp_async<W>(cs + cp.cdst + j * cp.cdstep, cp.c + off + j * cp.cstep);
}

// The copies of stage `t` (wholly inside the samples) into ring slot `slot`.
__device__ __forceinline__ void issue_stage_fast(const Params& pr, unsigned char* smem,
                                                 const Tile& tl, const Copier& cp, int t,
                                                 int slot) {
  const Stage st = stage_at(smem, pr, slot);
  const int tid = threadIdx.x;
  const int64_t s0 = static_cast<int64_t>(t) * kKT;
  if (cp.code != nullptr) {
    uint8_t* dst = st.codes + tid * (kKT / 4);
    const uint8_t* src = cp.code + s0 / 4;
    if (pr.code_w == 8) {
      hop::cp_async<8>(dst, src);
    } else {
      hop::cp_async<4>(dst, src);
      hop::cp_async<4>(dst + 4, src + 4);
    }
  }
  if (cp.m != nullptr) hop::cp_async<4>(st.m + tid, cp.m + s0);
  if (cp.ss != nullptr) hop::cp_async<4>(st.ss + tid - kKT, cp.ss + s0);
  const int ystr = tl.geno ? pr.ystr_g : pr.ystr_v;
  const int64_t yoff = s0 * pr.B;
  copy_y_fast(cp, st.ys, yoff);
  float* cs = st.ys + kKT * ystr;
  if (!tl.geno && pr.dc + 1 <= kRows)
    copy_c_fast<16>(cp, cs, s0 * pr.dc);
  else
    copy_c_fast<4>(cp, cs, s0 * pr.dc);
}

// The copies of stage `t` (samples 32 t ..) into ring slot `slot`, with the
// samples past the end read as zeros.
__device__ void issue_stage(const Params& pr, unsigned char* smem, const Tile& tl,
                            int vt, int t, int slot) {
  const Stage st = stage_at(smem, pr, slot);
  const int tid = threadIdx.x;
  const int64_t s0 = static_cast<int64_t>(t) * kKT;
  const int64_t npad = 4 * pr.nb;
  const int v = vt * kNV + tid;  // the 128 variants' code bytes of the stage
  if (v < pr.vb) {
    const uint8_t* src = pr.packed + static_cast<int64_t>(v) * pr.nb + t * (kKT / 4);
    uint8_t* dst = st.codes + tid * (kKT / 4);
    const int64_t avail = pr.nb - static_cast<int64_t>(t) * (kKT / 4);
    if (pr.code_w == 8) {
      hop::cp_async<8>(dst, src, 8);
    } else if (pr.code_w == 4) {
      hop::cp_async<4>(dst, src, 4);
      hop::cp_async<4>(dst + 4, avail > 4 ? src + 4 : src, avail > 4 ? 4 : 0);
    } else {  // unaligned rows: plain loads, stored before the stage is read
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int b = 0; b < 8; ++b)
        if (b < avail) w[b >> 2] |= static_cast<uint32_t>(src[b]) << (8 * (b & 3));
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    }
  }
  if (tid < kKT) {
    const bool in = s0 + tid < npad;
    hop::cp_async<4>(st.m + tid, in ? pr.mask + s0 + tid : pr.mask, in ? 4 : 0);
  } else if (tid < 2 * kKT && pr.sscale != nullptr) {
    const int i = tid - kKT;
    const bool in = s0 + i < npad;
    hop::cp_async<4>(st.ss + i, in ? pr.sscale + s0 + i : pr.sscale, in ? 4 : 0);
  }
  const int ystr = tl.geno ? pr.ystr_g : pr.ystr_v;
  const int ylg = tl.geno ? pr.ylg_g : pr.ylg_v;
  copy_y(pr, tl, st.ys, ystr, ylg, s0, tid);
  float* cs = st.ys + kKT * ystr;
  if (tl.geno)
    copy_c(pr, tl, cs, 4, 0, s0, tid);
  else if (pr.dc + 1 > kRows)
    copy_c(pr, tl, cs, pr.cstr_v, 6, s0, tid);
  else
    copy_c_block(pr, cs, s0, tid);
}

// This thread's Z^T fragments of one stage: [k16 step][part][register]
struct AFrag {
  uint32_t r[2][3][4];
};

// The rows r1 = 16 warp + lane/4 and r2 = r1 + 8 of the tile: where their
// Y and c values sit in the staged block, and the yy flag.
struct RowMap {
  int yi[2], ci[2];
  bool yy[2];
};

__device__ __forceinline__ void form_z(const Tile& t, const RowMap& rm, const Stage& st,
                                       const float* cs, int ystr, int cstr, bool has_ss,
                                       int q, AFrag& a) {
  const float* ys = st.ys;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int s4[4] = {ks * 16 + 2 * q, ks * 16 + 2 * q + 1, ks * 16 + 2 * q + 8,
                       ks * 16 + 2 * q + 9};
    const float2 mA = *reinterpret_cast<const float2*>(st.m + s4[0]);
    const float2 mB = *reinterpret_cast<const float2*>(st.m + s4[2]);
    const float m4[4] = {mA.x, mA.y, mB.x, mB.y};
    float z[2][4];  // [row][sample]
    if (!t.geno) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float y = ys[s4[u] * ystr + rm.yi[rr]];
          const float cj = cs[s4[u] * cstr + rm.ci[rr]];
          const float ym = __fmul_rn(m4[u], y);  // exact: the mask is 0 or 1
          z[rr][u] = __fmul_rn(rm.yy[rr] ? y : cj, ym);
        }
    } else {
      float f4[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {  // (c_covj sscale) mask, the order K2 uses
        float f = t.nC ? cs[s4[u] * cstr] : 1.f;
        if (has_ss) f = __fmul_rn(f, st.ss[s4[u]]);
        f4[u] = __fmul_rn(f, m4[u]);
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          z[rr][u] = __fmul_rn(f4[u], ys[s4[u] * ystr + rm.yi[rr]]);
    }
    uint32_t h[2][4], md[2][4], lo[2][4];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int u = 0; u < 4; ++u) hop::split_bf16x3(z[rr][u], h[rr][u], md[rr][u], lo[rr][u]);
    // register j of a part: (row r1, k 2q..2q+1), (r2, same), (r1, k + 8), (r2, k + 8)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rr = j & 1, u = (j >> 1) * 2;
      a.r[ks][0][j] = hop::pack_bf16x2(h[rr][u], h[rr][u + 1]);
      a.r[ks][1][j] = hop::pack_bf16x2(md[rr][u], md[rr][u + 1]);
      a.r[ks][2][j] = hop::pack_bf16x2(lo[rr][u], lo[rr][u + 1]);
    }
  }
}

__device__ __forceinline__ void fence_frag(AFrag& a) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int pt = 0; pt < 3; ++pt)
#pragma unroll
      for (int j = 0; j < 4; ++j) hop::fence_operand(a.r[ks][pt][j]);
}

// One warpgroup a CTA, two CTAs an SM: a CTA waits for its own wgmmas at
// the end of each stage (ptxas serializes wgmmas whose register operands
// are written while any of the warpgroup's wgmmas are in flight), and the
// other CTA's decode and Z formation run meanwhile.
__global__ void __launch_bounds__(kThreads, 2)
linear_perm_xty_kernel(const Params pr) {
  extern __shared__ __align__(128) unsigned char smem[];
  double* acc64 = reinterpret_cast<double*>(smem);  // [i][tid]
  unsigned char* plane = smem + kAccBytes;          // [k16 step][chunk 16 B]
  uint32_t* lut = reinterpret_cast<uint32_t*>(smem + kLutOff);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int vt = blockIdx.x;
  const Tile my = make_tile(pr, blockIdx.y);
  const int ystr = my.geno ? pr.ystr_g : pr.ystr_v;
  const int cstr = my.geno ? 4 : pr.cstr_v;

  // the decode: this thread fills chunks `tid` and `tid + 128` of each k16
  // step (variants n and n + 64, samples 8 kh .. 8 kh + 7), from the
  // variant's four code weights
  const int n = ((tid >> 4) << 3) | (tid & 7), kh = (tid >> 3) & 1;
  uint32_t w01[2] = {0u, 0u}, w23[2] = {0u, 0u};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int v = vt * kNV + n + 64 * h;
    if (!my.geno) {
      w01[h] = 0x3F803F80u;  // bf16 1.0 for codes 0 and 1
      w23[h] = 0x00003F80u;  // 1.0 for code 2, 0 for missing
    } else if (v < pr.vb) {
      const float* w = pr.gw + (static_cast<int64_t>(v) * pr.P + my.p) * 3;
      // exact in bf16 (the wrapper checks): the upper halves are the bf16s
      w01[h] = (__float_as_uint(w[2]) >> 16) | (__float_as_uint(w[0] + w[2]) & 0xFFFF0000u);
      w23[h] = __float_as_uint(w[1] + w[2]) >> 16;
    }
  }
  if (tid < 16) {  // PRMT selector of a code pair (c0 low, c1 high): bytes 2c, 2c + 1
    const uint32_t c0 = tid & 3, c1 = tid >> 2;
    lut[tid] = (2 * c0) | (2 * c0 + 1) << 4 | (2 * c1) << 8 | (2 * c1 + 1) << 12;
  }

  // rows r1, r2 of this thread's fragments
  RowMap rm;
  float* out_base[2];
  int64_t out_vstride[2];
  {
    const int dc1 = pr.dc + 1, D = pr.dc + pr.P;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = 16 * warp + g + 8 * rr;
      rm.yi[rr] = rm.ci[rr] = 0;
      rm.yy[rr] = false;
      out_base[rr] = nullptr;
      out_vstride[rr] = 0;
      if (!my.geno) {
        const int qq = my.q0 + r;
        if (qq >= dc1 * pr.B) continue;
        const int b = qq / dc1, j = qq % dc1;
        rm.yi[rr] = b - my.blo;
        rm.ci[rr] = dc1 > kRows ? r : j < pr.dc ? j : 0;  // yy: any column
        rm.yy[rr] = j == pr.dc;
        out_base[rr] = j < pr.dc ? pr.xty + static_cast<int64_t>(j) * pr.B + b : pr.yy + b;
        out_vstride[rr] = j < pr.dc ? static_cast<int64_t>(D) * pr.B : pr.B;
      } else {
        const int b = my.q0 + r;
        if (b >= pr.B) continue;
        rm.yi[rr] = r;
        out_base[rr] = pr.xty + static_cast<int64_t>(pr.dc + my.p) * pr.B + b;
        out_vstride[rr] = static_cast<int64_t>(D) * pr.B;
      }
    }
  }

#pragma unroll 4
  for (int i = 0; i < kRows; ++i) acc64[i * kThreads + tid] = 0.0;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // stages wholly inside the samples, copied by the fast path
  const int nfast = pr.code_w == 1 ? 0 : static_cast<int>(pr.nb / (kKT / 4));
  const Copier cp = make_copier(pr, my, vt, tid);
  const int dist = pr.nst - 1;  // stages copied ahead
  for (int t = 0; t < dist; ++t) {
    if (t < nfast)
      issue_stage_fast(pr, smem, my, cp, t, t);
    else if (t < pr.ntiles)
      issue_stage(pr, smem, my, vt, t, t);
    hop::cp_async_commit();
  }
  const uint32_t plane_s = hop::smem_u32(plane);
  const uint64_t desc[2] = {hop::desc_kmajor(plane_s, 128, 256),
                            hop::desc_kmajor(plane_s + kPlaneBytes / 2, 128, 256)};
  const bool has_ss = pr.sscale != nullptr;
  AFrag a;

  // runs of tiles_per_run stages; at a run's end its f32 sums join the f64
  // sums, in run order.  K19_CUT_{COPIES,DECODE,FORM,WGMMA} leave one part
  // of the stage out, for tools/k19_breakdown.py's timings only (the sums
  // are then wrong).
  for (int r0 = 0; r0 < pr.ntiles; r0 += pr.tiles_per_run) {
    const int r1 = min(r0 + pr.tiles_per_run, pr.ntiles);
    for (int t = r0; t < r1; ++t) {
      // the stage's copies are in (and every thread is past the last
      // stage's reads); queue the copies `dist` stages ahead
      if (dist == 2)
        hop::cp_async_wait<1>();
      else
        hop::cp_async_wait<0>();
      __syncthreads();
      const int tn = t + dist;
#ifndef K19_CUT_COPIES
      if (tn < nfast)
        issue_stage_fast(pr, smem, my, cp, tn, tn % pr.nst);
      else if (tn < pr.ntiles)
        issue_stage(pr, smem, my, vt, tn, tn % pr.nst);
#endif
      hop::cp_async_commit();
      const Stage st = stage_at(smem, pr, t % pr.nst);
#ifndef K19_CUT_DECODE
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint2 cw2 = *reinterpret_cast<const uint2*>(st.codes + (n + 64 * h) * (kKT / 4));
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const uint32_t cw = ((ks ? cw2.y : cw2.x) >> (16 * kh)) & 0xFFFFu;
          uint4 o;
          o.x = __byte_perm(w01[h], w23[h], lut[cw & 0xF]);
          o.y = __byte_perm(w01[h], w23[h], lut[(cw >> 4) & 0xF]);
          o.z = __byte_perm(w01[h], w23[h], lut[(cw >> 8) & 0xF]);
          o.w = __byte_perm(w01[h], w23[h], lut[cw >> 12]);
          *reinterpret_cast<uint4*>(plane + ks * (kPlaneBytes / 2) + (tid + 128 * h) * 16) = o;
        }
      }
#endif
#ifndef K19_CUT_FORM
      form_z(my, rm, st, st.ys + kKT * ystr, ystr, cstr, has_ss, q, a);
#else
      for (int ks = 0; ks < 2; ++ks)
        for (int pt = 0; pt < 3; ++pt)
          for (int j = 0; j < 4; ++j) a.r[ks][pt][j] = tid * 3 + t;
#endif
      fence_frag(a);  // the fragments are final before the wgmmas' fence
      hop::fence_proxy_async();
      __syncthreads();
      hop::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int pt = 0; pt < 3; ++pt)
#ifndef K19_CUT_WGMMA
          hop::wgmma_m64n128k16_bf16_rs(acc, a.r[ks][pt], desc[ks]);
#else
          acc[pt] += __uint_as_float(a.r[ks][pt][0] ^ a.r[ks][pt][1] ^ a.r[ks][pt][2] ^
                                     a.r[ks][pt][3]);
#endif
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      hop::fence_operand(acc[i]);
      acc64[i * kThreads + tid] += static_cast<double>(acc[i]);
      acc[i] = 0.f;
    }
  }

  // acc64 element i of this thread: row r1 or r2 (bit 1 of i), variant
  // 8 (i / 4) + 2 q + i % 2
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int rr = (i >> 1) & 1;
    const int v = vt * kNV + 8 * (i >> 2) + 2 * q + (i & 1);
    if (out_base[rr] != nullptr && v < pr.vb)
      out_base[rr][v * out_vstride[rr]] = static_cast<float>(acc64[i * kThreads + tid]);
  }
}

constexpr int kStatThreads = 256;  // K20: permutations a CTA at most

// NaN-propagating max(x, lo) (fmax would drop a NaN x)
__device__ __forceinline__ double max_keep_nan(double x, double lo) {
  return x < lo ? lo : x;
}

// The statistic from beta_tc, x^T inv x and x0^T inv0 x0 (q > 0).
__device__ __forceinline__ double perm_stat(double beta_t, double bx, double bx0,
                                            double inv_tt, double yyv, double nmv, int d,
                                            int q) {
  const double rss = yyv - bx;
  const double dof = fmax(nmv - d, 1.0);
  const double sigma2 = rss / dof;
  if (q == 0) return beta_t / sqrt(max_keep_nan(sigma2 * inv_tt, 0.0));
  const double rss0 = yyv - bx0;
  return ((rss0 - rss) / q) / max_keep_nan(sigma2, 1e-30);
}

// d <= DM: one CTA a variant (blockIdx.x), each thread NB neighbouring
// permutations (blockIdx.y the ones past kStatThreads threads), the threads
// rounded up to a warp.  The variant's inverses are staged in shared memory
// once, as f64 (rows padded to an even length, inv0 at the full design's
// indices), and read as 16-byte broadcasts, each serving the thread's NB
// columns: every thread reads every entry, so those reads (512 bytes a warp
// and read, at the SM's 128 bytes a clock) set the pace at d = 24.  Each
// thread holds its columns of xty in registers, the loops unrolled over DM
// with uniform guards.  The order of operations is the plain version's
// (ops/glm.py linear_perm_stat_plain): s_i = sum_j inv_ij x_j in j order,
// bx = sum_i s_i x_i in i order, the reduced form over the kept columns
// (all but the q from tc) in increasing order.
template <int DM, int NB>
__global__ void linear_perm_stat_kernel(const float* __restrict__ inv,
                                        const float* __restrict__ xty,
                                        const float* __restrict__ yy,
                                        const float* __restrict__ nm,
                                        const float* __restrict__ inv0, int d, int tc,
                                        int q, int B, float* __restrict__ out) {
  extern __shared__ double2 sm_inv[];
  const int64_t v = blockIdx.x;
  const int b0 = (blockIdx.y * blockDim.x + threadIdx.x) * NB;
  const int d0 = d - q, dp = (d + 1) & ~1;
  double* sm = reinterpret_cast<double*>(sm_inv);  // [2][d][dp]
  const float* iv = inv + v * d * d;
  for (int k = threadIdx.x; k < d * d; k += blockDim.x)
    sm[k / d * dp + k % d] = static_cast<double>(iv[k]);
  if (q > 0) {
    const float* i0 = inv0 + v * d0 * d0;
    for (int k = threadIdx.x; k < d0 * d0; k += blockDim.x) {
      const int i = k / d0, j = k % d0;
      sm[d * dp + (i < tc ? i : i + q) * dp + (j < tc ? j : j + q)] =
          static_cast<double>(i0[k]);
    }
  }
  __syncthreads();
  if (b0 >= B) return;
  const float* xv = xty + v * d * B + b0;
  double x[NB][DM], bx[NB], bx0[NB], beta_t[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    bx[k] = bx0[k] = beta_t[k] = 0.0;
#pragma unroll
    for (int j = 0; j < DM; ++j)
      x[k][j] = j < d && b0 + k < B ? static_cast<double>(xv[j * B + k]) : 0.0;
  }
#pragma unroll
  for (int i = 0; i < DM; ++i) {
    if (i >= d) break;
    const double2* row = reinterpret_cast<const double2*>(sm + i * dp);
    double s[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) s[k] = 0.0;
#pragma unroll
    for (int j = 0; j < DM; j += 2) {
      if (j >= d) break;
      const double2 w = row[j / 2];
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        s[k] = fma(w.x, x[k][j], s[k]);
        if (j + 1 < d) s[k] = fma(w.y, x[k][j + 1], s[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      if (i == tc) beta_t[k] = s[k];
      bx[k] = fma(s[k], x[k][i], bx[k]);
    }
  }
  if (q > 0) {  // the same over the kept rows and columns
#pragma unroll
    for (int i = 0; i < DM; ++i) {
      if (i >= d) break;
      if (i >= tc && i < tc + q) continue;
      const double2* row = reinterpret_cast<const double2*>(sm + (d + i) * dp);
      double s[NB];
#pragma unroll
      for (int k = 0; k < NB; ++k) s[k] = 0.0;
#pragma unroll
      for (int j = 0; j < DM; j += 2) {
        if (j >= d) break;
        const double2 w = row[j / 2];
        const bool kx = j < tc || j >= tc + q;
        const bool ky = j + 1 < d && (j + 1 < tc || j + 1 >= tc + q);
#pragma unroll
        for (int k = 0; k < NB; ++k) {
          if (kx) s[k] = fma(w.x, x[k][j], s[k]);
          if (ky) s[k] = fma(w.y, x[k][j + 1], s[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < NB; ++k) bx0[k] = fma(s[k], x[k][i], bx0[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < NB; ++k)
    if (b0 + k < B)
      out[v * B + b0 + k] = static_cast<float>(perm_stat(
          beta_t[k], bx[k], bx0[k], sm[tc * dp + tc],
          static_cast<double>(yy[v * B + b0 + k]), static_cast<double>(nm[v]), d, q));
}

// d > 32: one CTA a variant, one thread a permutation, the inverses and x
// read from device memory as needed, in the same order of operations.
__global__ void linear_perm_stat_wide_kernel(const float* __restrict__ inv,
                                             const float* __restrict__ xty,
                                             const float* __restrict__ yy,
                                             const float* __restrict__ nm,
                                             const float* __restrict__ inv0, int d, int tc,
                                             int q, int B, float* __restrict__ out) {
  const int64_t v = blockIdx.x;
  const int b = blockIdx.y * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int d0 = d - q;
  const float* iv = inv + v * d * d;
  const float* i0 = q > 0 ? inv0 + v * d0 * d0 : nullptr;
  const float* xv = xty + v * d * B + b;
  double bx = 0.0, beta_t = 0.0, bx0 = 0.0;
  for (int i = 0; i < d; ++i) {
    double s = 0.0;
    for (int j = 0; j < d; ++j)
      s = fma(static_cast<double>(iv[i * d + j]), static_cast<double>(xv[j * B]), s);
    if (i == tc) beta_t = s;
    bx = fma(s, static_cast<double>(xv[i * B]), bx);
  }
  for (int i = 0; i < (q > 0 ? d0 : 0); ++i) {
    double s = 0.0;
    for (int j = 0; j < d0; ++j)
      s = fma(static_cast<double>(i0[i * d0 + j]),
              static_cast<double>(xv[(j < tc ? j : j + q) * B]), s);
    bx0 = fma(s, static_cast<double>(xv[(i < tc ? i : i + q) * B]), bx0);
  }
  out[v * B + b] = static_cast<float>(perm_stat(beta_t, bx, bx0,
                                                static_cast<double>(iv[tc * d + tc]),
                                                static_cast<double>(yy[v * B + b]),
                                                static_cast<double>(nm[v]), d, q));
}

int ceil_log2(int n) {
  int lg = 0;
  while ((1 << lg) < n) ++lg;
  return lg;
}

// the smallest shared row stride >= n floats that is 4 mod 8: the fragment
// reads (sample rows 2q and 2q + 1, eight consecutive columns) then fall in
// distinct banks
int bank_stride(int n) { return (n + 3) / 8 * 8 + 4; }

}  // namespace

// packed [vb, nb] u8; gw [vb, P, 3] f32 (per-code weights exact in bf16);
// c [4 nb, dc] f32, 16-byte aligned; Y [4 nb, B] f32, 16-byte aligned, B a
// multiple of 4; mask [4 nb] f32 (0 or 1); covj [P] i32 (the c column
// multiplying G_p, or -1); sscale [4 nb] f32 or null; split_len: samples
// per f32 run (a multiple of 32); xty [vb, dc + P, B] f32; yy [vb, B] f32.
PT_EXPORT int pt_linear_perm_xty(const void* packed, long long nb, int vb,
                                 const void* gw, int P, const void* c, int dc,
                                 const void* Y, int B, const void* mask,
                                 const void* covj, const void* sscale,
                                 long long split_len, void* xty, void* yy,
                                 void* stream) {
  if (vb == 0 || B == 0) return cudaSuccess;
  if (split_len <= 0 || split_len % kKT != 0 || dc < 0 || P < 0 || B % 4 != 0 ||
      reinterpret_cast<uintptr_t>(Y) % 16 != 0 ||
      (dc > 0 && reinterpret_cast<uintptr_t>(c) % 16 != 0))
    return cudaErrorInvalidValue;
  Params pr{};
  pr.packed = static_cast<const uint8_t*>(packed);
  pr.nb = nb;
  pr.vb = vb;
  pr.gw = static_cast<const float*>(gw);
  pr.P = P;
  pr.c = static_cast<const float*>(c);
  pr.dc = dc;
  pr.Y = static_cast<const float*>(Y);
  pr.B = B;
  pr.mask = static_cast<const float*>(mask);
  pr.covj = static_cast<const int*>(covj);
  pr.sscale = static_cast<const float*>(sscale);
  pr.xty = static_cast<float*>(xty);
  pr.yy = static_cast<float*>(yy);
  pr.ntiles = static_cast<int>((4 * nb + kKT - 1) / kKT);
  pr.tiles_per_run = static_cast<int>(split_len / kKT);
  const int dc1 = dc + 1;
  const int64_t Qv = static_cast<int64_t>(dc1) * B;
  pr.Tv = static_cast<int>((Qv + kRows - 1) / kRows);
  pr.Tg = (B + kRows - 1) / kRows;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(packed);
  pr.code_w = (nb % 8 == 0 && pa % 8 == 0) ? 8 : (nb % 4 == 0 && pa % 4 == 0) ? 4 : 1;
  int ny_v = 1;  // the widest valid-plane tile's Y window
  for (int64_t q0 = 0; q0 < Qv; q0 += kRows) {
    const int64_t qe = std::min<int64_t>(q0 + kRows, Qv) - 1;
    ny_v = std::max(ny_v, static_cast<int>(qe / dc1 - q0 / dc1 / 4 * 4 + 1));
  }
  pr.ylg_v = ceil_log2((ny_v + 3) / 4);
  pr.ystr_v = bank_stride((1 << pr.ylg_v) * 4);
  // all dc columns back to back (the valid-plane tiles of dc + 1 <= 64), or
  // a window of 64 of them
  pr.cstr_v = dc1 <= kRows ? std::max(dc, 1) : bank_stride(kRows);
  pr.ylg_g = ceil_log2(std::min(B, kRows) / 4);
  pr.ystr_g = bank_stride((1 << pr.ylg_g) * 4);
  const int blk = std::max(pr.ystr_v + pr.cstr_v, P > 0 ? pr.ystr_g + 4 : 0);
  pr.stage_bytes = kStageHead + kKT * blk * 4;
  // three stages if two CTAs still fit an SM, else two
  pr.nst = kStageOff + 3 * pr.stage_bytes <= kTwoPerSm ? 3 : 2;
  const int smem = kStageOff + pr.nst * pr.stage_bytes;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int tiles = pr.Tv + P * pr.Tg;
  if (tiles > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      linear_perm_xty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(linear_perm_xty_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((vb + kNV - 1) / kNV, tiles);
  linear_perm_xty_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(pr);
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
  // permutations a thread: 1 at d <= 16, 2 at d <= 32 (there the shared
  // memory reads set the pace), 1 above
  const int nbt = d > 16 && d <= 32 ? 2 : 1;
  const int per = (B + nbt - 1) / nbt;
  const int threads = std::min(kStatThreads, (per + 31) / 32 * 32);
  const dim3 grid(vb, (per + threads - 1) / threads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fi = static_cast<const float*>(inv), *fx = static_cast<const float*>(xty),
              *fy = static_cast<const float*>(yy), *fn = static_cast<const float*>(nm),
              *f0 = static_cast<const float*>(inv0);
  float* fo = static_cast<float*>(out);
  if (d > 32) {
    linear_perm_stat_wide_kernel<<<grid, threads, 0, st>>>(fi, fx, fy, fn, f0, d, tc, q, B,
                                                          fo);
    return cudaGetLastError();
  }
  const size_t smem = sizeof(double) * d * ((d + 1) & ~1) * (q > 0 ? 2 : 1);
  auto kernel = d <= 16 ? linear_perm_stat_kernel<16, 1> : linear_perm_stat_kernel<32, 2>;
  kernel<<<grid, threads, smem, st>>>(fi, fx, fy, fn, f0, d, tc, q, B, fo);
  return cudaGetLastError();
}
