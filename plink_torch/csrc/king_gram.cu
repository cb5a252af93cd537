// K7 king_gram: KING-robust counters and kinship of one sample tile, summed
// over every variant in one launch.
//
// Replaces (plink_tpu/ops/pairwise.py) `king_gram_tile` (:60), the int8
// H/A/V plane Gram [3s, 3t] accumulated over the variant blocks, and
// `king_tile_stats` (:173), the counters, f64 kinship, lower-triangle +
// filter mask and pass count computed from it.  The [3s, 3t] Gram never
// exists here: the five counters are counted directly.
//
// For row sample i and column sample j over the included variants:
//   hethet      = #(het_i & het_j)
//   ibs0        = #(homalt_i & homref_j) + #(homref_i & homalt_j)
//   het_r_hom_c = #(het_i & hom_j),  het_c_hom_r = #(hom_i & het_j)
//   nsnp        = #(valid_i & valid_j),  homhom = nsnp - the other four
// (hom = homref | homalt), the same integers as plink_tpu's linear
// combinations of the plane Gram.  All counts are exact int32.
//
// Bound: operations.  6 s t V int8 multiply-adds on the tensor cores, the
// plane products the counters need (HH, HV, VH, VV and ibs0 = AR + RA with
// R = hom-REF; plink_tpu forms all nine of H/A/V), 0.833 ms per 2,048 x
// 2,048 tile at V = 32,768 and 1,979 TOPS.  Design (plink2's own, CalcKingDenseThread): a
// first kernel transposes the tile's samples into 32-variant bit words of
// the het, hom-ALT and hom-REF planes (one warp ballot per plane and
// sample; lane = variant), variant-masked, into a scratch buffer; the
// second kernel counts each pair's five counters with AND + popcount, five
// popcounts per 32 variants, in 64 x 64 pair tiles (4 x 4 pairs a thread),
// 8 words of each plane staged in shared memory per step.  The popcount
// unit (16 per clock per SM) sets its pace.  The epilogue follows
// king_tile_stats: kinship in f64 in the same order of operations (-inf
// where the denominator is 0), the strict-lower-triangle and filter mask,
// and the tile's pass count (integer atomics, exact in any order).  No
// float atomics: two runs give identical bytes.
#include "common.cuh"

namespace {

constexpr int kGroup = 16;       // samples per warp in the transpose
constexpr int kTile = 64;        // pairs per block side
constexpr int kWords = 8;        // 32-variant words per shared-memory step
constexpr int kThreads = 256;    // 16 x 16 threads, 4 x 4 pairs each

// planes [3][W][spad]: per 32-variant word w and tile sample k the bits of
// het (0), hom-ALT (1) and hom-REF (2); rows take k in [0, s64), columns
// [s64, s64 + t64), each side zero past its length.
__global__ void __launch_bounds__(kThreads)
king_planes_kernel(const uint8_t* __restrict__ packed, int64_t nb_bytes,
                   int64_t nvar, const int8_t* __restrict__ vmask,
                   int64_t row0, int s, int64_t col0, int t, int s64, int t64,
                   int64_t nwords, uint32_t* __restrict__ planes) {
  const int lane = threadIdx.x & 31;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  const int groups_r = s64 / kGroup;
  if (g >= groups_r + t64 / kGroup) return;
  const bool is_row = g < groups_r;
  const int k0 = static_cast<int>(is_row ? g : g - groups_r) * kGroup;  // within side
  const int len = is_row ? s : t;
  const int64_t first = (is_row ? row0 : col0) + k0;  // packed sample index
  for (int64_t w = blockIdx.y; w < nwords; w += gridDim.y) {
    const int64_t v = w * 32 + lane;
    uint32_t x = 0;
    bool vm = false;
    if (v < nvar && k0 < len) {
      const uint8_t* row = packed + v * nb_bytes;
      const bool aligned = ((nb_bytes & 3) == 0) && ((first & 15) == 0) &&
                           ((reinterpret_cast<uintptr_t>(packed) & 3) == 0);
      x = load_codes16(row, nb_bytes, first, aligned);
      vm = vmask[v] != 0;
    }
    uint32_t mine[3] = {0u, 0u, 0u};
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const uint32_t code = (x >> (2 * q)) & 3u;
      const bool on = vm && (k0 + q < len);
      const uint32_t h = __ballot_sync(0xffffffffu, on && code == 1u);
      const uint32_t a = __ballot_sync(0xffffffffu, on && code == 2u);
      const uint32_t r = __ballot_sync(0xffffffffu, on && code == 0u);
      if (lane == q) {
        mine[0] = h;
        mine[1] = a;
        mine[2] = r;
      }
    }
    if (lane < kGroup) {
      const int64_t spad = s64 + t64;
      const int64_t col = (is_row ? 0 : s64) + k0 + lane;
#pragma unroll
      for (int p = 0; p < 3; ++p) planes[(p * nwords + w) * spad + col] = mine[p];
    }
  }
}

// mode 0 (stats): kin f64, nsnp / hethet / ibs0 i32, pass u8 [s, t] and the
// pass count; mode 1 (counters): cnt i32 [6][s][t] = ibs0, hethet,
// het_r_hom_c, het_c_hom_r, homhom, nsnp.
__global__ void __launch_bounds__(kThreads)
king_gram_kernel(const uint32_t* __restrict__ planes, int64_t nwords, int s64,
                 int t64, int s, int t, int64_t row0, int64_t col0, int64_t n,
                 double thresh, int mode, double* __restrict__ kin,
                 int* __restrict__ nsnp_out, int* __restrict__ hethet_out,
                 int* __restrict__ ibs0_out, uint8_t* __restrict__ pass_out,
                 int* __restrict__ pass_ct, int* __restrict__ cnt_out) {
  __shared__ __align__(16) uint32_t sr[3][kWords][kTile];
  __shared__ __align__(16) uint32_t sc[3][kWords][kTile];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int rb = blockIdx.y * kTile, cb = blockIdx.x * kTile;
  const int64_t spad = s64 + t64;
  int hh[4][4], h12[4][4], h21[4][4], ib[4][4], ns[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) hh[i][j] = h12[i][j] = h21[i][j] = ib[i][j] = ns[i][j] = 0;

  for (int64_t w0 = 0; w0 < nwords; w0 += kWords) {
    __syncthreads();
    // 2 sides x 3 planes x kWords words x 64 samples = 768 uint4 loads
    for (int i = threadIdx.x; i < 2 * 3 * kWords * (kTile / 4); i += kThreads) {
      const int q = i % (kTile / 4);
      const int ww = (i / (kTile / 4)) % kWords;
      const int p = (i / (kTile / 4 * kWords)) % 3;
      const int side = i / (kTile / 4 * kWords * 3);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (w0 + ww < nwords) {
        const int64_t base = (p * nwords + w0 + ww) * spad +
                             (side ? s64 + cb : rb) + 4 * q;
        val = *reinterpret_cast<const uint4*>(planes + base);
      }
      uint32_t* dst = side ? &sc[p][ww][4 * q] : &sr[p][ww][4 * q];
      *reinterpret_cast<uint4*>(dst) = val;
    }
    __syncthreads();
#pragma unroll 2
    for (int ww = 0; ww < kWords; ++ww) {
      const uint4 rh = *reinterpret_cast<const uint4*>(&sr[0][ww][4 * ty]);
      const uint4 ra = *reinterpret_cast<const uint4*>(&sr[1][ww][4 * ty]);
      const uint4 rr = *reinterpret_cast<const uint4*>(&sr[2][ww][4 * ty]);
      const uint4 ch = *reinterpret_cast<const uint4*>(&sc[0][ww][4 * tx]);
      const uint4 ca = *reinterpret_cast<const uint4*>(&sc[1][ww][4 * tx]);
      const uint4 cr = *reinterpret_cast<const uint4*>(&sc[2][ww][4 * tx]);
      const uint32_t H[4] = {rh.x, rh.y, rh.z, rh.w};
      const uint32_t A[4] = {ra.x, ra.y, ra.z, ra.w};
      const uint32_t R[4] = {rr.x, rr.y, rr.z, rr.w};
      const uint32_t Hc[4] = {ch.x, ch.y, ch.z, ch.w};
      const uint32_t Ac[4] = {ca.x, ca.y, ca.z, ca.w};
      const uint32_t Rc[4] = {cr.x, cr.y, cr.z, cr.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t Oi = A[i] | R[i], Vi = H[i] | Oi;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t Oj = Ac[j] | Rc[j], Vj = Hc[j] | Oj;
          hh[i][j] += __popc(H[i] & Hc[j]);
          h12[i][j] += __popc(H[i] & Oj);
          h21[i][j] += __popc(Oi & Hc[j]);
          ib[i][j] += __popc((A[i] & Rc[j]) | (R[i] & Ac[j]));
          ns[i][j] += __popc(Vi & Vj);
        }
      }
    }
  }

  int passed = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rb + 4 * ty + i;
    if (r >= s) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = cb + 4 * tx + j;
      if (c >= t) continue;
      const int64_t o = static_cast<int64_t>(r) * t + c;
      if (mode == 1) {
        const int64_t st = static_cast<int64_t>(s) * t;
        cnt_out[o] = ib[i][j];
        cnt_out[st + o] = hh[i][j];
        cnt_out[2 * st + o] = h12[i][j];
        cnt_out[3 * st + o] = h21[i][j];
        cnt_out[4 * st + o] = ns[i][j] - ib[i][j] - hh[i][j] - h12[i][j] - h21[i][j];
        cnt_out[5 * st + o] = ns[i][j];
        continue;
      }
      // king_tile_stats' order: f64 from the start (4 * ibs0 can pass int32)
      const double smaller = static_cast<double>(hh[i][j]) +
                             static_cast<double>(min(h12[i][j], h21[i][j]));
      const double num = __dadd_rn(__dadd_rn(__dmul_rn(4.0, static_cast<double>(ib[i][j])),
                                             static_cast<double>(h12[i][j])),
                                   static_cast<double>(h21[i][j]));
      const double k = __dsub_rn(0.5, __ddiv_rn(num, __dmul_rn(4.0, smaller)));
      const int64_t gr = row0 + r, gc = col0 + c;
      const bool ok = gr > gc && gr < n && gc < n && k >= thresh;
      kin[o] = k;
      nsnp_out[o] = ns[i][j];
      hethet_out[o] = hh[i][j];
      ibs0_out[o] = ib[i][j];
      pass_out[o] = ok ? 1 : 0;
      passed += ok;
    }
  }
  if (mode == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) passed += __shfl_down_sync(0xffffffffu, passed, off);
    if ((threadIdx.x & 31) == 0 && passed) atomicAdd(pass_ct, passed);
  }
}

}  // namespace

// packed [nvar, nb_bytes] u8 (the [nb, vb, NB] blocks, flattened); vmask
// [nvar] i8; the tile is samples [row0, row0 + s) x [col0, col0 + t), both
// inside the packed rows.  planes: u32 scratch of 3 * ceil(nvar / 32) *
// (s64 + t64) words, s64 / t64 = s / t rounded up to 64.  Mode 0 writes
// kin / nsnp / hethet / ibs0 / pass [s, t] and adds the tile's pass count to
// *pass_ct (zeroed by the caller); mode 1 writes cnt [6, s, t].
PT_EXPORT int pt_king_gram(const void* packed, long long nb_bytes, long long nvar,
                           const void* vmask, long long row0, int s,
                           long long col0, int t, long long n, double thresh,
                           int mode, void* planes, void* kin, void* nsnp,
                           void* hethet, void* ibs0, void* pass, void* pass_ct,
                           void* cnt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s <= 0 || t <= 0) return cudaSuccess;
  const int s64 = (s + kTile - 1) / kTile * kTile;
  const int t64 = (t + kTile - 1) / kTile * kTile;
  const int64_t nwords = (nvar + 31) / 32;
  if (nwords == 0) return cudaSuccess;
  const int groups = (s64 + t64) / kGroup;
  const dim3 g1((groups + kThreads / 32 - 1) / (kThreads / 32),
                static_cast<unsigned>(nwords < 65535 ? nwords : 65535));
  king_planes_kernel<<<g1, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(packed), nb_bytes, nvar,
      static_cast<const int8_t*>(vmask), row0, s, col0, t, s64, t64, nwords,
      static_cast<uint32_t*>(planes));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g2(t64 / kTile, s64 / kTile);
  king_gram_kernel<<<g2, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(planes), nwords, s64, t64, s, t, row0, col0,
      n, thresh, mode, static_cast<double*>(kin), static_cast<int*>(nsnp),
      static_cast<int*>(hethet), static_cast<int*>(ibs0),
      static_cast<uint8_t*>(pass), static_cast<int*>(pass_ct),
      static_cast<int*>(cnt));
  return cudaGetLastError();
}
