// K15 glm_moments_wide and K16 glm_irls_wide: the moments matrix and one
// logistic / Firth IRLS evaluation for designs too wide for the
// thread-per-variant kernels K2 / K3, and for every design whose genotype
// columns carry a covariate factor (--glm interaction).
//
// Replaces (plink_tpu/ops/glm.py) `_plane_cols` (:288-325) with P predictor
// columns, each optionally times a covariate column covj[p] (the G x C
// interaction terms) and the per-sample multiplier sscale, followed by
// `_moments_from_cols` (:242; K15) or by the `_design_ops` contractions
// (xtv, hessian, eta_of, :328) of `_logistic_core` (:383) and `_firth_core`
// (:492) with the Firth hat diagonal (:510-523; K16).  Per variant v the
// design row is x_s = [c_s (nc columns) | G_1(v,s) .. G_P(v,s)],
//   G_p = (wH het + wA homalt + wV valid) * c_s[covj_p] (if covj_p > 0) * s_s,
// and the kernel forms (mode 2, K15) sum_s valid x x^T over the table
// [cy | mask] (y is then one of the nc columns, as in K2), or (modes 0 / 1,
// K16, table [c | y | mask]) the sums of K3: H = sum w x x^T, vec = X^T r
// and, in mode 0, the log-likelihood in f64, with w, r as in glm_irls.cuh.
// At SEX + 10 PCs, `interaction` gives d = 24 (additive, D = 26 with y and
// ADD in the moments) and d = 36 (genotypic, D = 38); d up to 96 is taken.
//
// Bound: operations.  d(d+1)/2 + d multiply-adds per (variant, sample)
// pair (666 + 36 at d = 36; plus the d(d+1)/2 of the hat value in firth2),
// against 2 bits of packed input and one per-sample table row shared by
// every variant.  One thread per variant (K2 / K3) would need 300-700
// accumulators, so the work is split two ways instead.  A CTA takes VG
// variants (8, 4, 2 or 1: the most that keep every thread at <= 2 tiles)
// and walks its split of the sample axis in tiles of T = 256 / VG samples.
// Phase A, one thread per (variant, sample) of the tile: decode the 2-bit
// code, form the variant's G columns (the covariate columns are staged
// once for the CTA), then eta, the IRLS weight w and residual r (and the
// hat value from the variant's Hinv0 triangle in shared memory) into
// shared memory.  Phase B: each thread owns one or two 4 x 4 tiles of one
// variant's upper triangle (or a 1 x 4 tile of its vector, as the row of
// ones times r) and accumulates sum_s (w x_j) x_k over the tile's samples
// with FP32 FMA from float4 shared-memory reads (row stride T + 4 floats:
// eight rows of one quarter-warp fall in distinct banks).  No tensor cores
// (JAX runs these contractions at Precision.HIGH, ~f32), no atomics: each
// split writes its partial sums, and a second kernel adds the splits in f64
// in index order, so two runs give the same bytes.  The per-sample
// log-likelihood terms are added in f64 per (variant, sample slot) and the
// slots in order.  Per entry the sample order and the arithmetic are K3's
// (w x_j times x_k, r times x_k), so on a design K3 takes the two agree to
// f32 rounding of the f64 loglik order only.
//
// Shared memory: the staged rows T(nc + VG(P + 2) + 2) floats, Hinv0
// VG d(d+1)/2 floats (firth2), the log-likelihood slots 256 doubles; 57 KB
// at d = 36, VG = 8, firth2, and ~125 KB at d = 96, VG = 1: above 48 KB the
// launch raises the kernel's dynamic shared-memory limit.
//
// Any width.  One CTA holds at most 256 x kWideItems = 512 tiles, so a
// variant whose triangle has more (moments D > 124, IRLS d > 120) has its
// tile list split over a third grid axis: each CTA of the axis redoes phase
// A for its sample tile (O(d) a pair, against phase B's O(d^2)) and sums
// its own 512 tiles, so every entry keeps its sample order and the splits
// their f64 order (two runs give the same bytes).  Where VG = 1 and T = 256
// no longer fit in 227 KB (the staged rows grow with d, Hinv0 with d^2),
// the one-variant kernel (VG = 0 below) takes a smaller sample tile T =
// 128, 64, ... 4 chosen from d, and, should even T = 4 not hold Hinv0 too,
// reads Hinv0 from device memory; no width is refused.
//
// Dense mode (the dosage --glm with more than 16 covariate columns, K17 /
// K18's wide counterpart): with `dos` given, phase A reads the variant's
// uint16 A1 dosage u (65535 missing; glm_dense.cu) instead of a 2-bit code
// and takes g = u / 16384 as the het plane of a single predictor whose
// plane weights the caller sets to (1, 0, 0).
#include "glm_irls.cuh"

namespace {

constexpr int kWideThreads = 256;
constexpr int kWideItems = 2;  // accumulator tiles per thread

struct WideArgs {
  const uint8_t* packed;
  int64_t nb_bytes;
  int vb;
  const float* feat;
  int64_t npad;
  int nc;  // design columns taken from the table
  int np;  // genotype predictor columns
  const int* covj;
  int64_t split_len;
  const float* gw;
  const float* beta;
  const float* hinv;
  const uint8_t* active;
  const float* sscale;
  float* part;
  double* part_ll;
  const uint16_t* dos;  // dense mode: A1 dosages [vb, npad], else null
  int tile;             // VG = 0: samples per tile
  int hsm;              // VG = 0, firth2: Hinv0 staged in shared memory
};

__host__ __device__ constexpr int wide_tiles(int D) { return (D + 3) / 4; }

// 4 x 4 tiles of the upper triangle, then (modes 0 / 1) 1 x 4 vector tiles
__host__ __device__ inline int wide_items(int D, int mode) {
  const int nt = wide_tiles(D);
  return nt * (nt + 1) / 2 + (mode == 2 ? 0 : nt);
}

// VG variants a CTA (0: one variant in tiles of `tile` samples)
__host__ inline size_t wide_smem(int VG, int mode, int nc, int np,
                                 int tile = 0, bool hsm = true) {
  const int NV = VG > 0 ? VG : 1;
  const int T = VG > 0 ? kWideThreads / VG : tile;
  const int TP = T + 4;
  const int D = nc + np;
  size_t floats = static_cast<size_t>(TP) * (nc + NV * (np + 2) + 2) +
                  NV * (D + 3 * np) + np;  // + beta, gw, covj
  if (mode == 1 && hsm) floats += static_cast<size_t>(NV) * D * (D + 1) / 2;
  return sizeof(double) * kWideThreads + sizeof(float) * floats;
}

template <int VG, int MODE, bool SCALE>
__global__ void __launch_bounds__(kWideThreads, 1)
wide_kernel(WideArgs a) {
  constexpr int NV = VG > 0 ? VG : 1;  // variants a CTA
  const int T = VG > 0 ? kWideThreads / (VG > 0 ? VG : 1) : a.tile;
  const int TP = T + 4;
  const bool hsm = VG > 0 || a.hsm;  // Hinv0 in shared memory
  const int nc = a.nc, np = a.np, D = nc + np;
  const int F = nc + (MODE == 2 ? 1 : 2);  // table: [c | (y) | mask]
  const int NTRI = D * (D + 1) / 2;
  const int NT = NTRI + (MODE == 2 ? 0 : D);
  extern __shared__ double wsm[];
  double* sll = wsm;                                  // [256] loglik slots
  float* Xc = reinterpret_cast<float*>(wsm + kWideThreads);  // [nc][TP]
  float* Xg = Xc + nc * TP;                           // [NV][np][TP]
  float* Wt = Xg + NV * np * TP;                      // [NV][TP] w
  float* Rt = Wt + NV * TP;                           // [NV][TP] r
  float* Zr = Rt + NV * TP;                           // [TP] zeros
  float* On = Zr + TP;                                // [TP] ones
  float* sb = On + TP;                                // [NV][D] beta
  float* sw = sb + NV * D;                            // [NV][np][3] weights
  int* scj = reinterpret_cast<int*>(sw + NV * np * 3);  // [np] covj
  float* sh = reinterpret_cast<float*>(scj + np);     // [NV][NTRI] Hinv0

  const int tid = threadIdx.x;
  // phase A: this thread's variant and sample slot (VG = 0: the first T
  // threads)
  const int vl = VG > 0 ? tid / T : 0;
  const int sl = VG > 0 ? tid % T : tid;
  const bool pa = VG > 0 || tid < T;
  const int v = blockIdx.x * NV + vl;
  const int split = blockIdx.y;
  const int64_t s0 = static_cast<int64_t>(split) * a.split_len;
  const int64_t s1 = min(a.npad, s0 + a.split_len);
  const bool on = pa && v < a.vb && (MODE == 2 || a.active[v] != 0);

  for (int i = tid; i < TP; i += kWideThreads) {
    Zr[i] = 0.f;
    On[i] = 1.f;
  }
  for (int i = tid; i < np; i += kWideThreads) scj[i] = a.covj[i];
  for (int i = tid; i < NV * np * 3; i += kWideThreads) {
    const int vv = blockIdx.x * NV + i / (np * 3);
    sw[i] = vv < a.vb ? a.gw[static_cast<int64_t>(vv) * np * 3 + i % (np * 3)] : 0.f;
  }
  if (MODE != 2) {
    for (int i = tid; i < NV * D; i += kWideThreads) {
      const int vv = blockIdx.x * NV + i / D;
      sb[i] = vv < a.vb ? a.beta[static_cast<int64_t>(vv) * D + i % D] : 0.f;
    }
  }
  if (MODE == 1 && hsm) {
    for (int i = tid; i < NV * NTRI; i += kWideThreads) {
      const int vv = blockIdx.x * NV + i / NTRI;
      int t = i % NTRI, j = 0;
      while (t >= D - j) {
        t -= D - j;
        ++j;
      }
      sh[i] = vv < a.vb ? a.hinv[(static_cast<int64_t>(vv) * D + j) * D + j + t] : 0.f;
    }
  }

  // phase B: this thread's tiles, as shared-memory row offsets (a CTA of
  // the third grid axis takes the tiles from its 512 x blockIdx.z on)
  const int nt = wide_tiles(D);
  const int ntri_t = nt * (nt + 1) / 2;
  const int ipv = wide_items(D, MODE);
  const int it0 = VG <= 1 ? blockIdx.z * (kWideThreads * kWideItems) : 0;
  int it_v[kWideItems], it_j[kWideItems], it_k[kWideItems];
  bool it_on[kWideItems], it_vec[kWideItems];
  const float* rowa[kWideItems][4];
  const float* rowb[kWideItems][4];
  const float* roww[kWideItems];
#pragma unroll
  for (int m = 0; m < kWideItems; ++m) {
    const int it = it0 + tid + m * kWideThreads;
    it_on[m] = it < NV * ipv;
    const int iv = it_on[m] ? it / ipv : 0;
    int t = it_on[m] ? it % ipv : 0;
    int bj = 0, bk = 0;
    it_vec[m] = t >= ntri_t;
    if (it_vec[m]) {
      bk = t - ntri_t;
    } else {
      while (t >= nt - bj) {
        t -= nt - bj;
        ++bj;
      }
      bk = bj + t;
    }
    it_v[m] = iv;
    it_j[m] = 4 * bj;
    it_k[m] = 4 * bk;
    auto row = [&](int j) -> const float* {
      if (j >= D) return Zr;
      if (j < nc) return Xc + j * TP;
      return Xg + (iv * np + (j - nc)) * TP;
    };
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      rowb[m][r] = row(it_k[m] + r);
      rowa[m][r] = it_vec[m] ? (r == 0 ? On : Zr) : row(it_j[m] + r);
    }
    roww[m] = (it_vec[m] ? Rt : Wt) + iv * TP;
  }
  float acc[kWideItems][4][4];
#pragma unroll
  for (int m = 0; m < kWideItems; ++m)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][r][c] = 0.f;

  double ll = 0.0;
  const uint8_t* prow = a.packed + static_cast<int64_t>(on ? v : 0) * a.nb_bytes;
  float* xg = Xg + vl * np * TP;
  const float* bv = sb + vl * D;
  const float* wv = sw + vl * np * 3;
  const float* hv = sh + vl * NTRI;
  const float* hg = a.hinv + static_cast<int64_t>(on ? v : 0) * D * D;
  const uint8_t* drow = reinterpret_cast<const uint8_t*>(
      a.dos + static_cast<int64_t>(on ? v : 0) * a.npad);
  // late IRLS iterations leave few rows active: a CTA with none skips its
  // samples and writes zero partials
  const int64_t s_end = __syncthreads_or(on) ? s1 : s0;

  for (int64_t t0 = s0; t0 < s_end; t0 += T) {
    const int64_t s = t0 + sl;
    const bool in = s < s1;
    __syncthreads();  // the previous tile's phase B is done with the rows
    if (vl == 0 && pa)
      for (int j = 0; j < nc; ++j) Xc[j * TP + sl] = in ? a.feat[s * F + j] : 0.f;
    __syncthreads();
    float valid = 0.f, hpl = 0.f, apl = 0.f;
    if (on && in) {
      if (a.dos) {  // dense mode: g = u / 16384 as the het plane
        const uint32_t u = load_dosage(drow, s);
        valid = (u == 0xFFFFu) ? 0.f : a.feat[s * F + F - 1];
        hpl = static_cast<float>(u) * (1.f / 16384.f) * valid;
      } else {
        const int code = (prow[s >> 2] >> (2 * (s & 3))) & 3;
        valid = (code == 3) ? 0.f : a.feat[s * F + F - 1];
        hpl = (code == 1) ? valid : 0.f;
        apl = (code == 2) ? valid : 0.f;
      }
    }
    const float sc = (SCALE && in) ? a.sscale[s] : 1.f;
    for (int p = 0; p < np && pa; ++p) {
      float g = wv[3 * p] * hpl + wv[3 * p + 1] * apl + wv[3 * p + 2] * valid;
      if (scj[p] > 0) g *= Xc[scj[p] * TP + sl];
      if (SCALE) g *= sc;
      xg[p * TP + sl] = g;
    }
    float wt = 0.f, r = 0.f;
    if (MODE == 2) {
      wt = valid;
    } else if (valid != 0.f) {
      float eta = 0.f;
      for (int j = 0; j < nc; ++j) eta = fmaf(bv[j], Xc[j * TP + sl], eta);
      for (int p = 0; p < np; ++p) eta = fmaf(bv[nc + p], xg[p * TP + sl], eta);
      eta *= valid;
      const float yv = a.feat[s * F + nc] * valid;
      float sg, q, sp_pos, sp_neg;
      logistic_terms(eta, sg, q, sp_pos, sp_neg);
      const float p = sg * valid;
      const float y_minus_p = (yv != 0.f) ? q * valid : -p;
      if (MODE == 0) {
        ll += static_cast<double>(yv * (-sp_neg) + (valid - yv) * (-sp_pos));
        wt = sg * q * valid;
        r = -y_minus_p;
      } else {
        const float vw = sg * q * valid;
        float quad = 0.f;
        int t = 0;
        for (int j = 0; j < D; ++j) {
          const float xj = j < nc ? Xc[j * TP + sl] : xg[(j - nc) * TP + sl];
          for (int k = j; k < D; ++k, ++t) {
            const float xk = k < nc ? Xc[k * TP + sl] : xg[(k - nc) * TP + sl];
            const float h = (hsm ? hv[t] : hg[j * D + k]) * (k == j ? 1.f : 2.f);
            quad = fmaf(h * xj, xk, quad);
          }
        }
        const float hd = vw * quad;
        r = (y_minus_p + hd * (0.5f - p)) * valid;
        wt = (1.f + hd) * vw;
      }
    }
    if (pa) {
      Wt[vl * TP + sl] = wt;
      if (MODE != 2) Rt[vl * TP + sl] = r;
    }
    __syncthreads();

#pragma unroll
    for (int m = 0; m < kWideItems; ++m) {
      if (!it_on[m]) continue;
      for (int u = 0; u < T; u += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(roww[m] + u);
        float4 xa[4], xb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          xa[i] = *reinterpret_cast<const float4*>(rowa[m][i] + u);
          xb[i] = *reinterpret_cast<const float4*>(rowb[m][i] + u);
        }
#define PT_WIDE_STEP(C)                                         \
  _Pragma("unroll") for (int i = 0; i < 4; ++i) {               \
    const float wa = w4.C * xa[i].C;                            \
    _Pragma("unroll") for (int k = 0; k < 4; ++k)               \
        acc[m][i][k] = fmaf(wa, xb[k].C, acc[m][i][k]);         \
  }
        PT_WIDE_STEP(x)
        PT_WIDE_STEP(y)
        PT_WIDE_STEP(z)
        PT_WIDE_STEP(w)
#undef PT_WIDE_STEP
      }
    }
  }

  // partial sums of this split: [split][entry][variant]
#pragma unroll
  for (int m = 0; m < kWideItems; ++m) {
    const int vv = blockIdx.x * NV + it_v[m];
    if (!it_on[m] || vv >= a.vb) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int jj = it_j[m] + i, kk = it_k[m] + k;
        int e = -1;
        if (it_vec[m]) {
          if (i == 0 && kk < D) e = NTRI + kk;
        } else if (jj <= kk && kk < D) {
          e = jj * D - jj * (jj - 1) / 2 + (kk - jj);
        }
        if (e >= 0)
          a.part[(static_cast<int64_t>(split) * NT + e) * a.vb + vv] = acc[m][i][k];
      }
  }
  if (MODE == 0) {
    sll[tid] = ll;
    __syncthreads();
    if (sl == 0 && pa && v < a.vb && (VG > 1 || blockIdx.z == 0)) {
      double s = 0.0;
      for (int i = 0; i < T; ++i) s += sll[vl * T + i];
      a.part_ll[static_cast<int64_t>(split) * a.vb + v] = s;
    }
  }
}

// Second pass: out[v, j, k] (full symmetric), vec[v, j], ll[v] from the
// per-split partials, splits added in f64 in index order (common.cuh's
// reduce_splits_kernel with the width a run-time value).
__global__ void wide_reduce_kernel(const float* __restrict__ part,
                                   const double* __restrict__ part_ll,
                                   int splits, int vb, int D, int has_vec,
                                   float* __restrict__ out_mat,
                                   float* __restrict__ out_vec,
                                   double* __restrict__ out_ll) {
  const int NTRI = D * (D + 1) / 2;
  const int nt = NTRI + (has_vec ? D : 0);
  const int per_v = D * D + (has_vec ? D : 0) + (part_ll ? 1 : 0);
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(vb) * per_v) return;
  const int e = static_cast<int>(idx / vb);
  const int v = static_cast<int>(idx % vb);
  if (e < D * D) {
    int j = e / D, k = e % D;
    if (j > k) {
      const int t = j;
      j = k;
      k = t;
    }
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

template <int VG, int MODE>
cudaError_t launch_wide_vg(const WideArgs& a, int splits, int zsplit,
                           cudaStream_t st) {
  const int NV = VG > 0 ? VG : 1;
  const size_t smem = wide_smem(VG, MODE, a.nc, a.np, a.tile, a.hsm != 0);
  const dim3 grid((a.vb + NV - 1) / NV, splits, zsplit);
  cudaError_t err;
  if (a.sscale) {
    err = cudaFuncSetAttribute(wide_kernel<VG, MODE, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    wide_kernel<VG, MODE, true><<<grid, kWideThreads, smem, st>>>(a);
  } else {
    err = cudaFuncSetAttribute(wide_kernel<VG, MODE, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    wide_kernel<VG, MODE, false><<<grid, kWideThreads, smem, st>>>(a);
  }
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_wide_mode(const WideArgs& a, int splits, int vg, int zsplit,
                             cudaStream_t st) {
  switch (vg) {
    case 8: return launch_wide_vg<8, MODE>(a, splits, zsplit, st);
    case 4: return launch_wide_vg<4, MODE>(a, splits, zsplit, st);
    case 2: return launch_wide_vg<2, MODE>(a, splits, zsplit, st);
    case 1: return launch_wide_vg<1, MODE>(a, splits, zsplit, st);
    default: return launch_wide_vg<0, MODE>(a, splits, zsplit, st);
  }
}

}  // namespace

// mode 0 = logistic, 1 = firth2 (K16; feat [npad, nc+2] = [c | y | mask],
// beta [vb, d], hinv [vb, d, d] in mode 1, active [vb] u8), 2 = moments
// (K15; feat [npad, nc+1] = [cy | mask], beta / hinv / active unused).
// packed [vb, nb_bytes] u8; covj [np] int32 (0: no covariate factor, else
// the table column that multiplies G_p); gw [vb, np, 3]; sscale [npad] or
// null; part [splits, NT, vb] f32 and part_ll [splits, vb] f64 scratch;
// out_mat [vb, d, d], out_vec [vb, d], out_ll [vb] f64 (d = nc + np).  dos
// [vb, npad] u16 or null: the dense mode (np = 1, gw (1, 0, 0), packed
// unused).
PT_EXPORT int pt_glm_wide(const void* packed, long long nb_bytes, int vb,
                          const void* feat, long long npad, int nc, int np,
                          const void* covj, int mode, long long split_len,
                          int splits, const void* gw, const void* beta,
                          const void* hinv, const void* active,
                          const void* sscale, const void* dos, void* part,
                          void* part_ll, void* out_mat, void* out_vec,
                          void* out_ll, void* stream) {
  if (mode < 0 || mode > 2 || nc < 1 || np < 1 || split_len % 4 != 0)
    return cudaErrorInvalidValue;
  const int D = nc + np;
  const int ipv = wide_items(D, mode);
  constexpr size_t kSmemMax = 220 * 1024;
  int vg = 8, tile = 0;
  bool hsm = true;
  while (vg > 1 && (vg * ipv > kWideThreads * kWideItems ||
                    wide_smem(vg, mode, nc, np) > 200 * 1024))
    vg /= 2;
  if (wide_smem(vg, mode, nc, np) > kSmemMax) {  // one variant, smaller tiles
    vg = 0;
    for (int pass = 0; pass < 2 && !tile; ++pass) {
      hsm = pass == 0;
      for (int t = 128; t >= 4 && !tile; t /= 2)
        if (wide_smem(0, mode, nc, np, t, hsm) <= kSmemMax) tile = t;
    }
    if (!tile) return cudaErrorInvalidValue;
  }
  const int zsplit = vg <= 1 ? (ipv + kWideThreads * kWideItems - 1) /
                                   (kWideThreads * kWideItems)
                             : 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  WideArgs a{static_cast<const uint8_t*>(packed), nb_bytes, vb,
             static_cast<const float*>(feat), npad, nc, np,
             static_cast<const int*>(covj), split_len,
             static_cast<const float*>(gw), static_cast<const float*>(beta),
             static_cast<const float*>(hinv), static_cast<const uint8_t*>(active),
             static_cast<const float*>(sscale), static_cast<float*>(part),
             static_cast<double*>(part_ll), static_cast<const uint16_t*>(dos),
             tile, hsm ? 1 : 0};
  cudaError_t err = mode == 0   ? launch_wide_mode<0>(a, splits, vg, zsplit, st)
                    : mode == 1 ? launch_wide_mode<1>(a, splits, vg, zsplit, st)
                                : launch_wide_mode<2>(a, splits, vg, zsplit, st);
  if (err != cudaSuccess) return err;
  const int has_vec = mode != 2;
  const double* pll = mode == 0 ? static_cast<const double*>(part_ll) : nullptr;
  const int per_v = D * D + (has_vec ? D : 0) + (pll ? 1 : 0);
  const int64_t total = static_cast<int64_t>(vb) * per_v;
  wide_reduce_kernel<<<static_cast<int>((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), pll, splits, vb, D, has_vec,
      static_cast<float*>(out_mat), static_cast<float*>(out_vec),
      static_cast<double*>(out_ll));
  return cudaGetLastError();
}
