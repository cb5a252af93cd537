// K13 ld_gram_pair: the R/A/V plane Gram of two variant chunks (the LD
// matrix modes and the phased joint counts), as int8 plane Grams on the
// tensor cores.
//
// Replaces (plink_tpu/ops/ld.py) `ld_gram_pair` (:44): G [3Ca, 3Cb] int32,
// G[p Ca + i][q Cb + j] = sum over the masked samples of plane_p(a_i) *
// plane_q(b_j) for p, q in (R = hom-REF, A = hom-ALT, V = valid); every sum
// is exact in int32 (at most the sample count).
//
// Bound: operations.  9 Ca Cb n int8 multiply-adds on the tensor cores,
// 0.024 ms at 512 x 512 x 10,000 and 1,979 TOPS, 0.006 ms at 256 x 256;
// bytes (the chunks' codes, the mask, 9.4 MB of int32 out at 512) 0.004 ms.
//
// Design.  The packed rows are K-major already: a variant's samples are
// contiguous, 4 to a byte.  A CTA takes 64 variants of chunk a by 64 of
// chunk b in stages of 128 samples, with one producer and three consumer
// warpgroups (warp specialization: with every warp decoding, then issuing,
// as K7 does, the decode and wgmma times added up; PERF.md has the
// measured steps):
//  - the producer copies each stage's 128 variants' 32 code bytes and 128
//    mask bytes with cp.async into a ring of three stages, two ahead
//    (16-byte pieces, aligned 16-byte windows around them, or bytes, as the
//    rows' alignment allows), and decodes each row's eight words together
//    into the K-major R / A / V tiles of both chunks (one prmt per four
//    codes and plane, hop::code_plane; chunk a's with the stage's masked
//    samples set missing, which then holds for every product), in one of
//    two buffers;
//  - consumer p issues per k32 step p_a x [R_b; A_b; V_b] (m64n192k32), all
//    nine plane products of the tile pair from the one decode, into 96 s32
//    accumulators a thread;
//  - named barriers hand each buffer from the producer to the consumers
//    (full) and back once their wgmmas are done (empty).
// Chunks of a few hundred variants give few tiles, so the samples are split
// over grid.z until the CTAs fill the 132 SMs once (at most 6 splits); the
// splits of a tile form a thread block cluster, and the cluster adds their
// counts through distributed shared memory in split order, each CTA a part
// of the tile, before plain stores: no atomics, no memset, and two runs give
// identical bytes.  No bit-plane pre-pass and no scratch.
// K13_CUT_{COPIES,DECODE,WGMMA,STORE} leave one part out and K13_MAX_SPLITS
// caps the split otherwise, for tools/gram_breakdown.py's timings only (a
// cut build's counts are wrong).
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kV = 64;                 // variants of each chunk a CTA
constexpr int kKS = 128;               // samples a stage: four k32 steps
constexpr int kStageBytes = kKS / 4;   // code bytes a variant a stage
constexpr int kConsumers = 384;        // three warpgroups: plane R, A, V of a
constexpr int kProducers = 128;        // one warpgroup: copies and decode
constexpr int kThreads = kConsumers + kProducers;
constexpr int kCodeStride = 48;        // bytes a staged variant (16 pad)
constexpr int kSlots = 3;              // stages in the ring
constexpr int kMaskOff = 2 * kV * kCodeStride;
constexpr int kCodeSlot = kMaskOff + kKS;  // codes, then the stage's mask
constexpr int kPlane = kV / 8 * 256;       // one plane of one chunk, one k32
constexpr int kStep = 6 * kPlane;          // R, A, V of a; R, A, V of b
constexpr int kBuf = 4 * kStep;            // a stage's planes
constexpr int kPatOff = 2 * kBuf + kSlots * kCodeSlot;  // two stages' missing patterns
constexpr int kAcc = 96;                   // s32 accumulators a consumer
constexpr int kTile = 3 * kV;              // the CTA's counts: [3 x 64][3 x 64]
constexpr int kRedStride = kTile + 8;      // ints a row (conflict-free pair stores)
constexpr int kRed = kTile * kRedStride * 4;
constexpr int kSmem = kPatOff + 64 > kRed ? kPatOff + 64 : kRed;  // 153,600 bytes
#ifndef K13_MAX_SPLITS
#define K13_MAX_SPLITS 6  // a cluster a tile (clusters of 8 ran slower)
#endif
// named barriers: buffer b full (kFull + b), empty (kEmpty + b), the
// producers, and every warp past the stages
constexpr int kFull = 1, kEmpty = 3, kProd = 5, kDone = 6;
constexpr int kSMs = 132;  // one CTA an SM

// plane table of R, A or V (byte k: value for code k = hom-REF, het,
// hom-ALT, missing)
__device__ __forceinline__ uint32_t plane_table(int p) {
  return p == 0 ? 0x00000001u : (p == 1 ? 0x00010000u : 0x00010101u);
}

struct Args {
  const uint8_t* pa;
  const uint8_t* pb;
  int64_t ca, cb, nb;  // chunk lengths, bytes a row
  const int8_t* smask;
  int64_t npad;
  int64_t stages_per_split;
  int64_t nstages;
  int* g;
};

// Where the stage's code bytes of a row start in its slot row: 0, or the
// row's offset from 16-byte alignment when its stage is a window (W = 4).
template <int W>
__device__ __forceinline__ int row_off(const uint8_t* row) {
  return W == 4 ? static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15) : 0;
}

// Copy `len` (<= W) bytes of src into dst and zero the rest of its W bytes.
template <int W>
__device__ __forceinline__ void copy_piece(uint8_t* dst, const uint8_t* src, int64_t len) {
  const int n = len <= 0 ? 0 : (len >= W ? W : static_cast<int>(len));
  if constexpr (W == 1) {
    *dst = n ? *src : 0;
  } else {
    hop::cp_async<W>(dst, src, n);  // n = 0 reads nothing
  }
}

// A producer thread's copies: 16-byte pieces of the stage's 128 rows
// (chunk a's 64, then chunk b's), fixed once a CTA.  W = 16: rows 16-byte
// aligned, the stage's 32 bytes as two pieces; W = 4: rows 4-byte aligned
// (bases 16-byte aligned), the 48-byte window of three aligned pieces that
// holds them, at offset row_off of the slot's row (the window may start in
// the row before; it never reads past its own row).  A row past its chunk
// is not copied (it is decoded as missing).
template <int W>
struct Copier {
  static constexpr int kPieces = W == 16 ? 2 : 3;  // pieces a row
  static constexpr int kN = (2 * kV * kPieces + kProducers - 1) / kProducers;
  const uint8_t* src[kN];  // the piece at stage 0 (nullptr: none)
  int dst[kN];             // its offset in a slot
  int off[kN];             // its offset from the stage's first byte of the row
  __device__ Copier(const Args& a, int64_t i0, int64_t j0, int pt) {
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int e = pt + k * kProducers;
      const int r = e / kPieces, q = e % kPieces;
      const int64_t v = r < kV ? i0 + r : j0 + r - kV;
      src[k] = nullptr;
      dst[k] = r * kCodeStride + 16 * q;
      off[k] = 16 * q;
      if (e < 2 * kV * kPieces && v < (r < kV ? a.ca : a.cb)) {
        const uint8_t* row = (r < kV ? a.pa : a.pb) + v * a.nb;
        off[k] -= row_off<W>(row);
        src[k] = row + off[k];
      }
    }
  }
};

// producer thread pt's copies of stage `st` (global stage index) into its
// ring slot: fixed sources inside the rows, checked lengths at their end
template <int W>
__device__ __forceinline__ void issue_stage(const Args& a, const Copier<W>& cp, int64_t i0,
                                            int64_t j0, int64_t st, uint8_t* ring, int pt) {
  uint8_t* slot = ring + (st % kSlots) * kCodeSlot;
  const int64_t b0 = st * kStageBytes;  // first byte of the stage in a row
  if constexpr (W == 1) {  // rows off 4-byte alignment: synchronous bytes
    for (int e = pt; e < 2 * kV * kStageBytes; e += kProducers) {
      const int r = e / kStageBytes, q = e % kStageBytes;
      const int64_t v = r < kV ? i0 + r : j0 + r - kV;
      if (v < (r < kV ? a.ca : a.cb))
        copy_piece<1>(slot + r * kCodeStride + q, (r < kV ? a.pa : a.pb) + v * a.nb + b0 + q,
                      a.nb - b0 - q);
    }
  } else {
#pragma unroll
    for (int k = 0; k < Copier<W>::kN; ++k)
      if (cp.src[k] != nullptr)
        copy_piece<16>(slot + cp.dst[k], cp.src[k] + b0, a.nb - b0 - cp.off[k]);
  }
  const int64_t s0 = st * kKS;  // the mask: 16-byte aligned unless W = 1
  constexpr int kM = W == 1 ? 1 : 16;
  for (int e = pt; e < kKS / kM; e += kProducers)
    copy_piece<kM>(slot + kMaskOff + e * kM,
                   reinterpret_cast<const uint8_t*>(a.smask) + s0 + e * kM,
                   a.npad - s0 - e * kM);
}

// 1 in each byte of m that is 0 (a masked sample), else 0
__device__ __forceinline__ uint32_t zero_bytes(uint32_t m) {
  const uint32_t nz = (((m & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | m) & 0x80808080u;
  return (~nz >> 7) & 0x01010101u;
}

// The missing pattern of 16 samples' mask bytes: code 3 (0b11) in the
// 2-bit field of each masked sample; OR-ed into a variant's codes it makes
// every plane 0 there.
__device__ __forceinline__ uint32_t missing_pattern(uint4 m) {
  const uint32_t z4[4] = {zero_bytes(m.x), zero_bytes(m.y), zero_bytes(m.z),
                          zero_bytes(m.w)};
  uint32_t pat = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // bits 0, 8, 16, 24 -> 0, 2, 4, 6
    uint32_t z = z4[k];
    z |= z >> 6;
    z = (z | (z >> 12)) & 0x55u;
    pat |= (z * 3u) << (8 * k);
  }
  return pat;
}

// The producer thread's row of the stage (pt: chunk a's rows, then chunk
// b's, so each warp takes one chunk), fixed once a CTA.
struct DecodeRow {
  int r;        // row of the stage
  bool in;      // inside its chunk (else decoded as missing)
  int src;      // where its code bytes start in a slot
  int dst;      // its core-matrix rows in a plane buffer
};

template <int W>
__device__ __forceinline__ DecodeRow decode_row(const Args& a, int64_t i0, int64_t j0,
                                                int pt) {
  const bool side_a = pt < kV;
  const int64_t v = side_a ? i0 + pt : j0 + pt - kV;
  const bool in = v < (side_a ? a.ca : a.cb);
  return {pt, in,
          pt * kCodeStride + (in ? row_off<W>((side_a ? a.pa : a.pb) + v * a.nb) : 0),
          (side_a ? 0 : 3 * kPlane) + hop::s8_off(pt % kV, 0)};
}

// decode the row's 128 codes of stage `st` into the R / A / V tiles of
// `buf` (four k32 steps), chunk a's with the stage's missing pattern `pat`;
// quarter-warps write whole core matrices
template <int W>
__device__ __forceinline__ void decode_stage(const DecodeRow& dr, int64_t st,
                                             const uint8_t* ring, const uint32_t* pat,
                                             uint8_t* buf) {
  const uint8_t* src = ring + (st % kSlots) * kCodeSlot + dr.src;
  uint32_t w8[8];  // samples 16 k..16 k + 15
  if (W == 4) {    // the window's offset: 4-byte loads
#pragma unroll
    for (int k = 0; k < 8; ++k) w8[k] = reinterpret_cast<const uint32_t*>(src)[k];
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 c = reinterpret_cast<const uint4*>(src)[h];
      w8[4 * h] = c.x;
      w8[4 * h + 1] = c.y;
      w8[4 * h + 2] = c.z;
      w8[4 * h + 3] = c.w;
    }
  }
  const bool side_a = dr.r < kV;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (!dr.in) w8[k] = ~0u;  // past the chunk: missing
    else if (side_a) w8[k] |= pat[k];
  }
  uint8_t* base = buf + dr.dst;
#pragma unroll
  for (int k = 0; k < 8; ++k) {  // k32 step k / 2, K half k % 2
    uint32_t sel[4];
    hop::code_selectors(w8[k], sel);
    uint8_t* dst = base + (k >> 1) * kStep + (k & 1) * 128;
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint4*>(dst + p * kPlane) = hop::code_plane(sel, plane_table(p));
  }
}

template <int W>
__device__ __forceinline__ void produce(const Args& a, int64_t i0, int64_t j0, int64_t sb,
                                        int64_t se, uint8_t* smem, int pt) {
  uint8_t* ring = smem + 2 * kBuf;
  uint32_t* pat = reinterpret_cast<uint32_t*>(smem + kPatOff);  // [2][8]
  const Copier<W> cp(a, i0, j0, pt);
  const DecodeRow dr = decode_row<W>(a, i0, j0, pt);
  for (int64_t st = sb; st < sb + 2; ++st) {
    if (st < se) issue_stage<W>(a, cp, i0, j0, st, ring, pt);
    hop::cp_async_commit();
  }
  for (int64_t st = sb; st < se; ++st) {
    const int b = static_cast<int>((st - sb) & 1);
    // stage st's codes are in, and every producer is past stage st - 1's
    // decode (the last reader of the slot the copies of st + 2 go to)
    hop::cp_async_wait<1>();
    hop::named_sync(kProd, kProducers);
#ifndef K13_CUT_COPIES
    if (st + 2 < se) issue_stage<W>(a, cp, i0, j0, st + 2, ring, pt);
#endif
    hop::cp_async_commit();
    if (pt < kKS / 16)
      pat[8 * b + pt] = missing_pattern(*reinterpret_cast<const uint4*>(
          ring + (st % kSlots) * kCodeSlot + kMaskOff + 16 * pt));
    hop::named_sync(kProd, kProducers);
    if (st - sb >= 2) hop::named_sync(kEmpty + b, kThreads);  // stage st - 2's wgmmas done
#ifndef K13_CUT_DECODE
    decode_stage<W>(dr, st, ring, pat + 8 * b, smem + b * kBuf);
#endif
    hop::fence_proxy_async();
    hop::named_arrive(kFull + b, kThreads);
  }
}

// The splits of a tile are one cluster (one CTA when unsplit): each CTA adds
// rows of the tile's counts `red` over the splits, in split order, and
// stores them, neighbouring threads on neighbouring columns.
__device__ __forceinline__ void finish(const Args& a, int64_t i0, int64_t j0, int* red,
                                       int tid) {
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int splits = static_cast<int>(cl.num_blocks());
  const int rows = (kTile + splits - 1) / splits;
  const int m0 = static_cast<int>(cl.block_rank()) * rows;
  const int m1 = min(kTile, m0 + rows);
  for (int x = m0 * (kTile / 4) + tid; x < m1 * (kTile / 4); x += kThreads) {
    const int m = x / (kTile / 4), n = 4 * (x % (kTile / 4));
    int4 sum = make_int4(0, 0, 0, 0);
    for (int q = 0; q < splits; ++q) {
      const int4 v = *reinterpret_cast<const int4*>(cl.map_shared_rank(red, q) +
                                                    m * kRedStride + n);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const int64_t iv = i0 + m % kV, j = j0 + n % kV;
    if (iv >= a.ca) continue;
    int* o = a.g + ((m / kV) * a.ca + iv) * 3 * a.cb + (n / kV) * a.cb + j;
#ifndef K13_CUT_STORE
    if (j + 3 < a.cb && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
      *reinterpret_cast<int4*>(o) = sum;
    } else {
      const int vals[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j + u < a.cb) o[u] = vals[u];
    }
#endif
  }
  cl.sync();  // the peers' counts stay until every CTA has read them
}

template <int W>
__global__ void __launch_bounds__(kThreads, 1) ld_gram_kernel(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // consumers 0-2 (plane wg of chunk a), producer 3
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * kV;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kV;
  const int64_t sb = static_cast<int64_t>(blockIdx.z) * a.stages_per_split;
  const int64_t se = min(a.nstages, sb + a.stages_per_split);
  int* red = reinterpret_cast<int*>(smem);  // [kTile][kRedStride], after the stages

  if (wg == 3) {
    produce<W>(a, i0, j0, sb, se, smem, tid - kConsumers);
    hop::named_sync(kDone, kThreads);  // every warp is past the stages
    finish(a, i0, j0, red, tid);
    return;
  }
  int acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0;
  const uint32_t pbase = hop::smem_u32(smem);
  for (int64_t st = sb; st < se; ++st) {
    const int b = static_cast<int>((st - sb) & 1);
    hop::named_sync(kFull + b, kThreads);
    hop::wgmma_fence();
#ifndef K13_CUT_WGMMA
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint32_t k0 = pbase + b * kBuf + ks * kStep;
      hop::wgmma_m64n192k32_s8_ss(acc, hop::desc_s8(k0 + wg * kPlane),
                                  hop::desc_s8(k0 + 3 * kPlane));
    }
#endif
    hop::wgmma_commit();
    // stage st - 1's wgmmas are done: hand its buffer back if the producer
    // fills it again (stage st + 1 < se)
    hop::wgmma_wait<1>();
    if (st > sb && st + 1 < se) hop::named_arrive(kEmpty + (b ^ 1), kThreads);
  }
  hop::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < kAcc; ++i) hop::fence_operand(acc[i]);
  hop::named_sync(kDone, kThreads);  // the buffers are free for the counts
  // accumulator i: row 64 wg + 16 warp + lane / 4 + 8 ((i / 2) % 2) of the
  // tile (plane wg of chunk a), column 8 (i / 4) + 2 (lane % 4) + i % 2
  // (R_b, A_b, V_b by 64)
  const int warp = (tid >> 5) & 3, lane = tid & 31;
#pragma unroll
  for (int i = 0; i < kAcc; i += 2) {
    const int m = 64 * wg + 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
    const int n = 8 * (i >> 2) + 2 * (lane & 3);
    *reinterpret_cast<int2*>(red + m * kRedStride + n) = make_int2(acc[i], acc[i + 1]);
  }
  finish(a, i0, j0, red, tid);
}

template <int W>
cudaError_t launch(const Args& a, dim3 grid, cudaStream_t st) {
  static bool sized = false;  // the shared-memory limit, set once
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        ld_gram_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = grid.z;  // the splits of a tile
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, ld_gram_kernel<W>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// K13: pka [ca, nb_bytes], pkb [cb, nb_bytes] u8, smask [npad = 4 nb_bytes]
// i8 -> g [3 ca, 3 cb] i32.
PT_EXPORT int pt_ld_gram_pair(const void* pka, long long ca, const void* pkb,
                              long long cb, long long nb_bytes, const void* smask,
                              long long npad, void* g, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ca <= 0 || cb <= 0) return cudaSuccess;
  if (npad != 4 * nb_bytes) return cudaErrorInvalidValue;
  const int64_t nstages = (npad + kKS - 1) / kKS;
  if (nstages == 0)
    return cudaMemsetAsync(g, 0, static_cast<size_t>(9) * ca * cb * sizeof(int), st);
  // split the samples until the CTAs (one an SM) fill the card once
  const int64_t tiles = ((ca + kV - 1) / kV) * ((cb + kV - 1) / kV);
  int64_t splits = kSMs / tiles;
  splits = splits < 1 ? 1 : (splits > K13_MAX_SPLITS ? K13_MAX_SPLITS : splits);
  splits = splits > nstages ? nstages : splits;
  const int64_t per = (nstages + splits - 1) / splits;
  splits = (nstages + per - 1) / per;
  const Args a{static_cast<const uint8_t*>(pka), static_cast<const uint8_t*>(pkb), ca, cb,
               nb_bytes, static_cast<const int8_t*>(smask), npad, per, nstages,
               static_cast<int*>(g)};
  const dim3 grid(static_cast<unsigned>((cb + kV - 1) / kV),
                  static_cast<unsigned>((ca + kV - 1) / kV), static_cast<unsigned>(splits));
  // 16-byte pieces when every row start is aligned, windows when the rows
  // are 4-byte aligned, else bytes
  const uintptr_t bases = reinterpret_cast<uintptr_t>(pka) |
                          reinterpret_cast<uintptr_t>(pkb) | reinterpret_cast<uintptr_t>(smask);
  if ((bases & 15) == 0 && (nb_bytes & 15) == 0) return launch<16>(a, grid, st);
  if ((bases & 15) == 0 && (nb_bytes & 3) == 0) return launch<4>(a, grid, st);
  return launch<1>(a, grid, st);
}
