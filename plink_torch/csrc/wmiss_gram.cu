// K23 wmiss_gram: the weighted joint-missing Gram of one sample tile, summed
// over every variant in one launch.
//
// Replaces (plink_tpu/ops/pairwise.py) `wmiss_gram_tile` (:89), five int8
// matmuls over the 7-bit limbs of uint32 weights (`weight_limbs`, :128),
// recombined by the caller as sum_k 2^(7k) block_k
// (plink_tpu/commands/distance.py:98-103).  Here the tile's entries are
//   out[i][j] = sum over included variants m of w_m miss_{m,i} miss_{m,j}
// (miss = 2-bit code 3) directly, in uint64: exact for any variant count,
// where the reference's int32 limb sums hold only below ~16.9M variants.
//
// Bound: operations.  The reference's formulation is 5 s t V int8
// multiply-adds (one per limb), 0.69 ms per 2,048 x 2,048 tile at V = 32,768
// and 1,979 TOPS; this kernel does one AND a pair and 32-variant word
// (s t V / 32 of them).  Design (K7's, csrc/king_gram.cu): a first kernel
// transposes the tile's samples into variant-masked 32-variant bit words of
// the missing plane (one warp ballot per sample; lane = variant) into a
// scratch buffer; the second walks 64 x 64 pair tiles (4 x 4 pairs a
// thread) with kWords words of each side and their 32 weights apiece staged
// in shared memory.  For each pair and word it forms x = miss_i & miss_j
// and adds w[32 word + ffs(x) - 1] for each set bit.  Joint missingness is
// rare (2% x 2% on the bench panels), so the set-bit loop seldom runs; a
// thread first ANDs the OR of its four rows with the OR of its four columns
// and skips the word when that is 0.  Integer sums only, no atomics: two
// runs give identical bytes.
#include "common.cuh"

namespace {

constexpr int kGroup = 16;       // samples per warp in the transpose
constexpr int kTile = 64;        // pairs per block side
constexpr int kWords = 16;       // 32-variant words per shared-memory step
constexpr int kThreads = 256;    // 16 x 16 threads, 4 x 4 pairs each

// planes [W][spad]: per 32-variant word w and tile sample k the bits of the
// missing plane; rows take k in [0, s64), columns [s64, s64 + t64), each
// side zero past its length.
__global__ void __launch_bounds__(kThreads)
wmiss_planes_kernel(const uint8_t* __restrict__ packed, int64_t nb_bytes,
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
  const bool aligned = ((nb_bytes & 3) == 0) && ((first & 15) == 0) &&
                       ((reinterpret_cast<uintptr_t>(packed) & 3) == 0);
  for (int64_t w = blockIdx.y; w < nwords; w += gridDim.y) {
    const int64_t v = w * 32 + lane;
    uint32_t x = 0;
    bool vm = false;
    if (v < nvar && k0 < len) {
      x = load_codes16(packed + v * nb_bytes, nb_bytes, first, aligned);
      vm = vmask[v] != 0;
    }
    uint32_t mine = 0u;
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const bool miss = vm && (k0 + q < len) && ((x >> (2 * q)) & 3u) == 3u;
      const uint32_t m = __ballot_sync(0xffffffffu, miss);
      if (lane == q) mine = m;
    }
    if (lane < kGroup) {
      const int64_t spad = s64 + t64;
      planes[w * spad + (is_row ? 0 : s64) + k0 + lane] = mine;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
wmiss_gram_kernel(const uint32_t* __restrict__ planes,
                  const int64_t* __restrict__ weights, int64_t nvar,
                  int64_t nwords, int s64, int t64, int s, int t,
                  int64_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t sr[kWords][kTile];
  __shared__ __align__(16) uint32_t sc[kWords][kTile];
  __shared__ uint32_t sw[kWords * 32];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int rb = blockIdx.y * kTile, cb = blockIdx.x * kTile;
  const int64_t spad = s64 + t64;
  unsigned long long acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0ull;

  for (int64_t w0 = 0; w0 < nwords; w0 += kWords) {
    __syncthreads();
    // 2 sides x kWords words x 64 samples = 512 uint4 loads
    for (int i = threadIdx.x; i < 2 * kWords * (kTile / 4); i += kThreads) {
      const int q = i % (kTile / 4);
      const int ww = (i / (kTile / 4)) % kWords;
      const int side = i / (kTile / 4 * kWords);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (w0 + ww < nwords) {
        const int64_t base = (w0 + ww) * spad + (side ? s64 + cb : rb) + 4 * q;
        val = *reinterpret_cast<const uint4*>(planes + base);
      }
      uint32_t* dst = side ? &sc[ww][4 * q] : &sr[ww][4 * q];
      *reinterpret_cast<uint4*>(dst) = val;
    }
    for (int i = threadIdx.x; i < kWords * 32; i += kThreads) {
      const int64_t v = w0 * 32 + i;
      sw[i] = v < nvar ? static_cast<uint32_t>(weights[v]) : 0u;
    }
    __syncthreads();
    for (int ww = 0; ww < kWords; ++ww) {
      const uint4 r4 = *reinterpret_cast<const uint4*>(&sr[ww][4 * ty]);
      const uint4 c4 = *reinterpret_cast<const uint4*>(&sc[ww][4 * tx]);
      if (((r4.x | r4.y | r4.z | r4.w) & (c4.x | c4.y | c4.z | c4.w)) == 0u) continue;
      const uint32_t R[4] = {r4.x, r4.y, r4.z, r4.w};
      const uint32_t C[4] = {c4.x, c4.y, c4.z, c4.w};
      const uint32_t* wts = sw + 32 * ww;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t x = R[i] & C[j];
          while (x) {
            acc[i][j] += wts[__ffs(x) - 1];
            x &= x - 1u;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rb + 4 * ty + i;
    if (r >= s) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = cb + 4 * tx + j;
      if (c >= t) continue;
      out[static_cast<int64_t>(r) * t + c] = static_cast<int64_t>(acc[i][j]);
    }
  }
}

}  // namespace

// packed [nvar, nb_bytes] u8 (the [nb, vb, NB] blocks, flattened); vmask
// [nvar] i8; weights [nvar] i64 holding uint32 values; the tile is samples
// [row0, row0 + s) x [col0, col0 + t), both inside the packed rows.
// planes: u32 scratch of ceil(nvar / 32) * (s64 + t64) words, s64 / t64 =
// s / t rounded up to 64.  Writes out i64 [s, t].
PT_EXPORT int pt_wmiss_gram(const void* packed, long long nb_bytes, long long nvar,
                            const void* vmask, const void* weights,
                            long long row0, int s, long long col0, int t,
                            void* planes, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s <= 0 || t <= 0) return cudaSuccess;
  const int s64 = (s + kTile - 1) / kTile * kTile;
  const int t64 = (t + kTile - 1) / kTile * kTile;
  const int64_t nwords = (nvar + 31) / 32;
  if (nwords == 0) {
    return cudaMemsetAsync(out, 0, sizeof(int64_t) * static_cast<size_t>(s) * t, st);
  }
  const int groups = (s64 + t64) / kGroup;
  const dim3 g1((groups + kThreads / 32 - 1) / (kThreads / 32),
                static_cast<unsigned>(nwords < 65535 ? nwords : 65535));
  wmiss_planes_kernel<<<g1, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(packed), nb_bytes, nvar,
      static_cast<const int8_t*>(vmask), row0, s, col0, t, s64, t64, nwords,
      static_cast<uint32_t*>(planes));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g2(t64 / kTile, s64 / kTile);
  wmiss_gram_kernel<<<g2, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(planes), static_cast<const int64_t*>(weights),
      nvar, nwords, s64, t64, s, t, static_cast<int64_t*>(out));
  return cudaGetLastError();
}
