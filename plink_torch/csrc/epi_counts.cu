// K24 epi_joint_counts, with its packing pass epi_split_planes: the 3 x 3
// joint-genotype tables of --fast-epistasis.
//
// Replaces plink_tpu/commands/epistasis.py:596-621 (B8): per case / control
// group g, the int8 split planes of a row block [3B, S_g] (B = 256 rows, 96
// with `boost`) times the group's planes of all M kept variants [S_g, 3M]^T
// -> int32 [3B, 3M], reshaped into each (row, column) pair's table.  Here,
// for each group g, row i of the block and kept variant j,
//   out[g, i, j, 3 a + b] = #(samples s in g: plane_a(rows[i], s) &
//                                             plane_b(j, s))
// with the planes [hom A1, het, hom A2] (epistasis.py:539-542), A1 = ALT
// where a1_is_alt (:530-534), and missing calls in no plane.  The output is
// pair-major [G, nb, M, 9], so the host reads each pair's table with no
// transpose.  Counts are exact, so the tables equal plink_tpu's on either
// of its routes (its host int32 matmul or its device dot).
//
// Design (K13's, csrc/ld_band.cu): epi_split_planes packs, once a run, each
// kept variant's three planes over each group's samples into 32-sample bit
// words, laid out [plane][word][variant] with the groups' words one after
// the other; epi_joint_counts takes a 64 (row) x 64 (column) tile of pairs a
// block and one group a grid z-slice, 4 x 4 pairs a thread, stages 8 words
// of the tile's rows and columns in shared memory, and counts each pair
// with nine AND + popcounts a word in integer registers (no atomics).  The
// whole [nb, M] rectangle is counted, so every entry is written (also those
// at or below the diagonal that the host does not read).
// Bound: operations.  The popcounts, 9 * nb * M * words (3.0e9 a block of
// 256 rows at 4,096 variants and two groups of ~5,000 samples), at 16 a
// clock per SM: ~0.7 ms; B8's own int8 product on the tensor cores, 2 * 3nb
// * 3M * S (1.9e11), ~0.1 ms; the int32 output (75 MB) 0.02 ms.
#include "common.cuh"

namespace {

constexpr int kRows = 64;      // block rows a tile
constexpr int kCols = 64;      // kept variants a tile
constexpr int kW = 8;          // 32-sample words a shared stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 pairs each

// planes [3][wtot][m]: one thread per (kept variant, word), neighbouring
// threads on neighbouring variants so the writes coalesce.  Word w belongs
// to the group g with wofs[g] <= w < wofs[g + 1] and holds, in bit q, sample
// samples[sofs[g] + 32 (w - wofs[g]) + q] (bits past the group's last sample
// are 0).  meta = [wofs[0..G], sofs[0..G]].
__global__ void epi_split_planes_kernel(const uint8_t* __restrict__ packed,
                                        int64_t nb_bytes,
                                        const int64_t* __restrict__ vidx,
                                        const uint8_t* __restrict__ a1_is_alt,
                                        int64_t m, const int* __restrict__ samples,
                                        const int* __restrict__ meta, int groups,
                                        int64_t wtot, uint32_t* __restrict__ planes) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= m * wtot) return;
  const int64_t v = idx % m, w = idx / m;
  int g = 0;
  while (g + 1 < groups && w >= meta[g + 1]) ++g;
  const int* sofs = meta + groups + 1;
  const int64_t s0 = sofs[g] + 32 * (w - meta[g]);
  const int64_t s1 = min(s0 + 32, static_cast<int64_t>(sofs[g + 1]));
  const uint8_t* row = packed + vidx[v] * nb_bytes;
  // hom A1 is code 2 (two ALT copies) where A1 = ALT, code 0 elsewhere
  const uint32_t a1_code = a1_is_alt[v] ? 2u : 0u;
  uint32_t hom1 = 0, het = 0, hom2 = 0;
  for (int64_t s = s0; s < s1; ++s) {
    const int smp = samples[s];
    const uint32_t c = (row[smp >> 2] >> (2 * (smp & 3))) & 3u;
    const uint32_t bit = 1u << (s - s0);
    if (c == 1u)
      het |= bit;
    else if (c == a1_code)
      hom1 |= bit;
    else if (c != 3u)
      hom2 |= bit;
  }
  planes[(0 * wtot + w) * m + v] = hom1;
  planes[(1 * wtot + w) * m + v] = het;
  planes[(2 * wtot + w) * m + v] = hom2;
}

// out [G][nb][m][9] i32: grid (column tiles, row tiles, group).
__global__ void __launch_bounds__(kThreads)
epi_counts_kernel(const uint32_t* __restrict__ planes, int64_t m, int64_t wtot,
                  const int* __restrict__ wofs, const int* __restrict__ rows,
                  int nb, int* __restrict__ out) {
  __shared__ __align__(16) uint32_t rs[3][kW][kRows];
  __shared__ __align__(16) uint32_t cs[3][kW][kCols];
  const int t = threadIdx.x;
  const int tx = t & 15, ty = t >> 4;  // j = j0 + 4 tx + b, i = i0 + 4 ty + a
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kCols;
  const int i0 = blockIdx.y * kRows;
  const int g = blockIdx.z;
  const int64_t wb = wofs[g], we = wofs[g + 1];
  int acc[9][4][4];
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[k][a][b] = 0;

  for (int64_t w0 = wb; w0 < we; w0 += kW) {
    __syncthreads();
    for (int e = t; e < 3 * kW * kRows; e += kThreads) {
      const int c = e % kRows, ww = (e / kRows) % kW, p = e / (kRows * kW);
      const int i = i0 + c;
      const int64_t w = w0 + ww;
      rs[p][ww][c] = (i < nb && w < we) ? planes[(p * wtot + w) * m + rows[i]] : 0u;
    }
    for (int e = t; e < 3 * kW * kCols; e += kThreads) {
      const int c = e % kCols, ww = (e / kCols) % kW, p = e / (kCols * kW);
      const int64_t j = j0 + c, w = w0 + ww;
      cs[p][ww][c] = (j < m && w < we) ? planes[(p * wtot + w) * m + j] : 0u;
    }
    __syncthreads();
#pragma unroll 2
    for (int ww = 0; ww < kW; ++ww) {
      uint32_t x[3][4], y[3][4];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const uint4 u = *reinterpret_cast<const uint4*>(&rs[p][ww][4 * ty]);
        const uint4 v = *reinterpret_cast<const uint4*>(&cs[p][ww][4 * tx]);
        x[p][0] = u.x; x[p][1] = u.y; x[p][2] = u.z; x[p][3] = u.w;
        y[p][0] = v.x; y[p][1] = v.y; y[p][2] = v.z; y[p][3] = v.w;
      }
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              acc[3 * p + q][a][b] += __popc(x[p][a] & y[q][b]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + 4 * ty + a;
    if (i >= nb) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int64_t j = j0 + 4 * tx + b;
      if (j >= m) continue;
      int* o = out + ((static_cast<int64_t>(g) * nb + i) * m + j) * 9;
#pragma unroll
      for (int k = 0; k < 9; ++k) o[k] = acc[k][a][b];
    }
  }
}

}  // namespace

// packed [V, nb_bytes] u8 (the whole fileset), vidx [m] i64 (the kept
// variants' rows), a1_is_alt [m] u8, samples [sofs[G]] i32 (the groups'
// sample indices, group after group), meta [2 (G + 1)] i32 = wofs, sofs (on
// the device) -> planes [3, wtot, m] u32 with wtot = wofs[G].
PT_EXPORT int pt_epi_split_planes(const void* packed, long long nb_bytes,
                                  const void* vidx, const void* a1_is_alt,
                                  long long m, const void* samples, const void* meta,
                                  int groups, long long wtot, void* planes,
                                  void* stream) {
  const int64_t total = m * wtot;
  if (total <= 0) return cudaSuccess;
  if (groups < 1) return cudaErrorInvalidValue;
  epi_split_planes_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), nb_bytes, static_cast<const int64_t*>(vidx),
      static_cast<const uint8_t*>(a1_is_alt), m, static_cast<const int*>(samples),
      static_cast<const int*>(meta), groups, wtot, static_cast<uint32_t*>(planes));
  return cudaGetLastError();
}

// planes [3, wtot, m] u32 (pt_epi_split_planes), wofs [G + 1] i32 (on the
// device), rows [nb] i32 (indices into the m kept variants) -> out [G, nb,
// m, 9] i32.
PT_EXPORT int pt_epi_joint_counts(const void* planes, long long m, long long wtot,
                                  const void* wofs, int groups, const void* rows,
                                  int nb, void* out, void* stream) {
  if (m <= 0 || nb <= 0) return cudaSuccess;
  if (groups < 1) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((m + kCols - 1) / kCols),
                  static_cast<unsigned>((nb + kRows - 1) / kRows),
                  static_cast<unsigned>(groups));
  epi_counts_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(planes), m, wtot, static_cast<const int*>(wofs),
      static_cast<const int*>(rows), nb, static_cast<int*>(out));
  return cudaGetLastError();
}
