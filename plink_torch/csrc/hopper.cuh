// Hopper (sm_90a) building blocks of the tensor-core kernels: cp.async
// copies, the warpgroup matrix multiply (wgmma) with its fences, the shared
// memory descriptor of an operand without swizzle, the exact split of an
// f32 into three bf16 parts, and the int8 plane Gram: the s8 wgmma with
// both operands in shared memory, the layout of its K-major tiles and the
// decode of 2-bit genotype codes into int8 planes.
//
// Layout of a wgmma operand in shared memory (K-major, no swizzle): a core
// matrix is 8 rows x 16 bytes (8 bf16 or 16 int8 along K), stored as 128
// contiguous bytes; `lbo` is the byte distance between the two core
// matrices of a row group along K (k 0-7 and 8-15 of a bf16 k16 step, k
// 0-15 and 16-31 of an int8 k32 step), `sbo` the distance between
// neighbouring groups of 8 rows.
#pragma once

#include <cstdint>

namespace hop {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous copy of BYTES (4, 8 or 16) from global to shared memory;
// only the first `src_bytes` are read, the rest of the destination is
// zero-filled (src_bytes = 0 reads nothing).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async size");
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
  }
}

// The same, all BYTES read.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async size");
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(BYTES)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared-memory writes of this thread become visible to the async proxy
// (wgmma's operand reads) once a barrier follows
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of this warpgroup's wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of a register that an
// in-flight wgmma owns across this point (place after a wgmma_wait).
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void fence_operand(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// Descriptor of a K-major operand without swizzle at shared address `saddr`
// (16-byte aligned), with the core-matrix strides `lbo` (along K) and `sbo`
// (along M or N) in bytes.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t saddr, uint32_t lbo,
                                                uint32_t sbo) {
  return static_cast<uint64_t>((saddr >> 4) & 0x3FFFu) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32);
}

// d[64 x 128] += a[64 x 16] * b[16 x 128]: bf16 inputs, f32 accumulators.
// `a` is this thread's register fragment of the warpgroup's A tile (warp w
// holds rows 16w..16w+15; lane l holds rows l/4 and l/4 + 8 at k = 2(l%4),
// +1, +8, +9, two bf16 per register, the lower k in the low half); `d` is
// the accumulator fragment (element i: row 16w + l/4 + 8((i/2)%2), column
// 8(i/4) + 2(l%4) + i%2); `desc_b` describes B (K-major, N = 128).
__device__ __forceinline__ void wgmma_m64n128k16_bf16_rs(float (&d)[64],
                                                         const uint32_t (&a)[4],
                                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));

}

// d[64 x 64] += a[64 x 16] * b[16 x 64]: bf16 inputs, f32 accumulators; the
// fragments as in wgmma_m64n128k16_bf16_rs (d element i < 32: row 16w + l/4
// + 8((i/2)%2), column 8(i/4) + 2(l%4) + i%2); `desc_b` describes B
// (K-major, N = 64).
__device__ __forceinline__ void wgmma_m64n64k16_bf16_rs(float (&d)[32],
                                                        const uint32_t (&a)[4],
                                                        uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// ---------------------------------------------------------------------------
// The int8 plane Gram (K7, K13).  Hopper's s8 wgmma takes K-major operands
// only, both from shared memory here.  A tile of R rows (a multiple of 8)
// by one k32 step (32 int8) is stored as R / 8 row groups of two core
// matrices each: byte (row, k) at s8_off(row, k / 16) + k % 16, i.e. 256
// bytes a group, the K half kc at 128 kc, row % 8 at 16 bytes each.  Its
// descriptor is desc_kmajor(addr, 128, 256) (`desc_s8`); a tile of two
// planes stored one after the other is one operand of 2R rows.  Counts
// accumulate in s32: exact while a sum stays below 2^31.
// ---------------------------------------------------------------------------

// byte offset of 16 consecutive k (the K half kc) of tile row `row`
__device__ __forceinline__ int s8_off(int row, int kc) {
  return (row >> 3) * 256 + kc * 128 + (row & 7) * 16;
}

__device__ __forceinline__ uint64_t desc_s8(uint32_t saddr) {
  return desc_kmajor(saddr, 128, 256);
}

// d[64 x 192] += a[64 x 32] * b[32 x 192]: s8 operands both from shared memory
// (K-major, `desc_a` / `desc_b`), s32 accumulators (fragment as in
// wgmma_m64n128k16_bf16_rs: element i at row 16w + l/4 + 8((i/2)%2), column
// 8(i/4) + 2(l%4) + i%2).
__device__ __forceinline__ void wgmma_m64n192k32_s8_ss(int (&d)[96], uint64_t desc_a,
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d[64 x 128] += a[64 x 32] * b[32 x 128]: s8 operands both from shared memory
// (K-major, `desc_a` / `desc_b`), s32 accumulators (fragment as in
// wgmma_m64n128k16_bf16_rs: element i at row 16w + l/4 + 8((i/2)%2), column
// 8(i/4) + 2(l%4) + i%2).
__device__ __forceinline__ void wgmma_m64n128k32_s8_ss(int (&d)[64], uint64_t desc_a,
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d[64 x 64] += a[64 x 32] * b[32 x 64]: s8 operands both from shared memory
// (K-major, `desc_a` / `desc_b`), s32 accumulators (fragment as in
// wgmma_m64n128k16_bf16_rs: element i at row 16w + l/4 + 8((i/2)%2), column
// 8(i/4) + 2(l%4) + i%2).
__device__ __forceinline__ void wgmma_m64n64k32_s8_ss(int (&d)[32], uint64_t desc_a,
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// Named barriers (ids 1-15; __syncthreads is 0) between the producer and
// consumer warps of a CTA: `count` threads (a multiple of 32) take part;
// arrive does not wait, sync waits for the phase to complete.  Shared memory
// writes before the arrive are visible to the threads past the sync.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Sixteen 2-bit codes (code c in bits 2c..2c+1 of w, pgen order) as the
// byte selectors of four prmt: sel[q] holds codes 4q..4q+3 in its low four
// nibbles (bits 16-31 are ignored by prmt).
__device__ __forceinline__ void code_selectors(uint32_t w, uint32_t (&sel)[4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t x = __byte_perm(w, 0u, h ? 0x4342u : 0x4140u);  // bytes 2h, 2h + 1 apart
    x = (x | (x << 4)) & 0x0F0F0F0Fu;
    x = (x | (x << 2)) & 0x33333333u;
    sel[2 * h] = x;
    sel[2 * h + 1] = x >> 16;
  }
}

// The int8 plane of those sixteen codes: byte c = byte code_c of `table`
// (table byte k: the plane's value for code k, 0 hom-REF, 1 het, 2
// hom-ALT, 3 missing), one prmt per four codes.
__device__ __forceinline__ uint4 code_plane(const uint32_t (&sel)[4], uint32_t table) {
  return make_uint4(__byte_perm(table, 0u, sel[0]), __byte_perm(table, 0u, sel[1]),
                    __byte_perm(table, 0u, sel[2]), __byte_perm(table, 0u, sel[3]));
}

// z = hi + mid + lo exactly, each part a bf16 held in the upper half of an
// f32 bit pattern (lower half zero).  Each part truncates the remainder to
// its leading 8 significant bits, so the remainders are exact f32
// differences and the last one has at most 8 significant bits: exact for
// every finite z with |z| >= 2^-100 (all three parts normal), and for 0.
// Truncation never rounds a part up past FLT_MAX, which rounding to
// nearest would for |z| near it.
__device__ __forceinline__ void split_bf16x3(float z, uint32_t& hi, uint32_t& mid,
                                             uint32_t& lo) {
  hi = __float_as_uint(z) & 0xFFFF0000u;
  const float r = __fsub_rn(z, __uint_as_float(hi));
  mid = __float_as_uint(r) & 0xFFFF0000u;
  lo = __float_as_uint(__fsub_rn(r, __uint_as_float(mid)));
}

// two bf16 parts (upper halves of x and y) as one register: x low, y high
__device__ __forceinline__ uint32_t pack_bf16x2(uint32_t x, uint32_t y) {
  return __byte_perm(x, y, 0x7632);
}

}  // namespace hop
