// Hopper (sm_90a) building blocks of the tensor-core kernels: cp.async
// copies, the warpgroup matrix multiply (wgmma) with its fences, the shared
// memory descriptor of an operand without swizzle, and the exact split of
// an f32 into three bf16 parts.
//
// Layout of a wgmma operand in shared memory (K-major, no swizzle): a core
// matrix is 8 rows x 16 bytes (8 bf16 along K), stored as 128 contiguous
// bytes; `lbo` is the byte distance between the two core matrices of a
// row group along K (k 0-7 and 8-15 of a k16 step), `sbo` the distance
// between neighbouring groups of 8 rows.
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
