// int8 warpgroup products on Hopper (sm_90a): the shared-memory operand
// layout, its descriptors and the wgmma.mma_async wrappers that K1, K1r,
// K1t, K16 and K8 (csrc/gram5.cu) run on, and that the probe
// (csrc/mma_probe.cu, `python3 chip_smoke.py --mma-probe`) checks on the
// card against a plain integer product.
//
// An operand tile is K-major with the 128-byte swizzle: rows of 128 int8
// (128 K entries, one SNP a byte) in atoms of 8 rows x 128 bytes (1,024
// bytes, 1,024-aligned): row r sits at byte 128 (r % 8) of atom r / 8, and
// its 16-byte chunk c at chunk c ^ (r % 8) of that row (`sw128`). The
// descriptor of a tile holds its start address, 1,024 bytes from one atom
// to the next (stride byte offset) and swizzle mode 1 (128 B); its start
// advanced by 32 bytes selects the k32 slice kk of every row, the swizzle
// being applied by the hardware to the whole address.
//
// The accumulator of an m64nN product (s32) is spread as mma.sync's: warp
// w of the warpgroup, lane l, d[4j + 2h + e] = D[16w + l/4 + 8h][8j +
// 2(l%4) + e]. The A fragment of the register form (K1r / K1t's rows) is
// mma.sync m16n8k32's: a[2i + h] = the 4 bytes A[16w + l/4 + 8h][16i +
// 4(l%4) ..].
#pragma once

#include <cstdint>

namespace wg {

__device__ __forceinline__ uint32_t smem_addr(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of (row, k) in a K-major, 128-byte-swizzled tile.
__host__ __device__ constexpr uint32_t sw128(uint32_t row, uint32_t k) {
  return (row >> 3) * 1024u + (row & 7u) * 128u +
         ((((k >> 4) ^ row) & 7u) << 4) + (k & 15u);
}

// The descriptor of a tile at shared address `saddr` (its atom 1,024-
// aligned, or advanced from such a start by kk * 32 bytes).
__device__ __forceinline__ uint64_t desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(1) << 16) |           // leading offset (unused)
         (static_cast<uint64_t>(1024 >> 4) << 32) |   // atom to atom
         (static_cast<uint64_t>(1) << 62);            // 128-byte swizzle
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// This thread's plain shared-memory stores, visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Pins accumulators in place around asynchronous products: the compiler
// may not move or reuse them across this point.
template <int R>
__device__ __forceinline__ void keep(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define WG_D8(i)                                                        \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),           \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (64 x 64, s32) += A (64 x 32, s8) B' (B 64 x 32, s8), both in shared
// memory, described by da and db.
__device__ __forceinline__ void mma_n64(int (&d)[32], uint64_t da,
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 128, s32) += A (64 x 32) B' (B 128 x 32), both in shared memory.
__device__ __forceinline__ void mma_n128(int (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64) += A B', A's fragment in registers (see the note above).
__device__ __forceinline__ void mma_n64_rs(int (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128) += A B', A's fragment in registers.
__device__ __forceinline__ void mma_n128_rs(int (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 16) += A B', A's fragment in registers.
__device__ __forceinline__ void mma_n16_rs(int (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p;\n}\n"
      : WG_D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32) += A B', A's fragment in registers.
__device__ __forceinline__ void mma_n32_rs(int (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : WG_D8(0), WG_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 96) += A B', A's fragment in registers.
__device__ __forceinline__ void mma_n96_rs(int (&d)[48],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x N) += A B', A's fragment in registers, for the widths the count
// grams use: m64nNk32 with N = 16, 32, 64, 96 or 128.
template <int N>
__device__ __forceinline__ void mma_rs(int (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 96 || N == 128);
  if constexpr (N == 16) mma_n16_rs(d, a, db);
  else if constexpr (N == 32) mma_n32_rs(d, a, db);
  else if constexpr (N == 64) mma_n64_rs(d, a, db);
  else if constexpr (N == 96) mma_n96_rs(d, a, db);
  else mma_n128_rs(d, a, db);
}

// Pins registers that an asynchronous product reads: they may not be
// reused before this point.
template <int R>
__device__ __forceinline__ void keep(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#undef WG_D8

}  // namespace wg
