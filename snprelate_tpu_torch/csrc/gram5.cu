// K1 gram4, K1r gram5_rows and K1t gram5_tile: the count grams of the
// full square, of the KING screen's strips and of its super tiles, on
// Hopper's int8 warpgroup products.
//
// K1 replaces _gram4_step (snprelate_tpu/ops/pairwise.py:314, decode2bit
// -> genotype_basis -> _sym_grams4, :166): V'V, H'H, D'D and H'V of one
// packed chunk added into an int32 (4, N, N) carry over the full square
// (the main path's pair_counts, ibd_king, ibd_mom, beta, diss, KING-homo,
// ibd_mle's MoM start and the mesh's sharded gram).
//
// K1r replaces _basis_rows_step / _basis_strip_update
// (snprelate_tpu/ops/pairwise.py:1024, :1006): for the sample rows
// [row0, row0 + R) of one packed SNP chunk, (S, N/4) bytes with the first
// sample in the low bits and 0xFF padding (= missing), it adds the five
// row-strip grams Vr'V, Hr'H, Dr'D, Hr'V and Vr'H into an int32 (5, R, N)
// carry over the columns [0, n_cols), where V = [g != 3], H = [g == 1] and
// D = [g == 2] - [g == 0]. The KING screen passes n_cols = row0 + rows
// rounded up to 64: its triangle test never reads a column at or past the
// row, so half the work is skipped. The count grams of the KING-homo
// strips (pairwise.py:1090) and the mesh strips run on it too.
//
// K1t replaces _basis_tile_scan_c (snprelate_tpu/ops/tiles.py:732, and the
// counts of _king_homo_tile_scan_c, :1035): the same five grams Vi'Vj,
// Hi'Hj, Di'Dj, Hi'Vj and Vi'Hj of one (g, g) super tile, the rows from
// one packed sample-group slab and the columns from another (the same
// tensor on a diagonal tile), each (S, g/4) over every SNP of the
// selection, in one launch. The int32 sums are exact below 2^31 SNPs,
// which the engines guard (guard_count_snps).
//
// What bounds them on the card: int8 tensor-core operations, 5 x 2 S per
// output entry, against S N / 4 bytes of input and the int32 carry read
// and written once. Beside the products, every genotype of a block's rows
// and columns must be decoded from 2 bits into three operand bytes (V, H,
// D) with the SNP axis, the products' K, contiguous: the decode's integer
// instructions are the second cost.
//
// Design. A block of two warpgroups owns a 128 x 64 output tile of all
// five grams: warpgroup w the rows 64w.., 160 int32 accumulators a thread
// (a 128 x 128 tile would need 81,920 registers). Each 256-SNP stage:
//  - 16-byte cp.async copies bring the stage's packed bytes (8 KB of the
//    rows, 4 KB of the columns) into a three-deep ring, two stages ahead;
//  - the 8 warps decode the columns once into shared memory, each one
//    swizzle atom (8 samples) of the V, H and D planes, K-major with the
//    128-byte swizzle of csrc/wgmma_s8.cuh (wgmma's B operand), into the
//    other of two buffers;
//  - each warp decodes its own 16 rows straight into wgmma's A fragments
//    in registers, one k32 step at a time: 32-bit loads of the packed
//    words of 8 SNPs, byte permutes to the lane's rows, then V, H and D
//    with a few LOP3s (the ring's rows are padded so the loads of a warp
//    hit distinct banks);
//  - each warpgroup issues per k step A = V against B = [V | H]
//    (m64n128k32: V'V and V'H), A = H against [V | H] (H'V, H'H) and
//    A = D against D (m64n64k32), s8 x s8 -> s32, exact; one k step's
//    products stay in flight while the next k step's A is decoded (two A
//    buffers, pinned until the products reading them are done).
// Two barriers a stage: the next stage has landed; its column planes are
// written. A ragged strip or tile (R or g an odd multiple of 64) leaves the
// second warpgroup of its last block row idle: its rows are not copied or
// written, and it multiplies what its registers hold, since ptxas
// serializes products under a branch it cannot prove uniform. The
// epilogue adds each fragment into the carry in place, a gram's loads
// before its stores, the tile prefetched into L2 two stages before the
// end; each output tile has one owner, so no atomics, and a second launch
// gives the same bits. The launch plan and the shared-memory budget
// (140,800 bytes, one block of 246 registers a thread an SM) are mirrored
// by ops/kernels.py:gram5_plan (K1: gram4_plan), the decode, the ring and
// the swizzle by the CPU tests of tests/test_torch_gram5_plan.py, K1's
// grid walk, parts and stores by tests/test_torch_gram4_plan.py.
//
// K1's triangle mode. V'V, H'H and D'D are symmetric and H'V(j, i) =
// V'H(i, j), so K1 runs only the blocks of the upper block triangle (64 x
// >= 128 y: 420 of 800 at N = 2,560), each with K1r's five grams, and
// writes every carry entry from exactly one of them: on or above the
// diagonal V'V, H'H, D'D and H'V where computed, below it V'V, H'H, D'D
// and V'H of the mirrored entry, transposed through the (then free)
// decoded-column buffers so that a warp's adds cover whole carry rows. A
// diagonal 64 x 64 tile writes its upper half directly and its lower half
// from its own mirror; the second warpgroup of a block on the diagonal
// (64 x = 128 y: its rows lie below it) loads and writes nothing. The
// blocks of the last wave are cut into SNP parts (ops/kernels.py
// gram4_plan: at N = 2,560 396 whole blocks, then 24 in 5 parts of 1,792
// SNPs), so that wave ends sooner; the parts meet in the carry, so K1 adds
// with atomics (red.global.add.s32: int32 sums are exact in any order, so
// a second launch gives the same bits). Its carry tiles are prefetched
// into L2 before the loop: prefetched inside it, as K1r / K1t do, they
// cost ptxas the registers to keep the products in flight, and it
// serialized them. What bounds it beyond K1r's body: the epilogue's
// atomics, 4 N^2 adds and the parts' extra ones, and at N = 1,024 one
// wave of 72 blocks, which parts do not shorten (a part's prologue and
// epilogue cost about as much as the stages it saves: chip_smoke.py's
// `[time] gram4 parts` line).
//
// Why this design (the rates: PERF.md, from `python3 chip_smoke.py
// --mma-probe`): wgmma s8 runs near the int8 peak from shared memory and
// with A from registers alike, about 1.5x mma.sync m16n8k32. Decoding the
// rows into shared memory as well (A from shared memory) costs as many
// shared-memory bytes as the products' own operand reads; decoding them
// into registers costs each warp about 50 instructions a k step. What
// holds the kernel at about half the probe's rate: timed with parts taken
// out, the products alone come near the probe's rate, and the rows' decode
// and the stage change each add their own time rather than hiding under
// the products of the same warps. A warp-specialized split (producer
// warps decoding into shared memory for consumer warps) was right but
// slower: ptxas held every thread to the launch's share of registers
// despite setmaxnreg (128 at 512 threads, 168 at 384), spilled the 160
// accumulators and serialized the products. Later work: that split with
// fewer accumulators a consumer, K16 gram6 and K8 gram5_cross
// (csrc/gram4.cu) on this body, K6 / K6t (the KING screen's tests) in the
// epilogue, a persistent grid.

#include <cstdint>
#include <cuda_runtime.h>

#include "wgmma_s8.cuh"

namespace {

constexpr int TM = 128;       // output rows per block: two warpgroups of 64
constexpr int TN = 64;        // output columns per block
constexpr int BK = 256;       // SNPs per stage: two 128-byte operand rows
constexpr int THREADS = 256;
constexpr int RING = 3;       // packed stages in the cp.async ring
// A ring stage: the rows' SNP s (32 bytes, 128 samples) at row_at(s), 16
// pad bytes after every 4 SNPs, so that the 4 SNP rows of one load of a
// warp's row decode sit 4 banks apart; the columns' SNP s (16 bytes) at
// RING_ROW + col_at(s), 16 pad bytes after every 8, so that the column
// decode's byte loads spread over the banks.
__device__ __forceinline__ constexpr int row_at(int s) {
  return 32 * s + ((s >> 2) << 4);
}
__device__ __forceinline__ constexpr int col_at(int s) {
  return 16 * s + ((s >> 3) << 4);
}
constexpr int RING_ROW = 32 * BK + 16 * (BK / 4);               // 9,216
constexpr int RING_STAGE = RING_ROW + 16 * BK + 16 * (BK / 8);  // 13,824
// A decoded stage: the columns' V, H and D planes (wgmma's B operand), in
// two halves of 128 SNPs, each plane a 64 x 128-byte swizzled tile
constexpr int B_PLANE = TN * 128;                               // 8,192
constexpr int B_HALF = 3 * B_PLANE;                             // 24,576
constexpr int BUF = 2 * B_HALF;                                 // 49,152
constexpr int SMEM = 1024 + 2 * BUF + RING * RING_STAGE;        // 140,800

__device__ __forceinline__ void cp16(void *dst, const void *src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   wg::smem_addr(dst)),
               "l"(src)
               : "memory");
}

// The V, H and D words (byte i: SNP i) of sample k of 4 packed bytes x
// (byte i: SNP i's packed byte of 4 samples, sample k in bits 2k, 2k + 1).
__device__ __forceinline__ void basis(uint32_t x, int k, uint32_t &v,
                                      uint32_t &h, uint32_t &d) {
  const uint32_t ones = 0x01010101u;
  const uint32_t lo = x >> (2 * k), hi = lo >> 1;  // bit 0 of each byte
  v = ~(lo & hi) & ones;                           // code != 3
  h = lo & ~hi & ones;                             // code == 1
  const uint32_t two = hi & ~lo & ones;            // code == 2: +1
  const uint32_t zero = ~(lo | hi) & ones;         // code == 0: -1
  d = zero * 0xFFu + two;                          // no carries
}

// The columns' swizzle atom a (samples 8a .. 8a + 7: packed bytes 2a,
// 2a + 1 of each SNP row of the ring's column side `cols`) over the
// stage's 128 SNPs -> the V, H and D planes at `planes`. Lane: SNPs
// 8 sp .. 8 sp + 7 (sp = lane % 16) of packed byte 2a + hb (hb = lane /
// 16), two words of 4 SNPs; per sample k one 8-byte store a plane, at row
// 4 hb + k of the atom, K byte 8 sp (wg::sw128). SNPs at or past nv read
// as missing.
__device__ __forceinline__ void decode_cols(const uint8_t *cols,
                                            uint8_t *planes, int a, int lane,
                                            int nv) {
  const int sp = lane & 15, hb = lane >> 4;
  const uint8_t *src = cols + 2 * a + hb;
  uint8_t *row = planes + a * 1024 + 512 * hb + 8 * (sp & 1);
  const uint32_t c = ((sp >> 1) ^ (4 * hb)) << 4;
#pragma unroll
  for (int kh = 0; kh < BK / 128; ++kh) {  // SNPs 128 kh ..: plane half kh
    uint32_t x[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      x[j] = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[j] |= static_cast<uint32_t>(
                    src[col_at(128 * kh + 8 * sp + 4 * j + i)])
                << (8 * i);
    }
    if (nv < BK)  // the chunk's last stage: SNPs past S are missing
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (128 * kh + 8 * sp + 4 * j + i >= nv) x[j] |= 0xFFu << (8 * i);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t v[2], h[2], d[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) basis(x[j], k, v[j], h[j], d[j]);
      // wg::sw128(8a + 4hb + k, 8sp) in half kh
      uint8_t *p = row + kh * B_HALF + 128 * k + (c ^ (k << 4));
      *reinterpret_cast<uint2 *>(p) = make_uint2(v[0], v[1]);
      *reinterpret_cast<uint2 *>(p + B_PLANE) = make_uint2(h[0], h[1]);
      *reinterpret_cast<uint2 *>(p + 2 * B_PLANE) = make_uint2(d[0], d[1]);
    }
  }
}

// The A fragments of k step kk (wgmma's register layout) of this lane's
// rows, decoded from the ring stage: a[p][2i + h] = plane p (V, H, D) of
// row 16 w + g + 8 h of the warpgroup (g = lane / 4) over the SNPs
// 32 kk + 16 i + 4 q .. + 3 (q = lane % 4). `rows` points at the warp's
// 16 samples (one 32-bit word) of SNP 4q of the stage; the lane loads the
// 8 words of its SNPs and takes its rows' bytes (sel) with byte permutes,
// sample k of each byte. SNPs at or past nv read as missing.
__device__ __forceinline__ void decode_rows(const uint8_t *rows, int kk,
                                            uint32_t sel, int k, int snp0,
                                            int nv, uint32_t (&a)[3][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = *reinterpret_cast<const uint32_t *>(
          rows + row_at(32 * kk + 16 * i + j));
      if (nv < BK && snp0 + 32 * kk + 16 * i + j >= nv) w[j] = 0xFFFFFFFFu;
    }
    const uint32_t t01 = __byte_perm(w[0], w[1], sel);
    const uint32_t t23 = __byte_perm(w[2], w[3], sel);
    basis(__byte_perm(t01, t23, 0x5410), k, a[0][2 * i], a[1][2 * i],
          a[2][2 * i]);  // row g
    basis(__byte_perm(t01, t23, 0x7632), k, a[0][2 * i + 1],
          a[1][2 * i + 1], a[2][2 * i + 1]);  // row g + 8
  }
}

// carry (the fragment's row 0 at p, row stride ld) += the 64 x 64 half
// HALF (columns 64 HALF ..) of an m64nN accumulator: all loads before the
// adds and stores.
template <int HALF, int R>
__device__ __forceinline__ void add_half(int *p, long long ld,
                                         const int (&acc)[R]) {
  int2 v[16];
#pragma unroll
  for (int f = 0; f < 16; ++f)  // f = 2 j + h: column 8 j, row 8 h
    v[f] = *reinterpret_cast<const int2 *>(p + (f & 1) * 8 * ld +
                                           8 * (f >> 1));
#pragma unroll
  for (int f = 0; f < 16; ++f) {
    const int i = 4 * (8 * HALF + (f >> 1)) + 2 * (f & 1);
    v[f].x += acc[i];
    v[f].y += acc[i + 1];
    *reinterpret_cast<int2 *>(p + (f & 1) * 8 * ld + 8 * (f >> 1)) = v[f];
  }
}

// carry[lo gram] and carry[hi gram] += an m64nN accumulator's fragments
// (N = 64: lo only; N = 128: columns 64.. to hi), row r of the fragment at
// base + r ld.
template <int N>
__device__ __forceinline__ void add_fragments(int *base, long long ld,
                                              long long plane, int lo, int hi,
                                              const int (&acc)[N / 2]) {
  add_half<0>(base + lo * plane, ld, acc);
  if constexpr (N == 128) add_half<1>(base + hi * plane, ld, acc);
}

// K1's triangle mode, which adds with atomics (a split block's parts meet
// in the carry; int32 sums are exact in any order). carry (fragment row 0
// at p) += the 64 x 64 half HALF of an accumulator, the lane's rows rl,
// rl + 8 and columns 8 j + cl, + 1 of the tile; on a diagonal tile (diag)
// only the entries on or above the diagonal.
template <int HALF, int R>
__device__ __forceinline__ void add_upper(int *p, long long ld, bool diag,
                                          int rl, int cl,
                                          const int (&acc)[R]) {
#pragma unroll
  for (int f = 0; f < 16; ++f)  // f = 2 j + h: column 8 j, row 8 h
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = f >> 1, h = f & 1;
      if (!diag || rl + 8 * h <= 8 * j + cl + e)
        atomicAdd(p + h * 8 * ld + 8 * j + e,
                  acc[4 * (8 * HALF + j) + 2 * h + e]);
    }
}

constexpr int LDT = 68;  // a transposed tile's row (int32): the fragment
                         // stores of a warp on 32 distinct banks

// carry (row 0, column 0 at q: rows c0.., columns this warpgroup's rows)
// += the transpose of the warpgroup's 64 x 64 half HALF, through its
// region T (64 x LDT int32) of the free decoded-column buffers, a warp's
// adds on whole carry rows; on a diagonal tile only the entries strictly
// above it (their mirrors lie below). Called by every thread of the block.
template <int HALF, int R>
__device__ __forceinline__ void add_mirror(int *T, int *q, long long ld,
                                           bool own, bool diag, int rl,
                                           int cl, int w4, int lane,
                                           const int (&acc)[R]) {
  if (own)
#pragma unroll
    for (int f = 0; f < 16; ++f)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = f >> 1, h = f & 1;
        T[(8 * j + cl + e) * LDT + rl + 8 * h] =
            acc[4 * (8 * HALF + j) + 2 * h + e];
      }
  __syncthreads();
  if (own)  // warp w4: carry rows c = 16 w4 .., columns 2 lane, + 1
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int c = 16 * w4 + r;
      const int2 v = *reinterpret_cast<const int2 *>(T + c * LDT + 2 * lane);
      int *a = q + c * ld + 2 * lane;
      if (!diag || 2 * lane < c) atomicAdd(a, v.x);
      if (!diag || 2 * lane + 1 < c) atomicAdd(a + 1, v.y);
    }
  __syncthreads();
}

// K1's four grams of this warpgroup's tile (rows i0 = r0 + 64 wgi, columns
// c0): V'V, H'H, D'D and H'V into (i, j) for i <= j, and V'V, H'H, D'D
// and V'H(i, j) = H'V(j, i) into (j, i) for i < j; each accumulator's
// stores together, so that it dies before the next one's.
__device__ __forceinline__ void add_triangle(
    int *carry, long long plane, long long ld, int i0, int c0, bool own,
    bool diag, int rl, int cl, int w4, int lane, int *T,
    const int (&acc_v)[64], const int (&acc_h)[64], const int (&acc_d)[32]) {
  int *q = carry + static_cast<long long>(c0) * ld + i0;
  int *p = carry + static_cast<long long>(i0 + rl) * ld + c0 + cl;
  add_mirror<0>(T, q, ld, own, diag, rl, cl, w4, lane, acc_v);  // V'V
  if (own) add_upper<0>(p, ld, diag, rl, cl, acc_v);
  add_mirror<1>(T, q + 3 * plane, ld, own, diag, rl, cl, w4, lane,
                acc_v);  // V'H, the mirror of H'V
  add_mirror<1>(T, q + plane, ld, own, diag, rl, cl, w4, lane, acc_h);
  if (own) {
    add_upper<1>(p + plane, ld, diag, rl, cl, acc_h);      // H'H
    add_upper<0>(p + 3 * plane, ld, diag, rl, cl, acc_h);  // H'V
  }
  add_mirror<0>(T, q + 2 * plane, ld, own, diag, rl, cl, w4, lane,
                acc_d);  // D'D
  if (own) add_upper<0>(p + 2 * plane, ld, diag, rl, cl, acc_d);
}

// Block (x, y): carry rows r0 = 128 y .. (packed sample rows row_base +
// r0 ..) of pa, columns c0 = 64 x .. of pb; carry gram k at k plane, row
// stride ld. rows: the carry's rows (a multiple of 64). TRI (K1): x walks
// the upper block triangle (64 x >= 128 y) row by row, rows is N, and the
// four grams are written as add_triangle says; the blocks past `whole`
// (those of the last wave) are cut into `parts` SNP parts of part_len,
// part z of block whole + t the grid's block whole + z tail + t.
template <bool TRI>
__global__ void __launch_bounds__(THREADS, 1)
gram5_kernel(const uint8_t *__restrict__ pa, const uint8_t *__restrict__ pb,
             int S_all, int B, int row_base, int rows, int whole, int parts,
             int part_len, int *__restrict__ carry, long long plane,
             long long ld) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t *const sm =
      smem_raw + ((1024u - (wg::smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t *const ring = sm + 2 * BUF;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wgi = tid >> 7, g = lane >> 2, q = lane & 3;
  int bx = blockIdx.x, by = blockIdx.y, k_part = 0, S = S_all;
  if (TRI) {
    if (bx >= whole) {  // a part of a block of the last wave
      const int tail = (gridDim.x - whole) / parts, t = bx - whole;
      bx = whole + t % tail;
      k_part = t / tail * part_len;
      S = min(S_all - k_part, part_len);
    }
    const int nc = rows / TN;
    while (bx >= nc - 2 * by) {
      bx -= nc - 2 * by;
      ++by;
    }
    bx += 2 * by;
  }
  const int r0 = by * TM, c0 = bx * TN;
  const bool full = r0 + TM <= rows;  // else rows 64.. are past the carry
  // the second warpgroup's rows are loaded and written: not past the carry,
  // and in K1's triangle not below the diagonal
  const bool hi_rows = full && (!TRI || 2 * by + 1 <= bx);
  const bool active = wgi == 0 || hi_rows;
  const uint8_t *const ga =
      pa + ((row_base + r0) >> 2) + static_cast<size_t>(k_part) * B;
  const uint8_t *const gb = pb + (c0 >> 2) + static_cast<size_t>(k_part) * B;
  const int nst = (S + BK - 1) / BK;
  // the row decode: this warp's 16 samples are bytes 16 wgi + 4 (warp % 4)
  // .. + 3 of a row; row g its byte g / 4, row g + 8 byte g / 4 + 2
  const int rword = 16 * wgi + 4 * (warp & 3) + row_at(4 * q);
  const uint32_t sel = (g >> 2) | ((4 + (g >> 2)) << 4) |
                       ((2 + (g >> 2)) << 8) | ((6 + (g >> 2)) << 12);

  // packed stage st into ring slot st % RING (one commit group a call)
  auto load = [&](int st) {
    if (st < nst) {
      uint8_t *rg = ring + (st % RING) * RING_STAGE;
      const int k0 = st * BK;
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // rows: SNP s, 64 samples 64h..
        const int s = (tid >> 1) + 128 * r, h = tid & 1;
        if (k0 + s < S && (h == 0 || hi_rows))
          cp16(rg + row_at(s) + 16 * h,
               ga + static_cast<size_t>(k0 + s) * B + 16 * h);
      }
      if (k0 + tid < S)  // columns: SNP tid, 64 samples
        cp16(rg + RING_ROW + col_at(tid),
             gb + static_cast<size_t>(k0 + tid) * B);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // ring stage st -> the columns' planes of buffer st & 1, atom `warp`
  auto cols = [&](int st) {
    decode_cols(ring + (st % RING) * RING_STAGE + RING_ROW,
                sm + (st & 1) * BUF, warp, lane, S - st * BK);
    wg::fence_proxy_async();
  };
  auto rows_of = [&](int st, int kk, uint32_t (&a)[3][4]) {
    decode_rows(ring + (st % RING) * RING_STAGE + rword, kk, sel, g & 3,
                4 * q, S - st * BK, a);
  };

  // [V'V | V'H], [H'V | H'H] (m64n128) and D'D (m64n64) of this
  // warpgroup's 64 rows
  int acc_v[64], acc_h[64], acc_d[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc_v[i] = acc_h[i] = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_d[i] = 0;
  uint32_t a[2][3][4];  // A fragments of two k steps: one in flight

  load(0);
  load(1);
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();
  cols(0);
  load(2);
  __syncthreads();
  rows_of(0, 0, a[0]);
  // K1's tile and its mirror into L2 (here: prefetched inside the loop,
  // they cost ptxas the registers to keep the products in flight)
  if (TRI && active)
    for (int l = tid & 127; l < 4 * 64 * 2; l += 128) {
      const int row = (l >> 1) & 63, col = 32 * (l & 1);  // 128-byte lines
      int *const gram = carry + (l >> 7) * plane;
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
          gram + static_cast<long long>(r0 + 64 * wgi + row) * ld + c0 + col));
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
          gram + static_cast<long long>(c0 + row) * ld + r0 + 64 * wgi + col));
    }
  // An idle warpgroup multiplies too (rows nobody loaded, never written
  // out): products under a branch the compiler cannot prove uniform are
  // serialized by ptxas.
  for (int st = 0; st < nst; ++st) {
    if (!TRI && st == (nst > 2 ? nst - 2 : 0) && active)  // the carry tile
      for (int l = tid & 127; l < 5 * 64 * 2; l += 128)  // into L2: lines
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
            carry + (l >> 7) * plane + (r0 + 64 * wgi + ((l >> 1) & 63)) * ld +
            c0 + 32 * (l & 1)));
    const uint32_t b0 = wg::smem_addr(sm + (st & 1) * BUF);
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t(&cur)[3][4] = a[kk & 1];
      uint32_t(&nxt)[3][4] = a[(kk + 1) & 1];
      const uint32_t bk = b0 + (kk >> 2) * B_HALF + 32 * (kk & 3);
      const uint64_t bvh = wg::desc(bk);
      wg::keep(acc_v);
      wg::keep(acc_h);
      wg::keep(acc_d);
      wg::fence();
      wg::mma_n128_rs(acc_v, cur[0], bvh);  // V'V | V'H
      wg::mma_n128_rs(acc_h, cur[1], bvh);  // H'V | H'H
      wg::mma_n64_rs(acc_d, cur[2], wg::desc(bk + 2 * B_PLANE));
      wg::commit();
      wg::wait<1>();  // the previous k step's products are done
      wg::keep(acc_v);
      wg::keep(acc_h);
      wg::keep(acc_d);
#pragma unroll
      for (int p = 0; p < 3; ++p) wg::keep(nxt[p]);  // free from here on
      if (kk + 1 < BK / 32) {
        rows_of(st, kk + 1, nxt);
      } else if (st + 1 < nst) {
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        __syncthreads();  // stage st + 1 landed; stage st's rows decoded
        cols(st + 1);
        load(st + 3);
        __syncthreads();  // stage st + 1's column planes written
        rows_of(st + 1, 0, nxt);
      }
    }
  }
  wg::wait<0>();
  wg::keep(acc_v);
  wg::keep(acc_h);
  wg::keep(acc_d);
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  if (TRI) {
    __syncthreads();  // both warpgroups' products are done: buffers free
    const int w4 = warp & 3, i0 = r0 + 64 * wgi;
    const bool diag = 2 * by + wgi == bx;
    add_triangle(carry, plane, ld, i0, c0, active, diag, 16 * w4 + g,
                      2 * q, w4, lane, reinterpret_cast<int *>(sm) +
                      wgi * 64 * LDT, acc_v, acc_h, acc_d);
  } else if (active) {
    // d[4j + 2h + e] is row 16 w + l/4 + 8h, column 8j + 2(l%4) + e
    int *base = carry + (r0 + 64 * wgi + 16 * (warp & 3) + g) * ld + c0 + 2 * q;
    add_fragments<128>(base, ld, plane, 0, 4, acc_v);  // V'V, V'H
    add_fragments<128>(base, ld, plane, 3, 1, acc_h);  // H'V, H'H
    add_fragments<64>(base, ld, plane, 2, 2, acc_d);   // D'D
  }
}

template <bool TRI>
int launch(dim3 grid, const void *pa, const void *pb, int S, int B,
           int row_base, int rows, int whole, int parts, int part_len,
           void *carry, long long plane, long long ld, void *stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      gram5_kernel<TRI>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  gram5_kernel<TRI><<<grid, THREADS, SMEM,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t *>(pa), static_cast<const uint8_t *>(pb), S,
      B, row_base, rows, whole, parts, part_len, static_cast<int *>(carry),
      plane, ld);
  return static_cast<int>(cudaGetLastError());
}

int launch_rect(const void *pa, const void *pb, int S, int B, int row_base,
                int rows, int n_cols, void *carry, long long plane,
                long long ld, void *stream) {
  if (rows > 0 && n_cols > 0 && S > 0)
    return launch<false>(dim3(n_cols / TN, (rows + TM - 1) / TM), pa, pb, S,
                         B, row_base, rows, 0, 1, S, carry, plane, ld,
                         stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// packed: (S, B) uint8, B % 16 == 0, 16-byte aligned; carry: (5, rows, 4B)
// int32, updated in place over its columns [0, n_cols); row0, rows and
// n_cols multiples of 64 with row0 + rows <= 4B and n_cols <= 4B.
// Launches on `stream`; returns the CUDA error (0 on success).
extern "C" int gram5_rows_launch(const void *packed, int S, int B, int row0,
                                 int rows, int n_cols, void *carry,
                                 void *stream) {
  const long long n = 4LL * B;
  return launch_rect(packed, packed, S, B, row0, rows, n_cols, carry,
                     static_cast<long long>(rows) * n, n, stream);
}

// slab_i, slab_j: (S, B) uint8 each, B % 16 == 0, 16-byte aligned (two
// sample groups of g = 4B samples over the same S SNPs; may be the same
// pointer); carry: (5, 4B, 4B) int32, updated in place. Launches on
// `stream`; returns the CUDA error (0 on success).
extern "C" int gram5_tile_launch(const void *slab_i, const void *slab_j,
                                 int S, int B, void *carry, void *stream) {
  const long long g = 4LL * B;
  return launch_rect(slab_i, slab_j, S, B, 0, static_cast<int>(g),
                     static_cast<int>(g), carry, g * g, g, stream);
}

// K1: packed (S, B) uint8, B % 16 == 0, 16-byte aligned; carry (4, 4B, 4B)
// int32 (V'V, H'H, D'D, H'V), updated in place over the full square from
// the upper block triangle; the blocks from `whole` on cut into `parts`
// SNP parts of part_len, a multiple of 256 (ops/kernels.py:gram4_plan).
// Launches on `stream`; returns the CUDA error (0 on success).
extern "C" int gram4_launch(const void *packed, int S, int B, int whole,
                            int parts, int part_len, void *carry,
                            void *stream) {
  const int nc = 4 * B / TN, nr = (nc + 1) / 2;
  if (nc > 0 && S > 0 && parts > 0 && part_len > 0) {
    int blocks = 0;  // the upper block triangle: nc - 2 y blocks in row y
    for (int y = 0; y < nr; ++y) blocks += nc - 2 * y;
    if (whole < 0 || whole > blocks)
      return static_cast<int>(cudaErrorInvalidValue);
    const long long n = 4LL * B;
    return launch<true>(dim3(whole + (blocks - whole) * parts), packed,
                        packed, S, B, 0, static_cast<int>(n), whole, parts,
                        part_len, carry, n * n, n, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
