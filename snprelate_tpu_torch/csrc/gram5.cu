// K1 gram4, K1r gram5_rows and K1t gram5_tile: the count grams of the
// full square, of the KING screen's strips and of its super tiles; K16
// gram6, the six one-hot plane grams; K8 gram5_cross, the serving path's
// (query x cohort) count grams; all on Hopper's int8 warpgroup products.
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
// fewer accumulators a consumer, K6 / K6t (the KING screen's tests) in the
// epilogue, a persistent grid.
//
// K16 gram6 replaces _gram6_step (snprelate_tpu/ops/pairwise.py:303,
// decode2bit -> genotype_planes -> _sym_grams): I_a'I_b for (a, b) in
// SYM_PAIRS, I_a = [g == a] (missing and 0xFF padding: all-zero planes),
// added into an int32 (6, N, N) carry. I0'I0, I1'I1 and I2'I2 are
// symmetric and I_a'I_b(j, i) = I_b'I_a(i, j), so it runs K1's triangle
// mode with all nine plane products I_a(rows)' I_b(columns) of a tile:
// the direct stores take a <= b, the mirrored ones (transposed through the
// freed buffers, atomic adds) a >= b; 4.5 N^2 products an SNP where the
// full square took 6 N^2. The planes come from the code bits as V, H and
// D do (`planes`, a few LOP3s). Blocks of 128 x 32 (see Gram6).
//
// K8 gram5_cross replaces _cross_gram_step (snprelate_tpu/ops/pairwise.py:
// 545): for a packed cohort chunk and a query given as one code byte per
// genotype, (q, Sq) with any code above 2 missing (and the SNPs from Sq to
// S), it adds Qv'V, Qh'H, Qd'D, Qh'V and Qv'H into an int32 (5, q, N)
// carry. The query's code bytes are already K-major, wgmma's B layout, so
// the cohort takes A (K1r's rows, decoded into registers) and the query B
// (a stage's codes copied into the ring, 16 bytes a cp.async where the
// rows are 16-byte aligned, else byte by byte, then decoded once into the
// swizzled planes); each block's products are K1r's, transposed into the
// carry through the freed buffers (one writer an entry: plain adds).

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

// The one-hot plane words I0, I1 and I2 ([code == 0], [== 1], [== 2]; byte
// i: SNP i) of sample k of 4 packed bytes x, as `basis` takes them;
// missing (code 3) has all three 0.
__device__ __forceinline__ void planes(uint32_t x, int k, uint32_t &i0,
                                       uint32_t &i1, uint32_t &i2) {
  const uint32_t ones = 0x01010101u;
  const uint32_t lo = x >> (2 * k), hi = lo >> 1;
  i0 = ~(lo | hi) & ones;  // code 0
  i1 = lo & ~hi & ones;    // code 1
  i2 = hi & ~lo & ones;    // code 2
}

// V, H, D (PL false: K1, K1r, K1t) or the planes I0, I1, I2 (PL: K16).
template <bool PL>
__device__ __forceinline__ void decode3(uint32_t x, int k, uint32_t &a,
                                        uint32_t &b, uint32_t &c) {
  if constexpr (PL)
    planes(x, k, a, b, c);
  else
    basis(x, k, a, b, c);
}

// The columns' swizzle atom a (samples 8a .. 8a + 7: packed bytes 2a,
// 2a + 1 of each SNP row of the ring's column side `cols`) over the
// stage's SNPs 128 kh .. 128 kh + 127 -> the three planes (PLANE bytes
// apart; V, H and D, or with PL I0, I1 and I2) of one decoded half at
// `half`. Lane: SNPs 8 sp .. 8 sp + 7 (sp = lane % 16) of packed byte
// 2a + hb (hb = lane / 16), two words of 4 SNPs; per sample k one 8-byte
// store a plane, at row 4 hb + k of the atom, K byte 8 sp (wg::sw128).
// SNPs at or past nv read as missing.
template <bool PL, int PLANE>
__device__ __forceinline__ void decode_atom(const uint8_t *cols,
                                            uint8_t *half, int a, int kh,
                                            int lane, int nv) {
  const int sp = lane & 15, hb = lane >> 4;
  const uint8_t *src = cols + 2 * a + hb;
  uint8_t *row = half + a * 1024 + 512 * hb + 8 * (sp & 1);
  const uint32_t c = ((sp >> 1) ^ (4 * hb)) << 4;
  uint32_t x[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    x[j] = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[j] |= static_cast<uint32_t>(src[col_at(128 * kh + 8 * sp + 4 * j + i)])
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
    for (int j = 0; j < 2; ++j) decode3<PL>(x[j], k, v[j], h[j], d[j]);
    // wg::sw128(8a + 4hb + k, 8sp)
    uint8_t *p = row + 128 * k + (c ^ (k << 4));
    *reinterpret_cast<uint2 *>(p) = make_uint2(v[0], v[1]);
    *reinterpret_cast<uint2 *>(p + PLANE) = make_uint2(h[0], h[1]);
    *reinterpret_cast<uint2 *>(p + 2 * PLANE) = make_uint2(d[0], d[1]);
  }
}

// The columns' swizzle atom a over the whole stage (both halves) -> the
// V, H and D planes at `planes` (K1, K1r, K1t: 64 columns).
__device__ __forceinline__ void decode_cols(const uint8_t *cols,
                                            uint8_t *planes, int a, int lane,
                                            int nv) {
#pragma unroll
  for (int kh = 0; kh < BK / 128; ++kh)  // SNPs 128 kh ..: plane half kh
    decode_atom<false, B_PLANE>(cols, planes + kh * B_HALF, a, kh, lane, nv);
}

// The A fragments of k step kk (wgmma's register layout) of this lane's
// rows, decoded from the ring stage: a[p][2i + h] = plane p (V, H, D) of
// row 16 w + g + 8 h of the warpgroup (g = lane / 4) over the SNPs
// 32 kk + 16 i + 4 q .. + 3 (q = lane % 4). `rows` points at the warp's
// 16 samples (one 32-bit word) of SNP 4q of the stage; the lane loads the
// 8 words of its SNPs and takes its rows' bytes (sel) with byte permutes,
// sample k of each byte. SNPs at or past nv read as missing.
template <bool PL = false>
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
    decode3<PL>(__byte_perm(t01, t23, 0x5410), k, a[0][2 * i], a[1][2 * i],
                a[2][2 * i]);  // row g
    decode3<PL>(__byte_perm(t01, t23, 0x7632), k, a[0][2 * i + 1],
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

// K1's and K16's triangle mode adds with atomics (a split block's parts
// meet in the carry; int32 sums are exact in any order). carry (fragment
// row 0 at p; this lane's rows rl, rl + 8 and columns 8 j + cl, + 1) +=
// the columns 8 J0 .. 8 (J0 + NJ) - 1 of an accumulator; on a diagonal
// tile (diag) only the entries with row <= column + off (off: the tile's
// first column less its first row).
template <int J0, int NJ, int R>
__device__ __forceinline__ void add_direct(int *p, long long ld, bool diag,
                                           int off, int rl, int cl,
                                           const int (&acc)[R]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (!diag || rl + 8 * h <= 8 * j + cl + e + off)
          atomicAdd(p + h * 8 * ld + 8 * j + e,
                    acc[4 * (J0 + j) + 2 * h + e]);
}

constexpr int LDT = 68;  // a transposed tile's row (int32): the fragment
                         // stores of a warp on 32 distinct banks

// T[column][row] (row stride LDT) = the columns 8 J0 .. 8 (J0 + NJ) - 1 of
// an accumulator: the first half of a transposed store.
template <int J0, int NJ, int R>
__device__ __forceinline__ void to_t(int *T, int rl, int cl,
                                     const int (&acc)[R]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        T[(8 * j + cl + e) * LDT + rl + 8 * h] = acc[4 * (J0 + j) + 2 * h + e];
}

// carry (q: row 0 = the tile's column 0, column 0 = the warpgroup's row 0)
// += T's NC rows of 64, with atomics: warp w4 the rows NC / 4 w4 .., a lane
// the columns 2 lane, + 1; on a diagonal tile only the entries with (tile
// row) 2 lane + e < c + off, the mirrors of entries strictly above it.
template <int NC>
__device__ __forceinline__ void add_t(const int *T, int *q, long long ld,
                                      bool diag, int off, int w4, int lane) {
#pragma unroll
  for (int r = 0; r < NC / 4; ++r) {
    const int c = NC / 4 * w4 + r;
    const int2 v = *reinterpret_cast<const int2 *>(T + c * LDT + 2 * lane);
    int *a = q + c * ld + 2 * lane;
    if (!diag || 2 * lane < c + off) atomicAdd(a, v.x);
    if (!diag || 2 * lane + 1 < c + off) atomicAdd(a + 1, v.y);
  }
}

// One mirrored store (K1, K16): carry (q) += the transpose of columns
// 8 J0 .. of acc through this warpgroup's region T (NC x LDT int32) of the
// free decoded-column buffers, a warp's adds on whole carry rows. Called
// by every thread of the block.
template <int J0, int NJ, int NC, int R>
__device__ __forceinline__ void add_mirror(int *T, int *q, long long ld,
                                           bool own, bool diag, int off,
                                           int rl, int cl, int w4, int lane,
                                           const int (&acc)[R]) {
  if (own) to_t<J0, NJ>(T, rl, cl, acc);
  __syncthreads();
  if (own) add_t<NC>(T, q, ld, diag, off, w4, lane);
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
  add_mirror<0, 8, 64>(T, q, ld, own, diag, 0, rl, cl, w4, lane,
                       acc_v);  // V'V
  if (own) add_direct<0, 8>(p, ld, diag, 0, rl, cl, acc_v);
  add_mirror<8, 8, 64>(T, q + 3 * plane, ld, own, diag, 0, rl, cl, w4, lane,
                       acc_v);  // V'H, the mirror of H'V
  add_mirror<8, 8, 64>(T, q + plane, ld, own, diag, 0, rl, cl, w4, lane,
                       acc_h);
  if (own) {
    add_direct<8, 8>(p + plane, ld, diag, 0, rl, cl, acc_h);      // H'H
    add_direct<0, 8>(p + 3 * plane, ld, diag, 0, rl, cl, acc_h);  // H'V
  }
  add_mirror<0, 8, 64>(T, q + 2 * plane, ld, own, diag, 0, rl, cl, w4, lane,
                       acc_d);  // D'D
  if (own) add_direct<0, 8>(p + 2 * plane, ld, diag, 0, rl, cl, acc_d);
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

// ------------------------------------------------------------ K16 gram6
//
// K16's block over the upper block triangle: 128 rows x 32 columns,
// warpgroup w the rows 64 w .., each its rows' I0, I1 and I2 (decoded into
// A fragments) against B = [I0 | I1 | I2] of the 32 columns (decoded once
// a stage into shared memory), three m64n96k32 products a k step, 144
// accumulators a thread: all nine plane products of its 64 x 32 tile. (A
// 64 x 64 block whose two warpgroups share its rows, m64n192k32 and
// m64n128k32 with I1'I1 computed twice, needs 160 accumulators and was
// slower on the card.)
struct Gram6 {
  static constexpr int ROWS = 128, COLS = 32;
  static constexpr int PLANE = COLS * 128, HALF = 3 * PLANE;
  static constexpr int DBUF = 2 * HALF;  // a decoded stage: two halves
  static constexpr int SMEM = 1024 + 2 * DBUF + RING * RING_STAGE;  // 91,648
};

__device__ __forceinline__ void cp8(void *dst, const void *src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   wg::smem_addr(dst)),
               "l"(src)
               : "memory");
}

// K16: block x of the grid walks the upper block triangle of Gram6's
// blocks (row y: n / COLS - (ROWS / COLS) y of them), the blocks from
// `whole` on cut into `parts` SNP parts of part_len, as K1's triangle
// mode; carry (6, n, n), the plane grams in SYM_PAIRS order.
__global__ void __launch_bounds__(THREADS, 1)
gram6_kernel(const uint8_t *__restrict__ packed, int S_all, int B, int whole,
             int parts, int part_len, int *__restrict__ carry) {
  using G = Gram6;
  extern __shared__ uint8_t smem_raw[];
  uint8_t *const sm =
      smem_raw + ((1024u - (wg::smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t *const ring = sm + 2 * G::DBUF;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wgi = tid >> 7, g = lane >> 2, q = lane & 3;
  const int n = 4 * B;
  const long long ld = n, plane = static_cast<long long>(n) * n;
  int bx = blockIdx.x, by = 0, k_part = 0, S = S_all;
  if (bx >= whole) {  // a part of a block of the last wave
    const int tail = (gridDim.x - whole) / parts, t = bx - whole;
    bx = whole + t % tail;
    k_part = t / tail * part_len;
    S = min(S_all - k_part, part_len);
  }
  const int nc = n / G::COLS, cpr = G::ROWS / G::COLS;
  while (bx >= nc - cpr * by) {
    bx -= nc - cpr * by;
    ++by;
  }
  bx += cpr * by;
  const int r0 = by * G::ROWS, c0 = bx * G::COLS;
  const int i0 = r0 + 64 * wgi;  // this warpgroup's first row
  // the second warpgroup's rows are loaded and written when they lie in
  // the carry and not all below the diagonal
  const bool hi_rows = r0 + G::ROWS <= n && r0 + 64 <= c0 + 31;
  const bool own = wgi == 0 || hi_rows;
  const uint8_t *const ga =
      packed + (r0 >> 2) + static_cast<size_t>(k_part) * B;
  const uint8_t *const gb =
      packed + (c0 >> 2) + static_cast<size_t>(k_part) * B;
  const int nst = (S + BK - 1) / BK;
  const int rword = 16 * wgi + 4 * (warp & 3) + row_at(4 * q);
  const uint32_t sel = (g >> 2) | ((4 + (g >> 2)) << 4) |
                       ((2 + (g >> 2)) << 8) | ((6 + (g >> 2)) << 12);

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
      if (k0 + tid < S)  // columns: SNP tid, 32 samples
        cp8(rg + RING_ROW + col_at(tid),
            gb + static_cast<size_t>(k0 + tid) * B);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // ring stage st -> the columns' planes of buffer st & 1; warp: atom
  // warp % 4, half warp / 4
  auto cols = [&](int st) {
    decode_atom<true, G::PLANE>(
        ring + (st % RING) * RING_STAGE + RING_ROW,
        sm + (st & 1) * G::DBUF + (warp >> 2) * G::HALF, warp & 3, warp >> 2,
        lane, S - st * BK);
    wg::fence_proxy_async();
  };
  auto rows_of = [&](int st, int kk, uint32_t (&a)[3][4]) {
    decode_rows<true>(ring + (st % RING) * RING_STAGE + rword, kk, sel, g & 3,
                      4 * q, S - st * BK, a);
  };

  int acc0[48], acc1[48], acc2[48];  // I0, I1, I2 x [I0 | I1 | I2]
#pragma unroll
  for (int i = 0; i < 48; ++i) acc0[i] = acc1[i] = acc2[i] = 0;
  uint32_t a[2][3][4];

  load(0);
  load(1);
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();
  cols(0);
  load(2);
  __syncthreads();
  rows_of(0, 0, a[0]);
  if (own)  // the tile and its mirror into L2, lines of 32 int32
    for (int l = tid & 127; l < 6 * 128; l += 128) {
      int *const gram = carry + (l >> 7) * plane;
      const int row = (l & 127) >> 1;
      if ((l & 1) == 0)
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
            gram + static_cast<long long>(i0 + row) * ld + c0));
      if (row < G::COLS)
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
            gram + static_cast<long long>(c0 + row) * ld + i0 +
            32 * (l & 1)));
    }
  for (int st = 0; st < nst; ++st) {
    const uint32_t b0 = wg::smem_addr(sm + (st & 1) * G::DBUF);
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t(&cur)[3][4] = a[kk & 1];
      uint32_t(&nxt)[3][4] = a[(kk + 1) & 1];
      const uint64_t db =
          wg::desc(b0 + (kk >> 2) * G::HALF + 32 * (kk & 3));
      wg::keep(acc0);
      wg::keep(acc1);
      wg::keep(acc2);
      wg::fence();
      wg::mma_rs<96>(acc0, cur[0], db);  // I0 x [I0 | I1 | I2]
      wg::mma_rs<96>(acc1, cur[1], db);  // I1 x [I0 | I1 | I2]
      wg::mma_rs<96>(acc2, cur[2], db);  // I2 x [I0 | I1 | I2]
      wg::commit();
      wg::wait<1>();
      wg::keep(acc0);
      wg::keep(acc1);
      wg::keep(acc2);
#pragma unroll
      for (int p = 0; p < 3; ++p) wg::keep(nxt[p]);
      if (kk + 1 < BK / 32) {
        rows_of(st, kk + 1, nxt);
      } else if (st + 1 < nst) {
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        __syncthreads();
        cols(st + 1);
        load(st + 3);
        __syncthreads();
        rows_of(st + 1, 0, nxt);
      }
    }
  }
  wg::wait<0>();
  wg::keep(acc0);
  wg::keep(acc1);
  wg::keep(acc2);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // both warpgroups' products are done: buffers free

  // piece b of acc a: I_a(rows)' I_b(columns)
  const int w4 = warp & 3, rl = 16 * w4 + g, cl = 2 * q;
  const int off = c0 - i0;
  const bool diag = c0 < i0 + 64;  // the tile has entries below the diagonal
  int *const p = carry + static_cast<long long>(i0 + rl) * ld + c0 + cl;
  int *const qm = carry + static_cast<long long>(c0) * ld + i0;
  int *const T = reinterpret_cast<int *>(sm) + wgi * G::COLS * LDT;
  constexpr int NC = G::COLS;
  if (own) {
    add_direct<0, 4>(p, ld, diag, off, rl, cl, acc0);              // G00
    add_direct<4, 4>(p + plane, ld, diag, off, rl, cl, acc0);      // G01
    add_direct<8, 4>(p + 2 * plane, ld, diag, off, rl, cl, acc0);  // G02
  }
  add_mirror<0, 4, NC>(T, qm, ld, own, diag, off, rl, cl, w4, lane,
                       acc0);  // G00 below
  add_mirror<0, 4, NC>(T, qm + plane, ld, own, diag, off, rl, cl, w4, lane,
                       acc1);  // I1'I0: G01 below
  if (own) {
    add_direct<4, 4>(p + 3 * plane, ld, diag, off, rl, cl, acc1);  // G11
    add_direct<8, 4>(p + 4 * plane, ld, diag, off, rl, cl, acc1);  // G12
  }
  add_mirror<4, 4, NC>(T, qm + 3 * plane, ld, own, diag, off, rl, cl, w4,
                       lane, acc1);  // G11 below
  add_mirror<0, 4, NC>(T, qm + 2 * plane, ld, own, diag, off, rl, cl, w4,
                       lane, acc2);  // I2'I0: G02 below
  add_mirror<4, 4, NC>(T, qm + 4 * plane, ld, own, diag, off, rl, cl, w4,
                       lane, acc2);  // I2'I1: G12 below
  if (own)
    add_direct<8, 4>(p + 5 * plane, ld, diag, off, rl, cl, acc2);  // G22
  add_mirror<8, 4, NC>(T, qm + 5 * plane, ld, own, diag, off, rl, cl, w4,
                       lane, acc2);  // G22 below
}

int launch6(const void *packed, int S, int B, int whole, int parts,
            int part_len, void *carry, void *stream) {
  using G = Gram6;
  const int n = 4 * B, nc = n / G::COLS, nr = (n + G::ROWS - 1) / G::ROWS;
  if (nc <= 0 || S <= 0 || parts <= 0 || part_len <= 0)
    return static_cast<int>(cudaGetLastError());
  int blocks = 0;  // the upper block triangle
  for (int y = 0; y < nr; ++y) blocks += nc - G::ROWS / G::COLS * y;
  if (whole < 0 || whole > blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      gram6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  gram6_kernel<<<whole + (blocks - whole) * parts, THREADS, G::SMEM,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t *>(packed), S, B, whole, parts, part_len,
      static_cast<int *>(carry));
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ K8 gram5_cross
//
// A block: 128 cohort samples (warpgroup w the samples 64 w ..; their V, H
// and D decoded from the packed chunk into A fragments, as K1r's rows) x
// QT queries (ops/kernels.cross_plan: 16 or 64). A ring stage holds the
// cohort rows' packed bytes and the query tile's code bytes, QT rows of
// 256 SNPs (QROW bytes apart); the stage's query codes are decoded once
// into the swizzled planes Qv, Qh and Qd (wgmma's B operand). Per k step:
// V x [Qv | Qh], H x [Qv | Qh] (m64n(2 QT)k32) and D x Qd (m64n(QT)k32),
// the transposes of grams 0 and 3, 4 and 1, and 2.
template <int QT>
struct Cross {
  static constexpr int PLANE = QT * 128, HALF = 3 * PLANE, DBUF = 2 * HALF;
  static constexpr int QROW = BK + 16;  // a query row: 256 codes, 16 pad
  static constexpr int STAGE = RING_ROW + QT * QROW;
  static constexpr int SMEM = 1024 + 2 * DBUF + RING * STAGE;
  static constexpr int UNITS = QT * BK / 16 / THREADS;  // 16-byte chunks a
                                                        // thread a stage
};

// Four query code bytes (byte i: SNP i; any code above 2 missing) -> the
// V, H and D bytes of the same four genotypes.
__device__ __forceinline__ void code_basis(uint32_t w, uint32_t &v,
                                           uint32_t &h, uint32_t &d) {
  const uint32_t ones = 0x01010101u;
  w |= __vcmpgtu4(w, 0x02020202u);  // a code above 2 -> 0xFF (missing)
  const uint32_t lo = w & ones, hi = (w >> 1) & ones;
  v = ones ^ (lo & hi);                    // code != 3
  h = lo & ~hi;                            // code == 1
  const uint32_t two = hi & ~lo;           // code == 2: +1
  const uint32_t zero = ones ^ (lo | hi);  // code == 0: -1
  d = two | zero * 0xFFu;
}

// carry (q: the tile's first query row, first cohort column) += T (one
// gram's transpose, QT rows of LDT int32), a warp's adds on whole carry
// rows, its rows' loads before their adds and stores, the query rows at or
// past `rows` not written; each entry has one owner, so plain adds.
template <int NJ>
__device__ __forceinline__ void add_cross(const int *T, int *q, long long ld,
                                          int rows, int w4, int lane) {
  int2 v[2 * NJ];
#pragma unroll
  for (int r = 0; r < 2 * NJ; ++r) {
    const int c = 2 * NJ * w4 + r;
    if (c < rows)
      v[r] = *reinterpret_cast<const int2 *>(q + c * ld + 2 * lane);
  }
#pragma unroll
  for (int r = 0; r < 2 * NJ; ++r) {
    const int c = 2 * NJ * w4 + r;
    if (c < rows) {
      const int2 t = *reinterpret_cast<const int2 *>(T + c * LDT + 2 * lane);
      *reinterpret_cast<int2 *>(q + c * ld + 2 * lane) =
          make_int2(v[r].x + t.x, v[r].y + t.y);
    }
  }
}

// K8: block (x, y): cohort samples r0 = 128 x .., queries q0 = QT y ..;
// carry (5, q_rows, n). The 16-query tile's 40 accumulators leave room for
// two blocks an SM.
template <int QT>
__global__ void __launch_bounds__(THREADS, QT == 16 ? 2 : 1)
gram5_cross_kernel(const uint8_t *__restrict__ packed, int S, int B,
                   const uint8_t *__restrict__ query, int q_rows,
                   long long ldq, int Sq, int al16, int *__restrict__ carry) {
  using X = Cross<QT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t *const sm =
      smem_raw + ((1024u - (wg::smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t *const ring = sm + 2 * X::DBUF;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wgi = tid >> 7, g = lane >> 2, q = lane & 3;
  const int n = 4 * B;
  const long long ld = n, plane = static_cast<long long>(q_rows) * n;
  const int r0 = blockIdx.x * TM, q0 = blockIdx.y * QT;
  const int rows = min(QT, q_rows - q0);  // live queries of the tile
  const bool full = r0 + TM <= n;  // else samples 64.. are past the chunk
  const bool own = wgi == 0 || full;
  const uint8_t *const ga = packed + (r0 >> 2);
  const int nst = (S + BK - 1) / BK;
  const int rword = 16 * wgi + 4 * (warp & 3) + row_at(4 * q);
  const uint32_t sel = (g >> 2) | ((4 + (g >> 2)) << 4) |
                       ((2 + (g >> 2)) << 8) | ((6 + (g >> 2)) << 12);

  auto load = [&](int st) {
    if (st < nst) {
      uint8_t *rg = ring + (st % RING) * X::STAGE;
      const int k0 = st * BK;
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // cohort: SNP s, 64 samples 64h..
        const int s = (tid >> 1) + 128 * r, h = tid & 1;
        if (k0 + s < S && (h == 0 || full))
          cp16(rg + row_at(s) + 16 * h,
               ga + static_cast<size_t>(k0 + s) * B + 16 * h);
      }
#pragma unroll
      for (int i = 0; i < X::UNITS; ++i) {  // query row r, SNPs s .. s + 15
        const int u = tid + THREADS * i, r = u >> 4, s = k0 + 16 * (u & 15);
        if (r < rows && s < Sq) {
          uint8_t *dst = rg + RING_ROW + r * X::QROW + 16 * (u & 15);
          const uint8_t *src =
              query + static_cast<long long>(q0 + r) * ldq + s;
          if (al16 && s + 16 <= Sq) {
            cp16(dst, src);
          } else {  // an unaligned query, or its last SNPs: byte loads
            uint32_t w[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              w[j] = 0;
#pragma unroll
              for (int b = 0; b < 4; ++b)
                if (s + 4 * j + b < Sq)
                  w[j] |= static_cast<uint32_t>(__ldg(src + 4 * j + b))
                          << (8 * b);
            }
            *reinterpret_cast<uint4 *>(dst) =
                make_uint4(w[0], w[1], w[2], w[3]);
          }
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // ring stage st's query codes -> the Qv, Qh, Qd planes of buffer st & 1;
  // SNPs at or past Sq missing
  auto cols = [&](int st) {
    const uint8_t *src = ring + (st % RING) * X::STAGE + RING_ROW;
    uint8_t *dst = sm + (st & 1) * X::DBUF;
    const int nvq = Sq - st * BK;
#pragma unroll
    for (int i = 0; i < X::UNITS; ++i) {
      const int u = tid + THREADS * i, r = u >> 4, ch = u & 15;
      const uint4 w =
          *reinterpret_cast<const uint4 *>(src + r * X::QROW + 16 * ch);
      uint32_t x[4] = {w.x, w.y, w.z, w.w};
      if (16 * ch + 16 > nvq)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (16 * ch + 4 * j + b >= nvq) x[j] |= 0xFFu << (8 * b);
      uint32_t v[4], h[4], d[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) code_basis(x[j], v[j], h[j], d[j]);
      uint8_t *p = dst + (ch >> 3) * X::HALF + wg::sw128(r, 16 * (ch & 7));
      *reinterpret_cast<uint4 *>(p) = make_uint4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<uint4 *>(p + X::PLANE) =
          make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4 *>(p + 2 * X::PLANE) =
          make_uint4(d[0], d[1], d[2], d[3]);
    }
    wg::fence_proxy_async();
  };
  auto rows_of = [&](int st, int kk, uint32_t (&a)[3][4]) {
    decode_rows(ring + (st % RING) * X::STAGE + rword, kk, sel, g & 3, 4 * q,
                S - st * BK, a);
  };

  // [V'Qv | V'Qh], [H'Qv | H'Qh] and D'Qd of this warpgroup's 64 samples
  int acc_v[QT], acc_h[QT], acc_d[QT / 2];
#pragma unroll
  for (int i = 0; i < QT; ++i) acc_v[i] = acc_h[i] = 0;
#pragma unroll
  for (int i = 0; i < QT / 2; ++i) acc_d[i] = 0;
  uint32_t a[2][3][4];

  load(0);
  load(1);
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();
  cols(0);
  load(2);
  __syncthreads();
  rows_of(0, 0, a[0]);
  // the carry tile into L2 (inside the loop, ptxas serialized the products)
  if (own)
    for (int l = tid & 127; l < 5 * 2 * QT; l += 128) {
      const int row = (l % (2 * QT)) >> 1;
      if (row < rows)
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
            carry + (l / (2 * QT)) * plane +
            static_cast<long long>(q0 + row) * ld + r0 + 64 * wgi +
            32 * (l & 1)));
    }
  for (int st = 0; st < nst; ++st) {
    const uint32_t b0 = wg::smem_addr(sm + (st & 1) * X::DBUF);
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t(&cur)[3][4] = a[kk & 1];
      uint32_t(&nxt)[3][4] = a[(kk + 1) & 1];
      const uint32_t bk = b0 + (kk >> 2) * X::HALF + 32 * (kk & 3);
      const uint64_t bvh = wg::desc(bk);
      wg::keep(acc_v);
      wg::keep(acc_h);
      wg::keep(acc_d);
      wg::fence();
      wg::mma_rs<2 * QT>(acc_v, cur[0], bvh);  // V x [Qv | Qh]
      wg::mma_rs<2 * QT>(acc_h, cur[1], bvh);  // H x [Qv | Qh]
      wg::mma_rs<QT>(acc_d, cur[2], wg::desc(bk + 2 * X::PLANE));  // D x Qd
      wg::commit();
      wg::wait<1>();
      wg::keep(acc_v);
      wg::keep(acc_h);
      wg::keep(acc_d);
#pragma unroll
      for (int p = 0; p < 3; ++p) wg::keep(nxt[p]);
      if (kk + 1 < BK / 32) {
        rows_of(st, kk + 1, nxt);
      } else if (st + 1 < nst) {
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        __syncthreads();
        cols(st + 1);
        load(st + 3);
        __syncthreads();
        rows_of(st + 1, 0, nxt);
      }
    }
  }
  wg::wait<0>();
  wg::keep(acc_v);
  wg::keep(acc_h);
  wg::keep(acc_d);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // both warpgroups' products are done: buffers free

  // the five transposes at once in the freed buffers and ring (5 QT rows
  // of LDT a warpgroup), then the adds: one barrier, the loads of a gram's
  // rows in flight together
  const int w4 = warp & 3, rl = 16 * w4 + g, cl = 2 * q;
  constexpr int NJ = QT / 8, TQ = QT * LDT;
  static_assert(2 * 5 * TQ * 4 <= 2 * X::DBUF + RING * X::STAGE,
                "the transposes fit in the freed shared memory");
  int *const T = reinterpret_cast<int *>(sm) + wgi * 5 * TQ;
  int *const base = carry + static_cast<long long>(q0) * ld + r0 + 64 * wgi;
  if (own) {
    to_t<0, NJ>(T, rl, cl, acc_v);            // Qv'V
    to_t<NJ, NJ>(T + TQ, rl, cl, acc_v);      // Qh'V
    to_t<0, NJ>(T + 2 * TQ, rl, cl, acc_h);   // Qv'H
    to_t<NJ, NJ>(T + 3 * TQ, rl, cl, acc_h);  // Qh'H
    to_t<0, NJ>(T + 4 * TQ, rl, cl, acc_d);   // Qd'D
  }
  __syncthreads();
  if (own) {
    add_cross<NJ>(T, base, ld, rows, w4, lane);
    add_cross<NJ>(T + TQ, base + 3 * plane, ld, rows, w4, lane);
    add_cross<NJ>(T + 2 * TQ, base + 4 * plane, ld, rows, w4, lane);
    add_cross<NJ>(T + 3 * TQ, base + plane, ld, rows, w4, lane);
    add_cross<NJ>(T + 4 * TQ, base + 2 * plane, ld, rows, w4, lane);
  }
}

template <int QT>
int launch_cross(const void *packed, int S, int B, const void *query,
                 int q_rows, long long ldq, int Sq, void *carry,
                 void *stream) {
  using X = Cross<QT>;
  const cudaError_t e = cudaFuncSetAttribute(
      gram5_cross_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      X::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int al16 =
      reinterpret_cast<uintptr_t>(query) % 16 == 0 && ldq % 16 == 0;
  gram5_cross_kernel<QT>
      <<<dim3((4 * B + TM - 1) / TM, (q_rows + QT - 1) / QT), THREADS,
         X::SMEM, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t *>(packed), S, B,
          static_cast<const uint8_t *>(query), q_rows, ldq, Sq, al16,
          static_cast<int *>(carry));
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

// K16: packed (S, B) uint8, B % 16 == 0, 16-byte aligned; carry (6, 4B, 4B)
// int32 (the plane grams in SYM_PAIRS order), updated in place over the
// full square from the upper block triangle of 128 x 32 blocks; the blocks
// from `whole` on cut into `parts` SNP parts of part_len, a multiple of 256
// (ops/kernels.py:gram6_plan). Launches on `stream`; returns the CUDA
// error (0 on success).
extern "C" int gram6_launch(const void *packed, int S, int B, int whole,
                            int parts, int part_len, void *carry,
                            void *stream) {
  return launch6(packed, S, B, whole, parts, part_len, carry, stream);
}

// K8: packed (S, B) uint8, B % 16 == 0, 16-byte aligned (the cohort
// chunk); query: q_rows rows of code bytes with row stride ldq, of which
// the first Sq <= S columns are read (any alignment: rows and strides of
// 16 bytes are copied by cp.async, others byte by byte); carry (5, q_rows,
// 4B) int32, updated in place; qt the query tile (ops/kernels.py:
// cross_plan: 16 or 64). Launches on `stream`; returns the CUDA error (0 on
// success).
extern "C" int gram5_cross_launch(const void *packed, int S, int B,
                                  const void *query, int q_rows,
                                  long long ldq, int Sq, int qt, void *carry,
                                  void *stream) {
  if (B <= 0 || q_rows <= 0 || S <= 0)
    return static_cast<int>(cudaGetLastError());
  if (qt == 16)
    return launch_cross<16>(packed, S, B, query, q_rows, ldq, Sq, carry,
                            stream);
  if (qt == 64)
    return launch_cross<64>(packed, S, B, query, q_rows, ldq, Sq, carry,
                            stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
