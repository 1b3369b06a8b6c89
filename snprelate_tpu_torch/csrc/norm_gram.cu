// K2b norm_gram: fused 2-bit decode + normalization + covariance gram, with
// the GCTA valid-and-polymorphic count gram on request; its strip mode
// norm_gram_rows and its tile mode norm_gram_tile.
//
// Replaces snprelate_tpu/ops/pairwise.py:_pca_step (make_pca_block ->
// _sym_blocks) and _gcta_step, and the float grams of _king_homo_step and
// _eigmix_step. For one packed SNP chunk and its per-SNP avg/scale (from
// snp_stats) it adds X'X into a float64 (N, N) carry, where
//   x[s, i] = (g - avg[s]) * scale[s] for a valid call, 0 for a missing one
// (mean imputation, then centering), or, in indicator mode,
//   x[s, i] = scale[s] for a valid call, 0 for a missing one,
// so X'X = sum_s scale[s]^2 v_i v_j, the allele-frequency-weighted validity
// grams of KING-homo and EIGMIX. With a count carry (GCTA) it also adds the
// int32 gram of vp[s, i] = valid[s, i] and poly[s].
//
// The strip mode replaces _gcta_rows_step and _pca_rows_step
// (snprelate_tpu/ops/pairwise.py:807, :822) and the float strips of
// _king_homo_rows_step and _eigmix_rows_step (:1090, :1141): for the sample
// rows [row0, row0 + R) it adds X_r'X into a float64 (R, N) carry (and the
// count gram into an int32 (R, N) carry), every tile of the rectangle
// computed, none mirrored.
//
// The tile mode replaces _gcta_tile_scan_c (snprelate_tpu/ops/tiles.py:241)
// and the float grams of _eigmix_tile_scan_c and _king_homo_tile_scan_c
// (:886, :1035): X_i'X_j of two packed sample-group slabs (S, g/4) of one
// super tile, every tile of the (g, g) square computed, added into a
// float64 (g, g) carry (and the count gram into an int32 one). With
// `divide` set (GCTA) the epilogue then replaces each entry by
// carry / (2 vcarry), the per-pair missing denominator applied on the card
// as the JAX scan does, so only the finished GRM tile leaves it. The
// caller splits a tile past 2^24 SNPs into launches below it and divides
// on the last.
//
// What bounds it on the card: tensor-core operations. The float gram is
// 3xTF32, three TF32 products per multiply-add, 3 * 2 S N_r N_c at the
// 495 TFLOP/s of dense TF32 (each pair once in the square modes), and the
// count gram 2 S N_r N_c at the 1,979 TOP/s of int8, against S N/4 bytes
// of codes and the carries read and written once per chunk.
//
// The float path and why: x is formed in double and rounded to float,
// then split into TF32 parts hi = tf32(x), lo = tf32(x - hi)
// (cvt.rna), and every product is lo_a hi_b + hi_a lo_b + hi_a hi_b on
// mma.sync.m16n8k8 .tf32 with float32 accumulators, folded into float64
// every FOLD SNPs, so the error does not grow with S. The probe
// (chip_smoke.py --mma-probe, PERF.md) measured this shape at 305-323
// TFLOP/s on an H100 against 65-67 for the float64 m16n8k8 of
// rand_mma.cuh, so three TF32 products cost about a third of one float64
// product. The smoke measures 2.3e-6 to 4.0e-6 of the largest entry
// against the float64 plain version (the tensor cores' float32 sums round
// toward zero; the fold bounds each sum at 96 products), inside the 2e-5
// budget.
//
// What holds it at about 60 % of the probe's TF32 rate: one block of 8
// warps an SM (the 128 KB float64 partial tile), and per fragment element
// a shift, a LOP3 and two table loads beside each warp's 48 products of a
// k step; 232 registers a thread with the count gram, no spills.
//
// Design: a block owns a 128 x 128 output tile (8 warps of 64 x 32) and
// streams the chunk in 64-SNP stages through a three-stage cp.async ring:
// the stage's code bytes of the block's rows and columns, their rows of the
// decode table (formed once a launch by norm_table: the four x of each
// code as TF32 hi and lo parts, 0 for code 3) and the GCTA poly mask. No
// normalized block exists in memory: each lane decodes its fragments from
// the code bytes with two table loads per element, straight into its
// fragment registers. The fragment indices are mapped to samples so that
// a lane's codes share bytes: row g + 8h of m-tile mt is sample
// 8g + 2mt + h of the warp's 64 rows (two code bytes),
// column c of n-tile nt is sample 4c + nt of its 32 columns (one byte),
// and step kk's k index t + 4j is SNP 8kk + t + 4j of a 32-SNP group, so a
// lane owns an 8 x 8 block of the tile and reads 8 SNPs' bytes a group.
// The count gram is an int8 tensor-core product (mma.sync.m16n8k32 s8)
// on the same tile from the same code bytes: the k index 4t + b (+16) is
// SNP t + 4b (+16), so a lane's int8 fragments gather its own bytes
// (byte permutes, then valid-and-poly bits spread to 0/1 bytes), and the
// int32 sums are exact. Each block accumulates float32
// partials in registers and adds them every FOLD SNPs into a float64 tile
// in shared memory (each lane its own slots: no barrier), which the
// epilogue adds into the carry. The square modes compute the tiles on and
// above the diagonal only: one block adds its tile at its place and,
// transposed, at the mirror place; a diagonal tile writes each lower entry
// from its upper one, so the result is exactly symmetric. Ragged 64-sample
// edges (N and R are multiples of 64) are whole warps that write nothing;
// SNPs past S have zero table rows and masks. Every entry has one owner and
// no atomics are used, so two launches are bitwise equal.

#include "rand_mma.cuh"  // the cp.async helpers

namespace {

constexpr int TILE = 128;      // samples per output-tile side
constexpr int BK = 64;         // SNPs per stage
constexpr int GROUP = 32;      // SNPs per int8 product (and 4 TF32 steps)
constexpr int STAGES = 3;      // the cp.async ring
constexpr int FOLD = 256;      // SNPs summed in float32 between folds
constexpr int THREADS = 256;   // 8 warps: 2 (rows) x 4 (columns), 64 x 32
constexpr int LDC = 80;        // bytes per SNP of a code stage: 32 row-side,
                               // 32 column-side, 16 pad (conflict-free)
constexpr int STAGE_BYTES = BK * LDC + BK * 32 + BK;  // codes, table, mask
constexpr int PART_BYTES = TILE * TILE * 8;  // the float64 partial tile
constexpr int SMEM = PART_BYTES + STAGES * STAGE_BYTES;
constexpr int SLOTS = 64;      // float64 partials per lane

enum Mode { SQUARE, ROWS, TILES };

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t *a,
                                         const uint32_t *b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// The valid-and-poly bits of four code bytes (2 bits a sample): bit 2q of
// byte b set if sample q of byte b is not missing (code 3) and the mask
// byte b is 0x55 (poly).
__device__ __forceinline__ uint32_t vp_bits(uint32_t codes, uint32_t mask) {
  return ~(codes & (codes >> 1)) & mask;
}

// The shared address of the hi part of code q (bits 2q, 2q + 1 of w) in
// the table row at tb (16-byte aligned): 4 * code or'ed into tb, a shift
// and one LOP3 an element; the load adds the row's offset as an immediate.
__device__ __forceinline__ uint32_t code4(uint32_t w, int q, uint32_t tb) {
  return ((q ? w >> (2 * q - 2) : w << 2) & 0xCu) | tb;
}

__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}

// The slot of the float64 partial of block-tile entry (r, c): warp, k index
// (m-tile, n-tile, fragment) and lane, as the fragments map them.
__device__ __forceinline__ int slot(int r, int c) {
  const int warp = (r >> 6) * 4 + (c >> 5), lane = ((r >> 3) & 7) * 4 +
                                                  ((c >> 3) & 3);
  const int rl = r & 7, cl = c & 7;
  const int k = ((rl >> 1) * 4 + (cl & 3)) * 4 + 2 * (rl & 1) + (cl >> 2);
  return (warp * SLOTS + k) * 32 + lane;
}

// The decode table of a launch: for SNP s < S, tab[8s + c] and
// tab[8s + 4 + c] the TF32 hi and lo parts of the x of code c (0 for code
// 3), x formed in double and rounded to float; for S <= s < s_pad zeros.
// (hi and lo apart, so that a lane's lookups land in its fragment
// registers as they are: no register moves.)
// mask[s_pad]: 0x55 for a poly SNP (0 without poly, or past S) at the
// position a lane's int8 fragment reads it, 16h + 4t + b for SNP
// 16h + t + 4b of each 32-SNP group.
__global__ void norm_table_kernel(const double *__restrict__ avg,
                                  const double *__restrict__ scale,
                                  const bool *__restrict__ poly, int S,
                                  int s_pad, int indicator,
                                  float *__restrict__ tab,
                                  uint8_t *__restrict__ mask) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= s_pad) return;
  uint32_t v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  uint8_t m = 0;
  if (s < S) {
    const double mu = avg[s], sc = scale[s];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float x = (float)(indicator ? sc : ((double)c - mu) * sc);
      const uint32_t hi = tf32(x);
      v[c] = hi;
      v[4 + c] = tf32(x - __uint_as_float(hi));
    }
    if (poly != nullptr && poly[s]) m = 0x55;
  }
  uint4 *d = reinterpret_cast<uint4 *>(tab + 8 * (size_t)s);
  d[0] = make_uint4(v[0], v[1], v[2], v[3]);
  d[1] = make_uint4(v[4], v[5], v[6], v[7]);
  const int q = s & 31;
  mask[(s - q) + 16 * (q >> 4) + 4 * (q & 3) + ((q & 15) >> 2)] = m;
}

// SQUARE: the upper tiles of the square (row0 = 0, rows = N, pb = pa).
// ROWS: the strip mode, block (x, y) owning carry rows 128y, the sample rows
// row0 + 128y of the packed chunk, and columns 128x (pb = pa). TILES: block
// (x, y) owning rows 128y of pa and columns 128x of pb, every tile;
// `divide` (with GCTA) ends with carry / (2 vcarry). rows: the carry's row
// count (a multiple of 64).
template <bool GCTA, Mode MODE>
__global__ void __launch_bounds__(THREADS, 1)
norm_gram_kernel(const uint8_t *__restrict__ pa, const uint8_t *__restrict__ pb,
                 int S, int B, int row0, int rows,
                 const float *__restrict__ table,
                 const uint8_t *__restrict__ mask, double *__restrict__ carry,
                 int *__restrict__ vcarry, int divide) {
  // a lower tile of the square: written by its mirror
  if (MODE == SQUARE && blockIdx.x < blockIdx.y) return;
  extern __shared__ __align__(16) uint8_t sm[];
  double *part = reinterpret_cast<double *>(sm);
  uint8_t *stages = sm + PART_BYTES;
  const int N = 4 * B;
  const int r0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  const int ia = (row0 + r0) >> 2, jb = j0 >> 2;  // the tile's code bytes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
  const int nst = (S + BK - 1) / BK;

  // One stage: per SNP two 16-byte copies of each side's 32 code bytes
  // (past the chunk's bytes or SNPs: zero-filled, and written nowhere),
  // two of its table row; then the stage's 64 mask bytes.
  auto load_stage = [&](int it) {
    uint8_t *cs = stages + (it % STAGES) * STAGE_BYTES;
    const int k0 = it * BK;
    for (int e = tid; e < BK * 6 + 4; e += THREADS) {
      if (e < BK * 4) {
        const int s = e >> 2, side = (e >> 1) & 1, half = e & 1;
        const int off = (side ? jb : ia) + 16 * half;
        const bool ok = k0 + s < S && off < B;
        const uint8_t *src = ok ? (side ? pb : pa) + (size_t)(k0 + s) * B + off
                                : pa;
        rand_mma::cp16(cs + s * LDC + 32 * side + 16 * half, src, ok ? 16 : 0);
      } else if (e < BK * 6) {
        const int s = (e - BK * 4) >> 1, half = e & 1;
        rand_mma::cp16(cs + BK * LDC + 32 * s + 16 * half,
                       table + 8 * ((size_t)k0 + s) + 4 * half, 16);
      } else {
        const int q = e - BK * 6;
        rand_mma::cp16(cs + BK * LDC + BK * 32 + 16 * q, mask + k0 + 16 * q,
                       16);
      }
    }
  };
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) {
    if (it < nst) load_stage(it);
    rand_mma::commit();
  }

  double *mine = part + (size_t)warp * SLOTS * 32 + lane;  // slot k: [32k]
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) mine[32 * k] = 0.0;
  float acc[4][4][4];
  int cnt[GCTA ? 4 : 1][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        acc[mt][nt][f] = 0.f;
        if constexpr (GCTA) cnt[mt][nt][f] = 0;
      }

  for (int it = 0; it < nst; ++it) {
    rand_mma::wait<STAGES - 2>();
    __syncthreads();  // stage it has landed; stage it - 1 is consumed
    if (it + STAGES - 1 < nst) load_stage(it + STAGES - 1);
    rand_mma::commit();
    const uint8_t *cs = stages + (it % STAGES) * STAGE_BYTES;
    // the lane's first table row of the stage (SNP t)
    const uint32_t ts = rand_mma::smem(cs + BK * LDC) + 32 * t;
    const uint8_t *ms = cs + BK * LDC + BK * 32;
#pragma unroll
    for (int grp = 0; grp < BK / GROUP; ++grp) {
      // the lane's SNPs of the group: t + 4m, m = 0..7; its row-side code
      // bytes 2g, 2g + 1 of the warp's 16 and column-side byte g of its 8
      uint32_t ca[8], cb[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const uint8_t *row = cs + (GROUP * grp + t + 4 * m) * LDC;
        ca[m] = *reinterpret_cast<const uint16_t *>(row + 16 * wm + 2 * g);
        cb[m] = row[32 + 8 * wn + g];
      }
#pragma unroll
      for (int kk = 0; kk < GROUP / 8; ++kk) {
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int m = 2 * kk + j;
          const int row = 32 * (GROUP * grp + 4 * m);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const uint32_t v = code4(cb[m], nt, ts) + row;
            bh[nt][j] = lds32(v);
            bl[nt][j] = lds32(v + 16);
          }
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int m = 2 * kk + j;
            const int row = 32 * (GROUP * grp + 4 * m);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t v = code4(ca[m], 2 * mt + h, ts) + row;
              ah[2 * j + h] = lds32(v);
              al[2 * j + h] = lds32(v + 16);
            }
          }
          // the small terms first; each accumulator's three products
          // four apart, so they do not wait on each other
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], al, bh[nt]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], ah, bl[nt]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], ah, bh[nt]);
        }
      }
      if constexpr (GCTA) {
        // int8 fragments: byte b of a register is SNP t + 4b (+16 for the
        // second half) of the group, as the lane's codes ca / cb hold them
        uint32_t ai[4][4], bi[4][2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = 4 * half;
          const uint32_t t01 = prmt(ca[m], ca[m + 1], 0x5140);
          const uint32_t t23 = prmt(ca[m + 2], ca[m + 3], 0x5140);
          const uint32_t mk = *reinterpret_cast<const uint32_t *>(
              ms + GROUP * grp + 16 * half + 4 * t);
          const uint32_t vlo = vp_bits(prmt(t01, t23, 0x5410), mk);
          const uint32_t vhi = vp_bits(prmt(t01, t23, 0x7632), mk);
          const uint32_t vb = vp_bits(
              prmt(prmt(cb[m], cb[m + 1], 0x0040),
                   prmt(cb[m + 2], cb[m + 3], 0x0040), 0x5410), mk);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int q = 2 * mt + h;
              ai[mt][2 * half + h] =
                  ((q < 4 ? vlo : vhi) >> (2 * (q & 3))) & 0x01010101u;
            }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            bi[nt][half] = (vb >> (2 * nt)) & 0x01010101u;
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_s8(cnt[mt][nt], ai[mt], bi[nt]);
      }
    }
    if ((it + 1) % (FOLD / BK) == 0 || it + 1 == nst) {
      // the fold: float32 partials into the lane's float64 slots
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            mine[32 * ((mt * 4 + nt) * 4 + f)] += (double)acc[mt][nt][f];
            acc[mt][nt][f] = 0.f;
          }
    }
  }

  // Epilogue. The lane's entries: block-tile rows 64wm + 8g + r and columns
  // 32wn + 8t + c (r = 2mt + h, c = 4e + nt; slot (mt, nt, 2h + e)).
  const bool diag = MODE == SQUARE && blockIdx.x == blockIdx.y;
  if (diag) __syncthreads();  // lower entries read their upper one's slot
  const int rl0 = 64 * wm + 8 * g, cl0 = 32 * wn + 8 * t;
  if (r0 + 64 * wm >= rows || j0 + 32 * wn >= N) return;  // ragged edge
  auto total = [&](int r, int c) {
    const int rl = rl0 + r, cl = cl0 + c;
    return diag && rl > cl ? part[slot(cl, rl)] : part[slot(rl, cl)];
  };
  auto count = [&](int r, int c) {
    if constexpr (GCTA) return cnt[r >> 1][c & 3][2 * (r & 1) + (c >> 2)];
    return 0;
  };
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    double *p = carry + (size_t)(r0 + rl0 + r) * N + j0 + cl0;
    double v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] = total(r, c);
    if constexpr (GCTA) {
      int *q = vcarry + (size_t)(r0 + rl0 + r) * N + j0 + cl0;
      int n[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int4 w = reinterpret_cast<const int4 *>(q)[h];
        w.x += count(r, 4 * h);
        w.y += count(r, 4 * h + 1);
        w.z += count(r, 4 * h + 2);
        w.w += count(r, 4 * h + 3);
        reinterpret_cast<int4 *>(q)[h] = w;
        n[4 * h] = w.x;
        n[4 * h + 1] = w.y;
        n[4 * h + 2] = w.z;
        n[4 * h + 3] = w.w;
      }
#pragma unroll
      for (int c = 0; c < 8; c += 2) {
        double2 w = reinterpret_cast<const double2 *>(p)[c / 2];
        w.x += v[c];
        w.y += v[c + 1];
        if (MODE == TILES && divide) {
          w.x /= 2.0 * (double)n[c];
          w.y /= 2.0 * (double)n[c + 1];
        }
        reinterpret_cast<double2 *>(p)[c / 2] = w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < 8; c += 2) {
        double2 w = reinterpret_cast<const double2 *>(p)[c / 2];
        w.x += v[c];
        w.y += v[c + 1];
        reinterpret_cast<double2 *>(p)[c / 2] = w;
      }
    }
  }
  if (MODE == SQUARE && !diag) {
    // the mirror tile += the transpose, column c of the lane's block as
    // a row of the carry
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      double *p = carry + (size_t)(j0 + cl0 + c) * N + r0 + rl0;
#pragma unroll
      for (int r = 0; r < 8; r += 2) {
        double2 w = reinterpret_cast<const double2 *>(p)[r / 2];
        w.x += total(r, c);
        w.y += total(r + 1, c);
        reinterpret_cast<double2 *>(p)[r / 2] = w;
      }
      if constexpr (GCTA) {
        int *q = vcarry + (size_t)(j0 + cl0 + c) * N + r0 + rl0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int4 w = reinterpret_cast<const int4 *>(q)[h];
          w.x += count(4 * h, c);
          w.y += count(4 * h + 1, c);
          w.z += count(4 * h + 2, c);
          w.w += count(4 * h + 3, c);
          reinterpret_cast<int4 *>(q)[h] = w;
        }
      }
    }
  }
}

template <Mode MODE>
int launch(const void *pa, const void *pb, int S, int B, int row0, int rows,
           const void *table, void *carry, void *vcarry, int divide,
           void *stream) {
  const int N = 4 * B;
  const dim3 grid((N + TILE - 1) / TILE, (rows + TILE - 1) / TILE);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  const auto *p = static_cast<const uint8_t *>(pa);
  const auto *q = static_cast<const uint8_t *>(pb);
  const auto *tab = static_cast<const float *>(table);
  const int s_pad = (S + BK - 1) / BK * BK;
  const auto *mk = reinterpret_cast<const uint8_t *>(tab + 8 * (size_t)s_pad);
  auto *c = static_cast<double *>(carry);
  if (vcarry) {
    cudaFuncSetAttribute(norm_gram_kernel<true, MODE>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    norm_gram_kernel<true, MODE><<<grid, THREADS, SMEM, st>>>(
        p, q, S, B, row0, rows, tab, mk, c, static_cast<int *>(vcarry),
        divide);
  } else {
    cudaFuncSetAttribute(norm_gram_kernel<false, MODE>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    norm_gram_kernel<false, MODE><<<grid, THREADS, SMEM, st>>>(
        p, q, S, B, row0, rows, tab, mk, c, nullptr, 0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The decode table of S SNPs into `table`: s_pad = S rounded up to 64
// float rows of 8 (the TF32 hi of codes 0, 1, 2 and 3, then lo) then s_pad
// mask bytes (ops/kernels.py norm_table_plain is its plain twin). avg,
// scale: (S,) float64; poly: (S,) bool or null; indicator: 0 or 1 (x =
// scale on valid calls; avg is then unused). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int norm_table_launch(const void *avg, const void *scale,
                                 const void *poly, int S, int indicator,
                                 void *table, void *stream) {
  const int s_pad = (S + BK - 1) / BK * BK;
  if (s_pad > 0) {
    float *tab = static_cast<float *>(table);
    norm_table_kernel<<<(s_pad + 255) / 256, 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double *>(avg), static_cast<const double *>(scale),
        static_cast<const bool *>(poly), S, s_pad, indicator, tab,
        reinterpret_cast<uint8_t *>(tab + 8 * (size_t)s_pad));
  }
  return static_cast<int>(cudaGetLastError());
}

// packed: (S, B) uint8, B % 16 == 0, 16-byte aligned; table: the chunk's
// norm_table; carry: (4B, 4B) float64, 16-byte aligned, updated in place.
// With vcarry (4B, 4B) int32 (GCTA; a table with poly) it also adds the
// count gram into vcarry in place. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int norm_gram_launch(const void *packed, int S, int B,
                                const void *table, void *carry, void *vcarry,
                                void *stream) {
  return launch<SQUARE>(packed, packed, S, B, 0, 4 * B, table, carry, vcarry,
                        0, stream);
}

// The strip mode: as norm_gram_launch, with carry (rows, 4B) float64 and
// vcarry (rows, 4B) int32 (or null) holding the sample rows
// [row0, row0 + rows); row0 and rows multiples of 64, row0 + rows <= 4B.
extern "C" int norm_gram_rows_launch(const void *packed, int S, int B,
                                     int row0, int rows, const void *table,
                                     void *carry, void *vcarry,
                                     void *stream) {
  return launch<ROWS>(packed, packed, S, B, row0, rows, table, carry, vcarry,
                      0, stream);
}

// The tile mode: slab_i, slab_j (S, B) uint8 each (may be the same
// pointer), the other arguments as norm_gram_launch with carry (4B, 4B)
// float64 and vcarry (4B, 4B) int32 (or null) holding the rows of slab_i
// against the columns of slab_j. divide: 1 (needs vcarry) to end with
// carry = carry / (2 vcarry) entrywise.
extern "C" int norm_gram_tile_launch(const void *slab_i, const void *slab_j,
                                     int S, int B, const void *table,
                                     void *carry, void *vcarry, int divide,
                                     void *stream) {
  return launch<TILES>(slab_i, slab_j, S, B, 0, 4 * B, table, carry, vcarry,
                       divide, stream);
}
