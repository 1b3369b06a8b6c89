// K6 king_screen: the KING-robust relatedness screen of one row strip, with
// its hits compacted in row-major order; and its tile mode K6t
// king_screen_tile.
//
// Replaces _strip_counters, strip_hits, strip_mask and gather_hits of
// snprelate_tpu/models/king.py:king_ibd_selection (:411, :456, :480, :486).
// Input: the five int32 (R, N) strip grams of K1r (vv, hh, dd, hv, vh for
// the sample rows [row0, row0 + R)) and the family codes (N,) int32 (-1: no
// family). For each pair (row0 + r, j) with j < row0 + r (the strict lower
// triangle) and r < nrows it forms, in integers,
//   homo = vv + hh - hv - vh, IBS0 = (homo - dd) / 2,
//   IBS2 = (homo + dd) / 2 + hh, IBS1 = vv - IBS0 - IBS2,
//   ss = IBS1 + 4 IBS0, and min(hv, vh) or hv + vh,
// and applies the JAX package's admit-only float32 pre-test:
//   ss <= thr * m + slack * m + 1 with m = min(hv, vh) > 0 between
//   families (thr = 2 - 4c) and m = hv + vh > 0 within one (thr = 1 - 2c),
//   slack = 4e-6 |thr|,
// each product and sum rounded to float32 on its own, so the plain version's
// float32 tensor operations give the same bits. The hits are written as
// (7, hits) int32: strip row, column, ss, hv, vh, IBS0, vv.
//
// K6t replaces tile_hits (snprelate_tpu/models/king.py:146) of the
// super-tile screen: the same test on one (g, g) tile of K1t's five grams,
// the row samples' family codes and the column samples' apart. An
// off-diagonal tile tests every pair; a diagonal tile only its strict lower
// triangle in tile coordinates (row_off + r > j with row_off = r0 - c0 = 0).
// The hits are (7, hits) int32: tile row, tile column, then the five
// counters, in row-major tile order (the order of jnp.nonzero).
//
// What bounds it on the card: bytes. Each pass reads the five carries over
// the triangle once (20 bytes per pair) and does some twenty integer and
// float operations per pair; the hit list is small.
//
// Design: two passes over the same per-pair test, one warp per strip row,
// its 32 lanes on 32 neighbouring columns, so every load coalesces. Pass
// one counts each row's hits (ballot + popc). The caller takes the
// exclusive scan of the row counts (int64). Pass two walks each row's
// columns in order: a warp ballot marks the hits among 32 columns, each hit
// lane writes at the row's offset plus the popc of the lower lanes' bits,
// and the offset moves on by the ballot's popc. So the list is exactly as
// long as the hit count, in row-major order (the order of nonzero), and the
// same on every run: no atomics. Offsets and carry indices are 64-bit, so a
// strip past 2^31 entries needs no sub-blocks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // 8 warps, one strip row each
constexpr int ROWS_PER_BLOCK = THREADS / 32;

struct Screen {
  const int *vv, *hh, *dd, *hv, *vh;  // (R, N) strip or (g, g) tile grams
  const int *fam_r, *fam_c;           // family codes of the rows, columns
  long long ld;                       // row stride N (or g)
  int nrows, ncols;                   // rows screened, columns per row
  int tri, row_off;  // tri: only columns j < row_off + r of row r
  float thr_b, slack_b, thr_w, slack_w;  // between / within families
};

// The columns row r tests: [0, cols(r)).
__device__ __forceinline__ int cols_of(const Screen &s, int r) {
  return s.tri ? min(s.ncols, max(0, s.row_off + r)) : s.ncols;
}

// The counters and the pre-test of pair (r, j) of the grams; returns the
// hit flag and the five counters the list keeps.
__device__ __forceinline__ bool test(const Screen &s, int r, int j,
                                     int famr, int (&out)[5]) {
  const long long k = (long long)r * s.ld + j;
  const int vv = __ldg(s.vv + k), hh = __ldg(s.hh + k), dd = __ldg(s.dd + k);
  const int hv = __ldg(s.hv + k), vh = __ldg(s.vh + k);
  const int homo = vv + hh - hv - vh;
  const int ibs0 = (homo - dd) / 2;  // homo - dd = 2 IBS0 >= 0: exact
  const int ibs2 = (homo + dd) / 2 + hh;
  const int ibs1 = vv - ibs0 - ibs2;
  const int ss = ibs1 + 4 * ibs0;
  const int famj = __ldg(s.fam_c + j);
  const bool same = famr == famj && famr >= 0;
  const int m = same ? hv + vh : min(hv, vh);
  const float thr = same ? s.thr_w : s.thr_b;
  const float slack = same ? s.slack_w : s.slack_b;
  const float mf = __int2float_rn(m);
  const float bound = __fadd_rn(
      __fadd_rn(__fmul_rn(thr, mf), __fmul_rn(slack, mf)), 1.0f);
  out[0] = ss;
  out[1] = hv;
  out[2] = vh;
  out[3] = ibs0;
  out[4] = vv;
  return m > 0 && __int2float_rn(ss) <= bound;
}

__global__ void __launch_bounds__(THREADS)
count_kernel(Screen s, int *__restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (r >= s.nrows) return;
  const int cols = cols_of(s, r);
  const int famr = __ldg(s.fam_r + r);
  int n = 0, c[5];
  for (int j0 = 0; j0 < cols; j0 += 32) {
    const int j = j0 + lane;
    const bool hit = j < cols && test(s, r, j, famr, c);
    n += __popc(__ballot_sync(0xFFFFFFFFu, hit));
  }
  if (lane == 0) counts[r] = n;
}

__global__ void __launch_bounds__(THREADS)
write_kernel(Screen s, const long long *__restrict__ offsets,
             int *__restrict__ out, long long total) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (r >= s.nrows) return;
  const int cols = cols_of(s, r);
  const int famr = __ldg(s.fam_r + r);
  const unsigned lower = (1u << lane) - 1u;
  long long pos = offsets[r];
  int c[5];
  for (int j0 = 0; j0 < cols; j0 += 32) {
    const int j = j0 + lane;
    const bool hit = j < cols && test(s, r, j, famr, c);
    const unsigned bits = __ballot_sync(0xFFFFFFFFu, hit);
    if (hit) {
      const long long p = pos + __popc(bits & lower);
      out[p] = r;
      out[total + p] = j;
#pragma unroll
      for (int q = 0; q < 5; ++q) out[(2 + q) * total + p] = c[q];
    }
    pos += __popc(bits);
  }
}

// A strip: the rows [row0, row0 + nrows) against the columns before each.
Screen screen(const void *carry, int rows, int n_pad, const void *fam,
              int row0, int nrows, float thr_b, float slack_b, float thr_w,
              float slack_w) {
  const int *c = static_cast<const int *>(carry);
  const int *f = static_cast<const int *>(fam);
  const long long plane = (long long)rows * n_pad;
  return Screen{c,         c + plane, c + 2 * plane, c + 3 * plane,
                c + 4 * plane, f + row0, f,       n_pad,
                nrows,     n_pad,     1,         row0,
                thr_b,     slack_b,   thr_w,     slack_w};
}

// A (g, g) tile: every pair, or on a diagonal tile (diag) the pairs with
// row_off + r > j.
Screen tile_screen(const void *carry, int g, const void *fam_rows,
                   const void *fam_cols, int row_off, int diag, float thr_b,
                   float slack_b, float thr_w, float slack_w) {
  const int *c = static_cast<const int *>(carry);
  const long long plane = (long long)g * g;
  return Screen{c,         c + plane, c + 2 * plane, c + 3 * plane,
                c + 4 * plane, static_cast<const int *>(fam_rows),
                static_cast<const int *>(fam_cols), g,
                g,         g,         diag,      row_off,
                thr_b,     slack_b,   thr_w,     slack_w};
}

int count_pass(const Screen &s, void *counts, void *stream) {
  if (s.nrows > 0)
    count_kernel<<<(s.nrows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, THREADS,
                   0, static_cast<cudaStream_t>(stream)>>>(
        s, static_cast<int *>(counts));
  return static_cast<int>(cudaGetLastError());
}

int write_pass(const Screen &s, const void *offsets, void *out,
               long long total, void *stream) {
  if (s.nrows > 0 && total > 0)
    write_kernel<<<(s.nrows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, THREADS,
                   0, static_cast<cudaStream_t>(stream)>>>(
        s, static_cast<const long long *>(offsets), static_cast<int *>(out),
        total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Pass one. carry: (5, rows, n_pad) int32 strip grams of the sample rows
// [row0, row0 + rows); fam: (n_pad,) int32; screens the strip rows
// [0, nrows), nrows <= rows, and writes each row's hit count into counts
// (nrows,) int32. Launches on `stream`; returns cudaGetLastError().
extern "C" int king_screen_count_launch(const void *carry, int rows,
                                        int n_pad, const void *fam, int row0,
                                        int nrows, float thr_b, float slack_b,
                                        float thr_w, float slack_w,
                                        void *counts, void *stream) {
  return count_pass(screen(carry, rows, n_pad, fam, row0, nrows, thr_b,
                           slack_b, thr_w, slack_w),
                    counts, stream);
}

// Pass two, with the same screen arguments: offsets (nrows,) int64, the
// exclusive scan of pass one's counts; out (7, total) int32, total the sum
// of the counts. Launches on `stream`; returns cudaGetLastError().
extern "C" int king_screen_write_launch(const void *carry, int rows,
                                        int n_pad, const void *fam, int row0,
                                        int nrows, float thr_b, float slack_b,
                                        float thr_w, float slack_w,
                                        const void *offsets, void *out,
                                        long long total, void *stream) {
  return write_pass(screen(carry, rows, n_pad, fam, row0, nrows, thr_b,
                           slack_b, thr_w, slack_w),
                    offsets, out, total, stream);
}

// The tile mode, pass one. carry: (5, g, g) int32 tile grams; fam_rows,
// fam_cols: (g,) int32 family codes of the tile's rows and columns;
// row_off = r0 - c0 and diag (0 or 1) select the pairs (every pair, or on a
// diagonal tile those with row_off + r > j); counts: (g,) int32, each tile
// row's hit count. Launches on `stream`; returns cudaGetLastError().
extern "C" int king_screen_tile_count_launch(const void *carry, int g,
                                             const void *fam_rows,
                                             const void *fam_cols,
                                             int row_off, int diag,
                                             float thr_b, float slack_b,
                                             float thr_w, float slack_w,
                                             void *counts, void *stream) {
  return count_pass(tile_screen(carry, g, fam_rows, fam_cols, row_off, diag,
                                thr_b, slack_b, thr_w, slack_w),
                    counts, stream);
}

// The tile mode, pass two, with the same tile arguments: offsets (g,)
// int64, the exclusive scan of pass one's counts; out (7, total) int32.
extern "C" int king_screen_tile_write_launch(const void *carry, int g,
                                             const void *fam_rows,
                                             const void *fam_cols,
                                             int row_off, int diag,
                                             float thr_b, float slack_b,
                                             float thr_w, float slack_w,
                                             const void *offsets, void *out,
                                             long long total, void *stream) {
  return write_pass(tile_screen(carry, g, fam_rows, fam_cols, row_off, diag,
                                thr_b, slack_b, thr_w, slack_w),
                    offsets, out, total, stream);
}
