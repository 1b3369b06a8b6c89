// K6 king_screen: the KING-robust relatedness screen of one row strip, with
// its hits compacted in row-major order; and its tile mode K6t
// king_screen_tile.
//
// Replaces _strip_counters, strip_hits, strip_mask and gather_hits of
// snprelate_tpu/models/king.py:king_ibd_selection (:411, :457, :481, :487)
// and, in tile mode, tile_hits (:147) of the super-tile screen.
// Input: five int32 count grams (vv, hh, dd, hv, vh) with a row stride ld:
// K1r's (R, N) strip of the sample rows [row0, row0 + R), or K1t's (g, g)
// tile; the family codes of the rows and of the columns (-1: no family).
// A strip tests the pairs (row0 + r, j) with j < row0 + r (the strict lower
// triangle) and r < nrows; a tile every pair, or on a diagonal tile those
// with row_off + r > j. For each pair it forms, in integers,
//   homo = vv + hh - hv - vh, IBS0 = (homo - dd) / 2,
//   IBS2 = (homo + dd) / 2 + hh, IBS1 = vv - IBS0 - IBS2,
//   ss = IBS1 + 4 IBS0, and min(hv, vh) or hv + vh,
// and applies the JAX package's admit-only float32 pre-test:
//   ss <= thr * m + slack * m + 1 with m = min(hv, vh) > 0 between
//   families (thr = 2 - 4c) and m = hv + vh > 0 within one (thr = 1 - 2c),
//   slack = 4e-6 |thr|,
// each product and sum rounded to float32 on its own, so the plain version's
// float32 tensor operations give the same bits. The hits are written as
// (7, hits) int32 in row-major order (the order of nonzero): strip or tile
// row, column, ss, hv, vh, IBS0, vv.
//
// What bounds it on the card: bytes. It reads the five grams of every
// tested pair once (20 bytes a pair) and does some twenty integer and float
// operations a pair; the hit list is small.
//
// Design: one launch, one pass over the grams. The row-major sequence of
// tested pairs is cut into `units` contiguous ranges of equal size (each
// starting at a column that is a multiple of 4), one block each
// (ops/kernels.py:screen_plan); a block takes its unit from an atomic
// ticket, so every unit it waits on below has started. A block sweeps its
// unit row by row, 2,048 columns a step: each thread loads 4 neighbouring
// columns of each plane with one 16-byte load (scalar loads where the rows
// are not 16-byte aligned), two such chunks a step. A barrier that ors the
// threads' hit flags skips the rest of a step without hits; otherwise a
// warp scan of the threads' counts and the warps' totals place each hit,
// in row-major order, in a shared-memory buffer of BUF hits. The unit then
// learns its output offset by a single-pass decoupled look-back over
// per-unit status words (flag and count in one 64-bit word: 0 not ready, A
// the unit's count, P the inclusive prefix), one warp reading 32
// predecessors at a time, and copies its buffer there. A unit with more
// hits than BUF re-reads its own pairs once its offset is known and writes
// them directly. The output holds `cap` hits: nothing is written past it,
// and the last unit stores the true total. The C entry copies it to the
// host and waits for the stream, the call's one sync; a total over cap
// makes the wrapper launch again at the exact size. The last block to
// finish clears the ticket and the words, so a stream's status array is
// zeroed once and kept: no memset a call. Offsets, positions and pair
// counts are 64-bit.
//
// Before: two passes (count each row's hits, then the host's scan, then
// write), so the grams were read twice whenever a strip or tile had a hit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int PER_SM = 3;            // resident blocks an SM
constexpr int VEC = 4;               // columns a thread loads a chunk
constexpr int CHUNKS = 2;            // chunks a step
constexpr int CHUNK_COLS = THREADS * VEC;
constexpr int STEP_COLS = CHUNKS * CHUNK_COLS;
constexpr int BUF = 1024;            // hits a unit keeps in shared memory
constexpr unsigned long long FLAG_A = 1ull << 62, FLAG_P = 2ull << 62;
constexpr unsigned long long VALUE = FLAG_A - 1;
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Screen {
  const int *vv, *hh, *dd, *hv, *vh;  // (R, ld) strip or (g, g) tile grams
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

// The tested pairs of the rows before r (ops/kernels.py:screen_cols).
__device__ long long cols_before(const Screen &s, int r) {
  if (!s.tri) return (long long)r * s.ncols;
  const long long a = s.row_off, n = s.nrows;
  const long long i0 = min(n, max(0LL, -a));           // cols(i) >= 0 from
  const long long i1 = min(n, max(i0, s.ncols - a));   // cols(i) = ncols from
  const long long m = min(max((long long)r, i0), i1);
  return (m - i0) * (2 * a + i0 + m - 1) / 2 + max(0LL, r - i1) * s.ncols;
}

struct Pos {
  int r, c;
};

// Where unit u starts in the row-major pair order: pair floor(u pairs /
// units), its column rounded down to a multiple of 4; (nrows, 0) for u =
// units (ops/kernels.py:screen_start).
__device__ Pos unit_start(const Screen &s, int u, int units,
                          long long pairs) {
  if (u >= units) return Pos{s.nrows, 0};
  const long long e = (long long)((unsigned long long)u * pairs / units);
  int lo = 0, hi = s.nrows;  // cols_before(lo) <= e < cols_before(hi)
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (cols_before(s, mid) <= e) lo = mid; else hi = mid;
  }
  return Pos{lo, (int)((e - cols_before(s, lo)) & ~3LL)};
}

// The counters and the pre-test of one pair; returns the hit flag and the
// five counters the list keeps.
__device__ __forceinline__ bool test(const Screen &s, int vv, int hh, int dd,
                                     int hv, int vh, int famr, int famj,
                                     int (&out)[5]) {
  const int homo = vv + hh - hv - vh;
  const int ibs0 = (homo - dd) / 2;  // homo - dd = 2 IBS0 >= 0: exact
  const int ibs2 = (homo + dd) / 2 + hh;
  const int ibs1 = vv - ibs0 - ibs2;
  const int ss = ibs1 + 4 * ibs0;
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

// Four neighbouring columns [j, j + 4) of one row of p, zero past ce: one
// 16-byte load (VL, where j + 4 <= ld: rows and ld 16-byte aligned) or
// four scalar ones.
template <bool VL>
__device__ __forceinline__ int4 load4(const int *p, int j, int ce) {
  if (VL) return __ldg(reinterpret_cast<const int4 *>(p + j));
  int4 x;
  x.x = j < ce ? __ldg(p + j) : 0;
  x.y = j + 1 < ce ? __ldg(p + j + 1) : 0;
  x.z = j + 2 < ce ? __ldg(p + j + 2) : 0;
  x.w = j + 3 < ce ? __ldg(p + j + 3) : 0;
  return x;
}

__device__ __forceinline__ int lane_of(const int4 &x, int q) {
  return q == 0 ? x.x : q == 1 ? x.y : q == 2 ? x.z : x.w;
}

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long *p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_word(unsigned long long *p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// One sweep of the pairs [a, b) of the row-major order. Hit number k of the
// unit goes to the shared buffer (k < BUF) or, DIRECT, to out at
// off + k (< cap). Returns the unit's hit count, the same in every thread.
template <bool VL, bool DIRECT>
__device__ long long sweep(const Screen &s, Pos a, Pos b, int *sbuf,
                          unsigned *wt, int *__restrict__ out, long long cap,
                          long long off) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  long long n = 0;
  // b.r <= nrows, and b.c = 0 where b.r = nrows
  for (int r = a.r; r < b.r || (r == b.r && b.c > 0); ++r) {
    const int cb = r == a.r ? a.c : 0;
    const int ce = r == b.r ? b.c : cols_of(s, r);
    const int famr = __ldg(s.fam_r + r);
    const long long row = (long long)r * s.ld;
    for (int c0 = cb; c0 < ce; c0 += STEP_COLS) {
      int4 v[CHUNKS][5], f[CHUNKS];
#pragma unroll
      for (int k = 0; k < CHUNKS; ++k) {
        const int j = c0 + k * CHUNK_COLS + VEC * t;
        if (j < ce) {
          v[k][0] = load4<VL>(s.vv + row, j, ce);
          v[k][1] = load4<VL>(s.hh + row, j, ce);
          v[k][2] = load4<VL>(s.dd + row, j, ce);
          v[k][3] = load4<VL>(s.hv + row, j, ce);
          v[k][4] = load4<VL>(s.vh + row, j, ce);
          f[k] = load4<VL>(s.fam_c, j, ce);
        }
      }
      unsigned bits[CHUNKS], mine = 0;
#pragma unroll
      for (int k = 0; k < CHUNKS; ++k) {
        const int j = c0 + k * CHUNK_COLS + VEC * t;
        bits[k] = 0;
        if (j < ce) {
#pragma unroll
          for (int q = 0; q < VEC; ++q) {
            int c[5];
            const bool hit =
                j + q < ce &&
                test(s, lane_of(v[k][0], q), lane_of(v[k][1], q),
                     lane_of(v[k][2], q), lane_of(v[k][3], q),
                     lane_of(v[k][4], q), famr, lane_of(f[k], q), c);
            bits[k] |= (unsigned)hit << q;
          }
        }
        mine |= (unsigned)__popc(bits[k]) << (16 * k);  // CHUNKS <= 2
      }
      if (!__syncthreads_or(mine)) continue;  // no hit in the step
      // place the hits: chunk, then thread, then column order
      unsigned x = mine;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
      }
      if (lane == 31) wt[w] = x;
      __syncthreads();
      unsigned before = 0, tot = 0;
#pragma unroll
      for (int q = 0; q < WARPS; ++q) {
        const unsigned y = wt[q];
        before += q < w ? y : 0;
        tot += y;
      }
      const unsigned excl = before + x - mine;
      long long k0 = n;  // the unit's hit number of the chunk's first hit
#pragma unroll
      for (int k = 0; k < CHUNKS; ++k) {
        const int j = c0 + k * CHUNK_COLS + VEC * t;
        long long h = k0 + ((excl >> (16 * k)) & 0xFFFFu);
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          if (!((bits[k] >> q) & 1u)) continue;
          int c[5];
          test(s, lane_of(v[k][0], q), lane_of(v[k][1], q),
               lane_of(v[k][2], q), lane_of(v[k][3], q), lane_of(v[k][4], q),
               famr, lane_of(f[k], q), c);
          const int val[7] = {r, j + q, c[0], c[1], c[2], c[3], c[4]};
          if (DIRECT) {
            const long long p = off + h;
            if (p < cap) {
#pragma unroll
              for (int e = 0; e < 7; ++e) out[e * cap + p] = val[e];
            }
          } else if (h < BUF) {
#pragma unroll
            for (int e = 0; e < 7; ++e) sbuf[e * BUF + h] = val[e];
          }
          ++h;
        }
        k0 += (tot >> (16 * k)) & 0xFFFFu;
      }
      n = k0;
    }
  }
  return n;
}

// Warp 0: publish the unit's count, find its exclusive prefix by looking
// back over the predecessors' words, publish the inclusive prefix. Every
// predecessor holds a ticket below u, so it runs and publishes its count
// without waiting on anything.
__device__ long long look_back(unsigned long long *word, int u,
                               long long agg) {
  const int lane = threadIdx.x & 31;
  if (u == 0) {
    if (lane == 0) store_word(word, FLAG_P | (unsigned long long)agg);
    return 0;
  }
  if (lane == 0) store_word(word + u, FLAG_A | (unsigned long long)agg);
  long long excl = 0;
  int v = u - 1;  // the nearest predecessor not yet summed
  while (true) {
    const int i = v - lane;  // lane 0 the nearest
    const unsigned long long x = i >= 0 ? load_word(word + i) : FLAG_P;
    const unsigned pre = __ballot_sync(FULL, (x & ~VALUE) == FLAG_P);
    const unsigned wait = __ballot_sync(FULL, (x & ~VALUE) == 0);
    // the lanes up to the nearest inclusive prefix, or all 32
    const unsigned upto = pre ? ((pre & (0u - pre)) << 1) - 1u : FULL;
    if (wait & upto) {
      __nanosleep(64);
      continue;
    }
    long long val = ((upto >> lane) & 1u) ? (long long)(x & VALUE) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) val += __shfl_xor_sync(FULL, val, o);
    excl += val;
    if (pre) break;
    v -= 32;
  }
  if (lane == 0)
    store_word(word + u, FLAG_P | (unsigned long long)(excl + agg));
  return excl;
}

// status: [0] the ticket, [1] the blocks done, [2] the total, [3 + u] unit
// u's word. The ticket, the count of blocks done and the words are zero at
// the launch, and the last block to finish clears them again, so one
// status array serves every launch on its stream.
template <bool VL>
__global__ void __launch_bounds__(THREADS, PER_SM)
screen_kernel(Screen s, int units, long long pairs,
              unsigned long long *__restrict__ status, int *__restrict__ out,
              long long cap) {
  __shared__ int sbuf[7 * BUF];
  __shared__ unsigned wt[WARPS];
  __shared__ int s_unit, s_last;
  __shared__ long long s_off;
  unsigned long long *word = status + 3;
  if (threadIdx.x == 0) s_unit = (int)atomicAdd(status, 1ull);
  __syncthreads();
  const int u = s_unit;
  const Pos a = unit_start(s, u, units, pairs);
  const Pos b = unit_start(s, u + 1, units, pairs);
  const long long agg = sweep<VL, false>(s, a, b, sbuf, wt, out, cap, 0);
  if (threadIdx.x < 32) {
    const long long off = look_back(word, u, agg);
    if (threadIdx.x == 0) {
      s_off = off;
      if (u == units - 1) status[2] = (unsigned long long)(off + agg);
    }
  }
  __syncthreads();
  const long long off = s_off;
  if (agg <= BUF) {
    for (int i = threadIdx.x; i < agg; i += THREADS) {
      const long long p = off + i;
      if (p < cap) {
#pragma unroll
        for (int e = 0; e < 7; ++e) out[e * cap + p] = sbuf[e * BUF + i];
      }
    }
  } else {  // the buffer overflowed: the unit's pairs again, written directly
    sweep<VL, true>(s, a, b, sbuf, wt, out, cap, off);
  }
  // every block's look-back is over once all have counted themselves done
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(status + 1, 1ull) == (unsigned long long)(units - 1);
  }
  __syncthreads();
  if (s_last) {
    for (int i = threadIdx.x; i < units; i += THREADS) word[i] = 0;
    if (threadIdx.x == 0) status[0] = status[1] = 0;
  }
}

// One launch, then the total copied to the host and the stream waited for:
// the wrapper's one sync, which it needs for the hit count.
int run(const Screen &s, int units, long long pairs, int vec, void *status,
        void *out, long long cap, void *total, void *stream) {
  if (units <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto *w = static_cast<unsigned long long *>(status);
  auto *o = static_cast<int *>(out);
  if (vec)
    screen_kernel<true><<<units, THREADS, 0, st>>>(s, units, pairs, w, o,
                                                    cap);
  else
    screen_kernel<false><<<units, THREADS, 0, st>>>(s, units, pairs, w, o,
                                                     cap);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(total, w + 2, sizeof(long long),
                          cudaMemcpyDeviceToHost, st);
  if (err == cudaSuccess) err = cudaStreamSynchronize(st);
  return static_cast<int>(err);
}

}  // namespace

// The strip mode. carry: (5, rows, n_pad) int32 strip grams of the sample
// rows [row0, row0 + rows); fam: (n_pad,) int32; screens the strip rows
// [0, nrows), nrows <= rows, over `units` blocks of the `pairs` tested
// pairs (ops/kernels.py:screen_plan); vec: n_pad % 4 == 0 and carry and
// fam 16-byte aligned. status: (units + 3,) int64 at least, zero but for
// [2] (see screen_kernel) and left so; out: (7, cap) int32, the hits in
// row-major order, none past cap; total: an int64 on the host (pinned),
// the true hit count. Launches on `stream` and waits for it; returns the
// CUDA error.
extern "C" int king_screen_launch(const void *carry, int rows, int n_pad,
                                  const void *fam, int row0, int nrows,
                                  float thr_b, float slack_b, float thr_w,
                                  float slack_w, int units, long long pairs,
                                  int vec, void *status, void *out,
                                  long long cap, void *total, void *stream) {
  const int *c = static_cast<const int *>(carry);
  const int *f = static_cast<const int *>(fam);
  const long long plane = (long long)rows * n_pad;
  const Screen s{c,         c + plane, c + 2 * plane, c + 3 * plane,
                 c + 4 * plane, f + row0, f,       n_pad,
                 nrows,     n_pad,     1,         row0,
                 thr_b,     slack_b,   thr_w,     slack_w};
  return run(s, units, pairs, vec, status, out, cap, total, stream);
}

// The tile mode. carry: (5, g, g) int32 tile grams; fam_rows, fam_cols:
// (g,) int32 family codes of the tile's rows and columns; row_off = r0 - c0
// and diag (0 or 1) select the pairs (every pair, or on a diagonal tile
// those with row_off + r > j); vec: g % 4 == 0 and carry and fam_cols
// 16-byte aligned; units, pairs, status, out, cap and total as in the
// strip mode.
extern "C" int king_screen_tile_launch(const void *carry, int g,
                                       const void *fam_rows,
                                       const void *fam_cols, int row_off,
                                       int diag, float thr_b, float slack_b,
                                       float thr_w, float slack_w, int units,
                                       long long pairs, int vec, void *status,
                                       void *out, long long cap, void *total,
                                       void *stream) {
  const int *c = static_cast<const int *>(carry);
  const long long plane = (long long)g * g;
  const Screen s{c,         c + plane, c + 2 * plane, c + 3 * plane,
                 c + 4 * plane, static_cast<const int *>(fam_rows),
                 static_cast<const int *>(fam_cols), g,
                 g,         g,         diag,      row_off,
                 thr_b,     slack_b,   thr_w,     slack_w};
  return run(s, units, pairs, vec, status, out, cap, total, stream);
}
