// K3a rand_h: fused 2-bit decode + randomized-PCA normalization + thin
// product H += Y G of one packed SNP chunk or sample-group slab, on the
// float64 tensor cores.
//
// Replaces snprelate_tpu/models/pca_randomized.py:_h_step and the H part of
// _power_pass (_rand_block -> matmul), and the slab route's h_accum
// (pca_randomized.py:307, randomized_pca_slabs and the rank-partitioned PCA
// of models/pca_rank.py). For packed rows (S, N/4), their per-SNP avg/scale
// and G (N, k) float64, it adds Y G into H (S, k) float64, where
//   y[s, i] = (g - avg[s]) * scale[s] for a valid call, 0 for a missing one,
// and, when y2 is given, the per-row sums of y^2 into y2 (S,) (the
// TraceXTX term: the slab route's avg is the cohort's, given, so a slab's
// trace cannot come from snp_stats, which derives avg from the columns it
// sees). H is added into because the slab route sums it over the sample
// groups; a caller that wants H = Y G passes a zeroed H.
//
// What bounds it on the card: float64 operations, 2*S*N*k, against S*N/4
// bytes of packed input and N*k*8 bytes of G. At S = 4096, N = 100,096,
// k = 64 that is 5.2e10 flop against 0.15 GB: 0.78 ms at the 67 TFLOP/s of
// the float64 tensor cores, the only float64 rate that reaches it.
//
// Design (the shared parts in rand_mma.cuh): every product is an
// mma.sync.m16n8k8 .f64, which the card issues at its full float64 tensor
// rate (m8n8k4, Ampere's shape, at half of it; `chip_smoke.py
// --mma-probe`). A block owns 128 SNP rows x BN columns of H (BN = 32 for
// k <= 32, so the loadings' K = 32 does no masked work; else 64) and one
// slice of the sample axis, which it walks in 64-sample stages, double
// buffered with cp.async: per stage its rows' packed bytes (128 x 16
// bytes) and the stage's rows of G (64 x BN float64, rows padded so a
// fragment load takes the least wavefronts). Y never exists in memory. A
// lane's A fragment holds rows g + 8h at samples t + 4j, so of every code
// byte of a row it takes the same 2-bit slot t: per 32 samples it reads
// each of its four rows' 8 bytes once (a 64-bit shared load) and turns a
// code into y with one shared load from the block's rows of the decode
// table (four float64 per SNP, (0, 1, 2 - avg) * scale and 0, formed once
// per call by decode_table: the plain version's doubles). Decoded in
// registers, not through a float64 shared tile: the decode costs no
// shared store and no barrier, and each y feeds four products. The y2
// sums come from the same decode (the first column warps of column tile 0,
// once per element). Blocks of one slice are adjacent in the grid (row
// tiles fastest), so they read that slice of G from L2 together, and the
// 128-row tiles make a chunk read G 32 times. At a chunk's 32 row tiles the sample axis is cut into slices
// (ops/kernels.py rand_plan: the fewest that keep the resident blocks 90 %
// busy), each block writes its partial tile to scratch, and a second
// kernel adds the slices in slice order into H; a slab's 131,072 rows fill
// the card with one slice, and the tile then goes straight into H. No
// atomics, so repeated runs are bitwise equal.
//
// What holds it at about 60 % of the tensor rate: 128 registers a thread
// (16 warps an SM, two blocks; ptxas spills a few bytes, more with y2),
// so fragments are not loaded ahead of the products, and each 8-deep step
// waits on its shared loads (eight table lookups and eight G fragments a
// warp for eight products).

#include "rand_mma.cuh"

namespace {

using namespace rand_mma;

template <int BN>
constexpr int smem_bytes() {
  return BM * 4 * 8 + STAGES * (Tile<BN>::B_BYTES + BM * BK / 4);
}

// add == 0: part[z] = the slice's partial tile (and y2out[z] = the
// slice's per-row sums of y^2); add == 1 (one slice): h += the tile
// (y2out += the per-row sums). Y2: y2out is written.
template <int BN, bool Y2>
__global__ void __launch_bounds__(Tile<BN>::THREADS, Tile<BN>::MIN_BLOCKS)
rand_h_part(const uint8_t *__restrict__ packed, int S, int B,
            const double *__restrict__ table, const double *__restrict__ g,
            int k, bool vec, int slice_len, double *__restrict__ hout,
            double *__restrict__ y2out, int add) {
  using T = Tile<BN>;
  extern __shared__ __align__(16) uint8_t sm[];
  double *tab = reinterpret_cast<double *>(sm);  // [BM][4]
  double *bs = tab + BM * 4;                     // [STAGES][BK][LDB]
  uint8_t *cs = reinterpret_cast<uint8_t *>(bs + STAGES * BK * T::LDB);
                                                 // [STAGES][BM][BK / 4]
  const int N = 4 * B;
  const int s0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
  const int i_begin = blockIdx.z * slice_len;
  const int nst = (min(N, i_begin + slice_len) - i_begin) / BK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2, gq = lane >> 2, t = lane & 3;
  const int rbase = 32 * wm + gq;  // the lane's rows: rbase + 16 mt + 8 h

  // the block's rows of the decode table (rows past S: zeros), with stage 0
  for (int e = tid; e < BM * 2; e += T::THREADS) {
    const int s = s0 + (e >> 1);
    cp16(tab + 2 * e, s < S ? table + 4 * (size_t)s + 2 * (e & 1) : table,
         s < S ? 16 : 0);
  }
  auto load_stage = [&](int it) {
    const int st = it % STAGES, i0 = i_begin + it * BK;
    load_operand<BN>(bs + st * BK * T::LDB, g, i0, N, k, c0, vec);
    for (int r = tid; r < BM; r += T::THREADS) {
      const int s = s0 + r;
      cp16(cs + (st * BM + r) * (BK / 4),
           s < S ? packed + (size_t)s * B + i0 / 4 : packed, s < S ? 16 : 0);
    }
  };
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) {
    if (it < nst) load_stage(it);
    commit();
  }

  double acc[MT][NT][4] = {};
  double yy[MT][2] = {};
  const bool y2_warp = Y2 && wn == 0 && blockIdx.y == 0;
  for (int it = 0; it < nst; ++it) {
    wait<STAGES - 2>();
    __syncthreads();  // stage it has landed; stage it - 1 is consumed
    if (it + STAGES - 1 < nst) load_stage(it + STAGES - 1);
    commit();
    const int st = it % STAGES;
    const double *b_st = bs + st * BK * T::LDB;
    const uint8_t *c_st = cs + st * BM * (BK / 4);
#pragma unroll
    for (int q = 0; q < BK / 32; ++q) {  // 32 samples: 8 bytes of a row
      uint64_t w[MT][2];  // the lane's four rows' bytes, shifted to slot t
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          w[mt][h] = *reinterpret_cast<const uint64_t *>(
                         c_st + (rbase + 16 * mt + 8 * h) * (BK / 4) +
                         8 * q) >> (2 * t);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // samples 8 kk + t + 4 j
        double a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t code =
                  static_cast<uint32_t>(w[mt][h] >> (8 * (2 * kk + j))) & 3u;
              const double y = tab[(rbase + 16 * mt + 8 * h) * 4 + code];
              a[mt][2 * j + h] = y;
              if (Y2 && y2_warp) yy[mt][h] = fma(y, y, yy[mt][h]);
            }
        double b[NT][2];
        load_b<BN>(b, b_st, 4 * q + kk, 32 * wn, gq, t);
        product(acc, a, b);
      }
    }
  }

  if (Y2 && y2_warp) {  // the row sums: a row's four slots are lanes t
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        double v = yy[mt][h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        const int s = s0 + rbase + 16 * mt + 8 * h;
        if (t == 0 && s < S) {
          if (add)
            y2out[s] += v;
          else
            y2out[(size_t)blockIdx.z * S + s] = v;
        }
      }
  }

  double *out = add ? hout : hout + (size_t)blockIdx.z * S * k;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = s0 + rbase + 16 * mt + 8 * h;
      if (r >= S) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 32 * wn + 8 * nt + 2 * t + e;
          if (col >= k) continue;
          const double v = acc[mt][nt][2 * h + e];
          if (add)
            out[(size_t)r * k + col] += v;
          else
            out[(size_t)r * k + col] = v;
        }
    }
}

template <int BN, bool Y2>
void launch(dim3 grid, cudaStream_t st, const uint8_t *packed, int S, int B,
            const double *table, const double *g, int k, bool vec,
            int slice_len, double *hout, double *y2out, int add) {
  constexpr int bytes = smem_bytes<BN>();
  cudaFuncSetAttribute(rand_h_part<BN, Y2>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  rand_h_part<BN, Y2><<<grid, Tile<BN>::THREADS, bytes, st>>>(
      packed, S, B, table, g, k, vec, slice_len, hout, y2out, add);
}

template <int BN>
void dispatch(bool y2, dim3 grid, cudaStream_t st, const uint8_t *packed,
              int S, int B, const double *table, const double *g, int k,
              bool vec, int slice_len, double *hout, double *y2out,
              int add) {
  if (y2)
    launch<BN, true>(grid, st, packed, S, B, table, g, k, vec, slice_len,
                     hout, y2out, add);
  else
    launch<BN, false>(grid, st, packed, S, B, table, g, k, vec, slice_len,
                      hout, y2out, add);
}

}  // namespace

// packed: (S, B) uint8, B % 16 == 0; avg, scale: (S,) float64; g: (4B, k)
// float64; width: columns per block tile (32 or 64); slice_len:
// samples per slice, a multiple of 64; table: scratch of 4S float64 (the
// decode table); h (S, k) float64 += Y G and, when y2 is not null, y2 (S,)
// += the per-row sums of y^2. With one slice (slice_len >= 4B) part and
// y2part are unused (may be null), else part holds nslice * S * k and
// y2part nslice * S float64. Launches on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for another width).
extern "C" int rand_h_launch(const void *packed, int S, int B,
                             const void *avg, const void *scale,
                             const void *g, int k, int width, int slice_len,
                             void *table, void *part, void *y2part, void *h,
                             void *y2, void *stream) {
  if (S > 0 && k > 0 && B > 0) {
    if (width != 32 && width != 64)
      return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    rand_mma::table(avg, scale, S, table, st);
    const int nslice = (4 * B + slice_len - 1) / slice_len;
    const dim3 grid((S + rand_mma::BM - 1) / rand_mma::BM,
                    (k + width - 1) / width, nslice);
    const bool direct = nslice == 1;
    const bool vec = k % 2 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
    double *y2d = static_cast<double *>(y2);
    double *hout = static_cast<double *>(direct ? h : part);
    double *y2out = y2d == nullptr ? nullptr
                    : direct       ? y2d
                                   : static_cast<double *>(y2part);
    const auto *pk = static_cast<const uint8_t *>(packed);
    const auto *tb = static_cast<const double *>(table);
    const auto *gd = static_cast<const double *>(g);
    const int add = direct ? 1 : 0;
    if (width == 32)
      dispatch<32>(y2d != nullptr, grid, st, pk, S, B, tb, gd, k, vec,
                   slice_len, hout, y2out, add);
    else
      dispatch<64>(y2d != nullptr, grid, st, pk, S, B, tb, gd, k, vec,
                   slice_len, hout, y2out, add);
    if (!direct) {
      rand_mma::reduce(static_cast<const double *>(part), nslice,
                       (long long)S * k, static_cast<double *>(h), st);
      if (y2d != nullptr)
        rand_mma::reduce(static_cast<const double *>(y2part), nslice, S, y2d,
                         st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
