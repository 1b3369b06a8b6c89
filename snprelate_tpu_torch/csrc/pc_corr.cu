// K7 pc_corr: fused 2-bit decode + the pairwise-complete Pearson
// correlation of every SNP of one packed chunk with every eigenvector.
//
// Replaces snprelate_tpu/ops/loadings.py:_corr_step (SNP_PC_Corr,
// genPCA.cpp:820-842). For one packed chunk (S, N/4) and the eigenvectors
// E (N, K) float64 (zero rows past the samples), it writes corr (S, K)
// float64: over the valid calls of SNP s, with g the genotype and v = 1,
//   xy = sum g e_k, x = sum v e_k, xx = sum v e_k^2,
//   y = sum g, yy = sum g^2, m = the number of valid calls,
//   corr = (xy - x y / m) / sqrt((xx - x^2 / m) (yy - y^2 / m)),
// NaN where m <= 1 or the product under the root is not positive (the JAX
// step's rule, loadings.py:92-97).
//
// What bounds it on the card: float64 operations, 3 * 2 * S * N * K (three
// products against E), against S * N / 4 bytes of packed input and N * K *
// 8 bytes of E. At S = 8192, N = 100,096, K = 32 that is 1.6e11 flop
// against 0.23 GB.
//
// Design: the chunk is decoded once per block into g and v tiles in shared
// memory (32-sample stages), beside the stage's rows of E; each thread
// keeps the three sums of a 4-SNP x 2-column block in float64 registers
// (FMA). K is the PC count, small, so a block owns a 64-SNP x 32-column
// tile and the sample axis is cut into slices (the z axis of the grid), as
// rand_h cuts it; the blocks of the first column tile also sum y, yy and m
// per SNP. A second kernel adds the slices' partials in slice order and
// forms the correlation, so repeated runs are bitwise equal. The per-SNP
// sums are integers, exact in float64, so c2 = yy - y^2 / m is formed with
// the JAX step's operations on the same exact values (a monomorphic SNP
// gives exactly 0, hence NaN, on both).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TS = 64;        // SNP rows per output tile
constexpr int TK = 32;        // eigenvector columns per output tile
constexpr int BI = 32;        // samples per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 2 outputs each

// part: (nslice, 3, S, K) sums xy, x, xx per slice; spart: (nslice, 3, S)
// sums y, yy, m per slice.
__global__ void __launch_bounds__(THREADS)
pc_corr_part(const uint8_t *__restrict__ packed, int S, int B,
             const double *__restrict__ e, int K, int slice_len,
             double *__restrict__ part, double *__restrict__ spart) {
  __shared__ __align__(16) double gs[BI][TS];  // [sample][snp] g, 0 missing
  __shared__ __align__(16) double vs[BI][TS];  // [sample][snp] 1 valid
  __shared__ __align__(16) double es[BI][TK];  // [sample][column]

  const int N = 4 * B;
  const int s0 = blockIdx.x * TS, c0 = blockIdx.y * TK;
  const int i_begin = blockIdx.z * slice_len;
  const int i_end = min(N, i_begin + slice_len);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  // Stage fill: thread -> (SNP row fr, 8-sample group fq) of the tiles.
  const int fr = tid >> 2, fq = tid & 3;
  const int s = s0 + fr;
  const bool row_ok = s < S;
  const uint8_t *src = packed + (size_t)(row_ok ? s : 0) * B + 2 * fq;

  double xy[4][2], x[4][2], xx[4][2];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) xy[a][b] = x[a][b] = xx[a][b] = 0.0;
  int sy = 0, syy = 0, sm = 0;  // this thread's share of y, yy, m

  for (int i0 = i_begin; i0 < i_end; i0 += BI) {
    uint32_t w = 0xFFFFu;  // past the chunk: missing
    if (row_ok) w = __ldg(reinterpret_cast<const uint16_t *>(src + i0 / 4));
    double gv[8], vv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t c = (w >> (2 * j)) & 3u;
      const int ok = c != 3u;
      const int gi = ok ? (int)c : 0;
      sy += gi;
      syy += gi * gi;
      sm += ok;
      gv[j] = (double)gi;
      vv[j] = (double)ok;
    }
    __syncthreads();  // the previous stage is consumed
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      gs[8 * fq + j][fr] = gv[j];
      vs[8 * fq + j][fr] = vv[j];
    }
    for (int q = tid; q < BI * TK; q += THREADS) {
      const int i = q / TK, c = q % TK;
      es[i][c] = c0 + c < K ? __ldg(e + (size_t)(i0 + i) * K + c0 + c) : 0.0;
    }
    __syncthreads();

#pragma unroll 8
    for (int i = 0; i < BI; ++i) {
      const double2 g0 = *reinterpret_cast<const double2 *>(&gs[i][4 * ty]);
      const double2 g1 =
          *reinterpret_cast<const double2 *>(&gs[i][4 * ty + 2]);
      const double2 v0 = *reinterpret_cast<const double2 *>(&vs[i][4 * ty]);
      const double2 v1 =
          *reinterpret_cast<const double2 *>(&vs[i][4 * ty + 2]);
      const double2 q = *reinterpret_cast<const double2 *>(&es[i][2 * tx]);
      const double r[4] = {g0.x, g0.y, g1.x, g1.y};
      const double u[4] = {v0.x, v0.y, v1.x, v1.y};
      const double qq[2] = {q.x, q.y};
      const double q2[2] = {q.x * q.x, q.y * q.y};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          xy[a][b] = fma(r[a], qq[b], xy[a][b]);
          x[a][b] = fma(u[a], qq[b], x[a][b]);
          xx[a][b] = fma(u[a], q2[b], xx[a][b]);
        }
    }
  }

  // the row's y, yy, m: its four fill threads are adjacent lanes
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    sy += __shfl_xor_sync(0xffffffffu, sy, o);
    syy += __shfl_xor_sync(0xffffffffu, syy, o);
    sm += __shfl_xor_sync(0xffffffffu, sm, o);
  }
  const size_t z = blockIdx.z;
  if (blockIdx.y == 0 && fq == 0 && row_ok) {
    double *sp = spart + z * 3 * S;
    sp[s] = (double)sy;
    sp[(size_t)S + s] = (double)syy;
    sp[2 * (size_t)S + s] = (double)sm;
  }

  const size_t plane = (size_t)S * K;
  double *out = part + z * 3 * plane;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = s0 + 4 * ty + a;
    if (r >= S) continue;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int c = c0 + 2 * tx + b;
      if (c >= K) continue;
      const size_t o = (size_t)r * K + c;
      out[o] = xy[a][b];
      out[plane + o] = x[a][b];
      out[2 * plane + o] = xx[a][b];
    }
  }
}

// corr[s, k] from the slices' partials, added in slice order.
__global__ void pc_corr_finish(const double *__restrict__ part,
                               const double *__restrict__ spart, int nslice,
                               int S, int K, double *__restrict__ corr) {
  const long long len = (long long)S * K;
  for (long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       q < len; q += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(q / K);
    double sxy = 0.0, sx = 0.0, sxx = 0.0, y = 0.0, yy = 0.0, m = 0.0;
    for (int z = 0; z < nslice; ++z) {
      const double *p = part + (size_t)z * 3 * len;
      sxy += p[q];
      sx += p[len + q];
      sxx += p[2 * len + q];
      const double *sp = spart + (size_t)z * 3 * S;
      y += sp[r];
      yy += sp[S + r];
      m += sp[2 * S + r];
    }
    double out = __longlong_as_double(0x7ff8000000000000LL);  // NaN
    if (m > 1.0) {
      const double c1 = sxx - sx * sx / m;
      const double c2 = yy - y * y / m;
      const double val = c1 * c2;
      if (val > 0.0) out = (sxy - sx * y / m) / sqrt(val);
    }
    corr[q] = out;
  }
}

}  // namespace

// packed: (S, B) uint8, B % 16 == 0; e: (4B, K) float64; slice_len:
// samples per slice, a multiple of 32; part: scratch of nslice * 3 * S * K
// float64 and spart of nslice * 3 * S float64 (nslice = ceil(4B /
// slice_len)); corr: (S, K) float64, written. Launches on `stream`;
// returns cudaGetLastError().
extern "C" int pc_corr_launch(const void *packed, int S, int B,
                              const void *e, int K, int slice_len,
                              void *part, void *spart, void *corr,
                              void *stream) {
  if (S > 0 && K > 0 && B > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int nslice = (4 * B + slice_len - 1) / slice_len;
    const dim3 grid((S + TS - 1) / TS, (K + TK - 1) / TK, nslice);
    pc_corr_part<<<grid, THREADS, 0, st>>>(
        static_cast<const uint8_t *>(packed), S, B,
        static_cast<const double *>(e), K, slice_len,
        static_cast<double *>(part), static_cast<double *>(spart));
    const long long len = (long long)S * K;
    const long long blocks = (len + 255) / 256;
    pc_corr_finish<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(
        static_cast<const double *>(part),
        static_cast<const double *>(spart), nslice, S, K,
        static_cast<double *>(corr));
  }
  return static_cast<int>(cudaGetLastError());
}
