// K3a rand_h: fused 2-bit decode + randomized-PCA normalization + thin
// product H += Y G of one packed SNP chunk or sample-group slab.
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
// k = 64 that is 5.2e10 flop against 0.15 GB.
//
// Design: every entry of H sums over all N samples, and at the default chunk
// a 64-row tile per block would give 64 blocks for 132 SMs, each walking
// every sample. So the sample axis is cut into slices (the z axis of the
// grid): a block owns a 64 x 64 tile of H and one slice, streams its slice
// through shared memory in 32-sample stages (Y decoded and normalized in
// registers from the packed bytes, G copied in), and writes its partial tile
// to a scratch buffer. A second kernel adds the slices' partials in slice
// order into H. A slab has up to 131,072 rows, so its grid is full with one
// slice, and the tile then goes straight into H without the scratch buffer
// (nslice * S * k float64, which exists only when the rows are few). There
// are no atomics, so every run sums in the same order and repeated runs are
// bitwise equal. Everything is float64 (FMA): an entry sums ~1e5 terms, past
// what a float32 accumulator keeps within the 2e-5 budget. FP64 tensor-core
// MMA (mma.sync m8n8k4) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TS = 64;        // SNP rows per output tile
constexpr int TK = 64;        // columns of G per output tile
constexpr int BI = 32;        // samples per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

// add == 0: part[z] = the slice's partial tile (and y2out[z] = the
// slice's per-row sums of y^2); add == 1 (one slice): h += the tile
// (y2out += the per-row sums). y2out may be null.
__global__ void __launch_bounds__(THREADS)
rand_h_part(const uint8_t *__restrict__ packed, int S, int B,
            const double *__restrict__ avg, const double *__restrict__ scale,
            const double *__restrict__ g, int k, int slice_len,
            double *__restrict__ hout, double *__restrict__ y2out, int add) {
  __shared__ __align__(16) double ys[BI][TS];  // [sample][snp]
  __shared__ __align__(16) double gs[BI][TK];  // [sample][column]

  const int N = 4 * B;
  const int s0 = blockIdx.x * TS, c0 = blockIdx.y * TK;
  const int i_begin = blockIdx.z * slice_len;
  const int i_end = min(N, i_begin + slice_len);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  // Stage fill: thread -> (SNP row fr, 8-sample group fq) of the Y tile.
  const int fr = tid >> 2, fq = tid & 3;
  const int s = s0 + fr;
  const bool row_ok = s < S;
  const uint8_t *src = packed + (size_t)(row_ok ? s : 0) * B + 2 * fq;
  const double m = row_ok ? avg[s] : 0.0, sc = row_ok ? scale[s] : 0.0;

  double acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0;
  double yy = 0.0;  // this thread's share of its row's sum of y^2

  for (int i0 = i_begin; i0 < i_end; i0 += BI) {
    uint32_t w = 0xFFFFu;  // past the chunk: missing
    if (row_ok) w = __ldg(reinterpret_cast<const uint16_t *>(src + i0 / 4));
    double y[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t c = (w >> (2 * j)) & 3u;
      y[j] = c != 3u ? ((double)c - m) * sc : 0.0;
      yy = fma(y[j], y[j], yy);
    }
    __syncthreads();  // the previous stage is consumed
#pragma unroll
    for (int j = 0; j < 8; ++j) ys[8 * fq + j][fr] = y[j];
    for (int e = tid; e < BI * TK; e += THREADS) {
      const int i = e / TK, c = e % TK;
      gs[i][c] = c0 + c < k ? __ldg(g + (size_t)(i0 + i) * k + c0 + c) : 0.0;
    }
    __syncthreads();

#pragma unroll 8
    for (int i = 0; i < BI; ++i) {
      const double2 r0 = *reinterpret_cast<const double2 *>(&ys[i][4 * ty]);
      const double2 r1 = *reinterpret_cast<const double2 *>(&ys[i][4 * ty + 2]);
      const double2 q0 = *reinterpret_cast<const double2 *>(&gs[i][4 * tx]);
      const double2 q1 = *reinterpret_cast<const double2 *>(&gs[i][4 * tx + 2]);
      const double r[4] = {r0.x, r0.y, r1.x, r1.y};
      const double q[4] = {q0.x, q0.y, q1.x, q1.y};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fma(r[a], q[b], acc[a][b]);
    }
  }

  // the row's sum of y^2: its four fill threads are adjacent lanes
  yy += __shfl_xor_sync(0xffffffffu, yy, 1);
  yy += __shfl_xor_sync(0xffffffffu, yy, 2);
  if (y2out != nullptr && blockIdx.y == 0 && fq == 0 && row_ok) {
    if (add)
      y2out[s] += yy;
    else
      y2out[(size_t)blockIdx.z * S + s] = yy;
  }

  double *out = add ? hout : hout + (size_t)blockIdx.z * S * k;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = s0 + 4 * ty + a;
    if (r >= S) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = c0 + 4 * tx + b;
      if (c >= k) continue;
      if (add)
        out[(size_t)r * k + c] += acc[a][b];
      else
        out[(size_t)r * k + c] = acc[a][b];
    }
  }
}

// h[e] += the sum over slices z, in order, of part[z][e].
__global__ void rand_h_reduce(const double *__restrict__ part, int nslice,
                              long long len, double *__restrict__ h) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < len; e += (long long)gridDim.x * blockDim.x) {
    double t = 0.0;
    for (int z = 0; z < nslice; ++z) t += part[z * len + e];
    h[e] += t;
  }
}

void reduce(const double *part, int nslice, long long len, double *out,
            cudaStream_t st) {
  const long long blocks = (len + 255) / 256;
  rand_h_reduce<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(
      part, nslice, len, out);
}

}  // namespace

// packed: (S, B) uint8, B % 16 == 0; avg, scale: (S,) float64; g: (4B, k)
// float64; slice_len: samples per slice, a multiple of 32; h (S, k)
// float64 += Y G and, when y2 is not null, y2 (S,) += the per-row sums of
// y^2. With one slice (slice_len >= 4B) part and y2part are unused (may be
// null), else part holds nslice * S * k and y2part nslice * S float64.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int rand_h_launch(const void *packed, int S, int B,
                             const void *avg, const void *scale,
                             const void *g, int k, int slice_len, void *part,
                             void *y2part, void *h, void *y2, void *stream) {
  if (S > 0 && k > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int nslice = (4 * B + slice_len - 1) / slice_len;
    const dim3 grid((S + TS - 1) / TS, (k + TK - 1) / TK, nslice);
    const bool direct = nslice == 1;
    double *y2d = static_cast<double *>(y2);
    rand_h_part<<<grid, THREADS, 0, st>>>(
        static_cast<const uint8_t *>(packed), S, B,
        static_cast<const double *>(avg), static_cast<const double *>(scale),
        static_cast<const double *>(g), k, slice_len,
        static_cast<double *>(direct ? h : part),
        y2d == nullptr ? nullptr : direct ? y2d
                                          : static_cast<double *>(y2part),
        direct ? 1 : 0);
    if (!direct) {
      reduce(static_cast<const double *>(part), nslice, (long long)S * k,
             static_cast<double *>(h), st);
      if (y2d != nullptr)
        reduce(static_cast<const double *>(y2part), nslice, S, y2d, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
