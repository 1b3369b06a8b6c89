// K3b rand_yt: fused 2-bit decode + randomized-PCA normalization + thin
// transposed product, carry += Y' M, of one packed SNP chunk or
// sample-group slab.
//
// Replaces snprelate_tpu/models/pca_randomized.py:_g_step and the G part of
// _power_pass (G_next += Y' H), _t_step / _t_pass (T += U_H' Y, kept here
// transposed as T' += Y' U_H), and the slab route's g_accum and t_accum
// (pca_randomized.py:325,415) and the rank PCA's W_r = Y_r' H_r. For packed
// rows (S, N/4), their per-SNP avg/scale and M (S, c) float64, it adds Y' M
// into a float64 (N, c) carry in place, where
//   y[s, i] = (g - avg[s]) * scale[s] for a valid call, 0 for a missing one.
// c is k (aux_dim) for the power passes and hsize = k (iter_num + 1) for the
// projection pass.
//
// What bounds it on the card: float64 operations, 2*S*N*c, against S*N/4
// bytes of packed input, S*c*8 bytes of M and 2*N*c*8 bytes of carry read
// and written. At S = 4096, N = 100,096 that is 5.2e10 flop for c = 64 and
// 5.8e11 flop for c = 704.
//
// Design: one block owns a 64-sample x 64-column tile of the carry and loops
// over its slice of the SNPs in 32-SNP stages: the Y tile is decoded and
// normalized in registers from the packed bytes (it never exists in device
// memory) and stored in shared memory beside the stage's rows of M; each
// thread accumulates a 4 x 4 block of the tile with float64 FMAs. At the
// full 100k width the sample axis gives N/64 blocks (1,564 at N = 100,096)
// times the column tiles, enough to fill the card, so there is one slice and
// the epilogue adds the tile straight into the carry. Few samples (a
// 7,936-sample slab gives 124 blocks for c = 64, under one wave of 132 SMs,
// each walking up to 131,072 SNPs) cut the SNP axis into slices (the z axis
// of the grid): each block writes its slice's partial tile to a scratch
// buffer and a second kernel adds the slices in slice order into the carry.
// No atomics either way, so repeated runs are bitwise equal. FP64
// tensor-core MMA is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TN = 64;        // samples per carry tile
constexpr int TC = 64;        // carry columns per tile
constexpr int BS = 32;        // SNPs per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

// Block z sums the SNPs [z * slice_len, (z + 1) * slice_len). part null:
// carry += the tile; else part[z] = the tile.
__global__ void __launch_bounds__(THREADS)
rand_yt_kernel(const uint8_t *__restrict__ packed, int S, int B,
               const double *__restrict__ avg,
               const double *__restrict__ scale,
               const double *__restrict__ m, int c, int slice_len,
               double *__restrict__ carry, double *__restrict__ part) {
  __shared__ __align__(16) double ys[BS][TN];  // [snp][sample]
  __shared__ __align__(16) double ms[BS][TC];  // [snp][column]

  const int i0 = blockIdx.x * TN, c0 = blockIdx.y * TC;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  // Stage fill: thread -> (SNP fr, 8-sample group fq) of the Y tile.
  const int fr = tid >> 3, fq = tid & 7;
  const uint8_t *src = packed + i0 / 4 + 2 * fq;

  double acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0;

  const int k_begin = blockIdx.z * slice_len;
  const int k_end = min(S, k_begin + slice_len);
  for (int k0 = k_begin; k0 < k_end; k0 += BS) {
    const int s = k0 + fr;
    uint32_t w = 0xFFFFu;  // past the slice: missing
    double mu = 0.0, sc = 0.0;
    if (s < k_end) {
      w = __ldg(reinterpret_cast<const uint16_t *>(src + (size_t)s * B));
      mu = avg[s];
      sc = scale[s];
    }
    double y[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t code = (w >> (2 * j)) & 3u;
      y[j] = code != 3u ? ((double)code - mu) * sc : 0.0;
    }
    __syncthreads();  // the previous stage is consumed
    double2 *yd = reinterpret_cast<double2 *>(&ys[fr][8 * fq]);
#pragma unroll
    for (int j = 0; j < 4; ++j) yd[j] = make_double2(y[2 * j], y[2 * j + 1]);
    for (int e = tid; e < BS * TC; e += THREADS) {
      const int r = e / TC, cc = e % TC, sr = k0 + r;
      ms[r][cc] = (sr < k_end && c0 + cc < c)
                      ? __ldg(m + (size_t)sr * c + c0 + cc) : 0.0;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BS; ++kk) {
      const double2 r0 = *reinterpret_cast<const double2 *>(&ys[kk][4 * ty]);
      const double2 r1 = *reinterpret_cast<const double2 *>(&ys[kk][4 * ty + 2]);
      const double2 q0 = *reinterpret_cast<const double2 *>(&ms[kk][4 * tx]);
      const double2 q1 = *reinterpret_cast<const double2 *>(&ms[kk][4 * tx + 2]);
      const double r[4] = {r0.x, r0.y, r1.x, r1.y};
      const double q[4] = {q0.x, q0.y, q1.x, q1.y};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fma(r[a], q[b], acc[a][b]);
    }
  }

  // Epilogue: carry += tile (in place; each entry has one owner), or the
  // slice's partial into part[z].
  double *out = part == nullptr
                    ? nullptr : part + (size_t)blockIdx.z * (4 * B) * c;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const size_t row = (size_t)(i0 + 4 * ty + a) * c;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int col = c0 + 4 * tx + b;
      if (col >= c) continue;
      if (out == nullptr)
        carry[row + col] += acc[a][b];
      else
        out[row + col] = acc[a][b];
    }
  }
}

// carry[e] += the sum over slices z, in order, of part[z][e].
__global__ void rand_yt_reduce(const double *__restrict__ part, int nslice,
                               long long len, double *__restrict__ carry) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < len; e += (long long)gridDim.x * blockDim.x) {
    double t = 0.0;
    for (int z = 0; z < nslice; ++z) t += part[z * len + e];
    carry[e] += t;
  }
}

}  // namespace

// packed: (S, B) uint8, B % 16 == 0; avg, scale: (S,) float64; m: (S, c)
// float64; carry: (4B, c) float64 += Y' M, the SNP axis cut into slices of
// slice_len (a multiple of 32) and added in slice order. part: scratch of
// nslice * 4B * c float64, unused (may be null) with one slice
// (slice_len >= S). Launches on `stream`; returns cudaGetLastError().
extern "C" int rand_yt_launch(const void *packed, int S, int B,
                              const void *avg, const void *scale,
                              const void *m, int c, int slice_len, void *part,
                              void *carry, void *stream) {
  if (c > 0 && B > 0 && S > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int nslice = (S + slice_len - 1) / slice_len;
    const dim3 grid(4 * B / TN, (c + TC - 1) / TC, nslice);
    double *p = nslice > 1 ? static_cast<double *>(part) : nullptr;
    rand_yt_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const uint8_t *>(packed), S, B,
        static_cast<const double *>(avg), static_cast<const double *>(scale),
        static_cast<const double *>(m), c, slice_len,
        static_cast<double *>(carry), p);
    if (p != nullptr) {
      const long long len = (long long)4 * B * c;
      const long long blocks = (len + 255) / 256;
      rand_yt_reduce<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(
          p, nslice, len, static_cast<double *>(carry));
    }
  }
  return static_cast<int>(cudaGetLastError());
}
