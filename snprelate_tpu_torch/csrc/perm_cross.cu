// K15 perm_cross: the between-group sums of cut_tree's permutation splits.
//
// Replaces snprelate_tpu/models/cluster.py:_perm_cross_dev (:63, jitted at
// :85), the device half of _perm_cross_means: out[p] = rowsum((U D) *
// (1 - U))[p] = sum over a with U[p, a] = 1 and b with U[p, b] = 0 of
// D[a, b], for the split indicators U (P, m) uint8 (0/1) of P permutations
// and the merge's distance block D (m, m) float64.
//
// What bounds it on the card: the float64 product, 2 P m^2 operations (the
// bytes, P m + 8 m^2, are few). With 0/1 weights every fused multiply-add
// is an exact add of D[a, b] or of 0, so the product keeps the values of
// the JAX step's; only the order of the sums differs.
//
// Design: one block a (64 permutations) x (64 columns) tile of W = U D,
// the reduction over a staged through shared memory in steps of 16 (U
// converted to float64 on the way in), each thread a 4 x 4 register tile
// (rows ty + 16 r, columns tx + 16 c, so the warp's shared reads are
// conflict-free). The epilogue multiplies by (1 - U) and sums the block's
// 64 columns in a fixed order into one partial a (permutation, column
// tile); a second kernel adds each permutation's partials in column-tile
// order. No atomics: the result is bitwise repeatable. FP64 tensor-core
// MMA (mma.sync m8n8k4) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TP = 64;   // permutations of a block tile
constexpr int TJ = 64;   // columns of a block tile
constexpr int TK = 16;   // reduction step
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
perm_cross_kernel(const uint8_t *__restrict__ U, const double *__restrict__ D,
                  int P, int m, double *__restrict__ part, int nj) {
  __shared__ double us[TK][TP];
  __shared__ double ds[TK][TJ];
  __shared__ double red[TP][THREADS / 16 + 1];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int p0 = blockIdx.y * TP, j0 = blockIdx.x * TJ;
  double acc[4][4] = {};
  for (int k0 = 0; k0 < m; k0 += TK) {
#pragma unroll
    for (int q = 0; q < TP * TK / THREADS; ++q) {
      const int e = tid + q * THREADS, r = e / TK, c = e % TK;
      const int p = p0 + r, k = k0 + c;
      us[c][r] = (p < P && k < m) ? (double)U[(size_t)p * m + k] : 0.0;
    }
#pragma unroll
    for (int q = 0; q < TK * TJ / THREADS; ++q) {
      const int e = tid + q * THREADS, r = e / TJ, c = e % TJ;
      const int k = k0 + r, j = j0 + c;
      ds[r][c] = (k < m && j < m) ? __ldg(D + (size_t)k * m + j) : 0.0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      double a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = us[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = ds[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = __fma_rn(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
  // epilogue: W * (1 - U), summed over the tile's columns in a fixed order
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = p0 + ty + 16 * r;
    double s = 0.0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (p < P && j < m)
        s = __dadd_rn(s, __dmul_rn(acc[r][c],
                                   __dsub_rn(1.0, (double)U[(size_t)p * m + j])));
    }
    red[ty + 16 * r][tx] = s;
  }
  __syncthreads();
  if (tid < TP && p0 + tid < P) {
    double s = red[tid][0];
    for (int x = 1; x < 16; ++x) s = __dadd_rn(s, red[tid][x]);
    part[(size_t)(p0 + tid) * nj + blockIdx.x] = s;
  }
}

__global__ void perm_cross_sum(const double *__restrict__ part, int P, int nj,
                               double *__restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  double s = 0.0;
  for (int t = 0; t < nj; ++t) s = __dadd_rn(s, part[(size_t)p * nj + t]);
  out[p] = s;
}

}  // namespace

// U: (P, m) uint8 0/1; D: (m, m) float64; part: (P, ceil(m / 64)) float64
// scratch; out: (P,) float64. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int perm_cross_launch(const void *U, const void *D, int P, int m,
                                 void *part, void *out, void *stream) {
  if (P <= 0) return 0;
  const int nj = (m + TJ - 1) / TJ;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nj > 0)
    perm_cross_kernel<<<dim3(nj, (P + TP - 1) / TP), THREADS, 0, st>>>(
        static_cast<const uint8_t *>(U), static_cast<const double *>(D), P,
        m, static_cast<double *>(part), nj);
  perm_cross_sum<<<(P + 255) / 256, 256, 0, st>>>(
      static_cast<const double *>(part), P, nj, static_cast<double *>(out));
  return static_cast<int>(cudaGetLastError());
}
