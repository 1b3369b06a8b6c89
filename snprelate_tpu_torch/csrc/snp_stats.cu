// K2a snp_stats: per-SNP genotype sum, valid count, mean, Eigenstrat scale
// and polymorphism flag of one packed chunk.
//
// Replaces snprelate_tpu/ops/pairwise.py:chunk_snp_stats and the avg/scale
// part of make_pca_block (plus the poly flag of _gcta_step). For SNP row s:
//   gsum = sum of valid g, gnum = number of valid g (0xFF padding = missing),
//   avg = gsum / gnum (0 when gnum = 0),
//   scale = 1 / sqrt(p (1 - p)) with p = avg / 2, 0 outside (0, 1); the
//   Bayesian variant uses p = (gsum + 1) / (2 gnum + 2),
//   poly = 0 < gsum < 2 gnum.
//
// What bounds it on the card: bytes. It reads the packed chunk once (S*N/4
// bytes) and writes 25 bytes per SNP; the arithmetic is a few operations per
// byte.
//
// Design: one block per SNP row. Each thread reduces 32-bit words of 16
// genotypes with two masks and three popcounts (no per-genotype unpack),
// then a warp shuffle and a shared-memory step finish the row. The float
// values are computed in double with the same operations as the plain
// version, so they agree bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
snp_stats_kernel(const uint8_t *__restrict__ packed, int B, int bayesian,
                 int *__restrict__ gsum, int *__restrict__ gnum,
                 double *__restrict__ avg, double *__restrict__ scale,
                 bool *__restrict__ poly) {
  const int s = blockIdx.x;
  const uint32_t *row =
      reinterpret_cast<const uint32_t *>(packed + (size_t)s * B);
  int sum = 0, num = 0;
  for (int k = threadIdx.x; k < B / 4; k += THREADS) {
    const uint32_t w = __ldg(row + k);
    const uint32_t lo = w & 0x55555555u, hi = (w >> 1) & 0x55555555u;
    const uint32_t valid = 0x55555555u ^ (lo & hi);  // code != 3
    num += __popc(valid);
    sum += __popc(lo & valid) + 2 * __popc(hi & valid);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_down_sync(0xFFFFFFFFu, sum, off);
    num += __shfl_down_sync(0xFFFFFFFFu, num, off);
  }
  __shared__ int part[2][THREADS / 32];
  if ((threadIdx.x & 31) == 0) {
    part[0][threadIdx.x >> 5] = sum;
    part[1][threadIdx.x >> 5] = num;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  sum = 0;
  num = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    sum += part[0][w];
    num += part[1][w];
  }
  const double a = num > 0 ? (double)sum / (double)num : 0.0;
  double sc;
  if (bayesian) {
    const double p = ((double)sum + 1.0) / (2.0 * (double)num + 2.0);
    sc = 1.0 / sqrt(p * (1.0 - p));
  } else {
    const double p = a * 0.5;
    sc = (p > 0.0 && p < 1.0) ? 1.0 / sqrt(p * (1.0 - p)) : 0.0;
  }
  gsum[s] = sum;
  gnum[s] = num;
  avg[s] = a;
  scale[s] = sc;
  poly[s] = sum > 0 && sum < 2 * num;
}

}  // namespace

// packed: (S, B) uint8, B % 4 == 0. Outputs of length S: gsum, gnum int32;
// avg, scale float64; poly bool. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int snp_stats_launch(const void *packed, int S, int B,
                                int bayesian, void *gsum, void *gnum,
                                void *avg, void *scale, void *poly,
                                void *stream) {
  if (S > 0)
    snp_stats_kernel<<<S, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t *>(packed), B, bayesian,
        static_cast<int *>(gsum), static_cast<int *>(gnum),
        static_cast<double *>(avg), static_cast<double *>(scale),
        static_cast<bool *>(poly));
  return static_cast<int>(cudaGetLastError());
}
