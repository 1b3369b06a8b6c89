// K2a snp_stats: per-SNP genotype sum, valid count, mean, a scale of one of
// six kinds, the polymorphism flag and, for two kinds, an extra per-SNP value
// of one packed chunk.
//
// Replaces snprelate_tpu/ops/pairwise.py:chunk_snp_stats and the avg/scale
// part of make_pca_block (plus the poly flag of _gcta_step), and the per-SNP
// factors of models/pca_randomized.py:_rand_block, _king_homo_step and
// _eigmix_step. For SNP row s:
//   gsum = sum of valid g, gnum = number of valid g (0xFF padding = missing),
//   avg = gsum / gnum (0 when gnum = 0), p = avg / 2,
//   poly = 0 < gsum < 2 gnum, and the scale by kind:
//     0 eigenstrat  1 / sqrt(p (1 - p)), 0 outside (0, 1)
//     1 bayesian    1 / sqrt(q (1 - q)) with q = (gsum + 1) / (2 gnum + 2)
//     2 randomized  1 / sqrt(2 p (1 - p)), 0 outside (0, 1);
//                   extra = sum over valid calls of ((g - avg) scale)^2
//     3 unit        1
//     4 king_w      sqrt(w) with w = p (1 - p); extra = w
//     5 eigmix_d    sqrt(4 p (1 - p))
//
// What bounds it on the card: bytes. It reads the packed chunk once (S*N/4
// bytes) and writes 33 bytes per SNP; the arithmetic is a few operations per
// byte.
//
// Design: one block per SNP row. Each thread reduces 32-bit words of 16
// genotypes with two masks and three popcounts (no per-genotype unpack) into
// the counts of 1s, of 2s and of valid calls, then a warp shuffle and a
// shared-memory step finish the row. The randomized trace term comes from
// those counts in closed form, n0 a^2 + n1 (1 - a)^2 + n2 (2 - a)^2 times
// scale^2. The float values are computed in double with the same operations
// as the plain version, so avg and the scales agree bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
snp_stats_kernel(const uint8_t *__restrict__ packed, int B, int kind,
                 int *__restrict__ gsum, int *__restrict__ gnum,
                 double *__restrict__ avg, double *__restrict__ scale,
                 bool *__restrict__ poly, double *__restrict__ extra) {
  const int s = blockIdx.x;
  const uint32_t *row =
      reinterpret_cast<const uint32_t *>(packed + (size_t)s * B);
  int n1 = 0, n2 = 0, num = 0;
  for (int k = threadIdx.x; k < B / 4; k += THREADS) {
    const uint32_t w = __ldg(row + k);
    const uint32_t lo = w & 0x55555555u, hi = (w >> 1) & 0x55555555u;
    const uint32_t valid = 0x55555555u ^ (lo & hi);  // code != 3
    num += __popc(valid);
    n1 += __popc(lo & valid);  // code 1
    n2 += __popc(hi & valid);  // code 2
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    n1 += __shfl_down_sync(0xFFFFFFFFu, n1, off);
    n2 += __shfl_down_sync(0xFFFFFFFFu, n2, off);
    num += __shfl_down_sync(0xFFFFFFFFu, num, off);
  }
  __shared__ int part[3][THREADS / 32];
  if ((threadIdx.x & 31) == 0) {
    part[0][threadIdx.x >> 5] = n1;
    part[1][threadIdx.x >> 5] = n2;
    part[2][threadIdx.x >> 5] = num;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  n1 = n2 = num = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    n1 += part[0][w];
    n2 += part[1][w];
    num += part[2][w];
  }
  const int sum = n1 + 2 * n2;
  const double a = num > 0 ? (double)sum / (double)num : 0.0;
  const double p = a * 0.5;
  const bool inside = p > 0.0 && p < 1.0;
  double sc = 1.0, ex = 0.0;
  switch (kind) {
    case 0:
      sc = inside ? 1.0 / sqrt(p * (1.0 - p)) : 0.0;
      break;
    case 1: {
      const double q = ((double)sum + 1.0) / (2.0 * (double)num + 2.0);
      sc = 1.0 / sqrt(q * (1.0 - q));
      break;
    }
    case 2: {
      sc = inside ? 1.0 / sqrt(2.0 * p * (1.0 - p)) : 0.0;
      const double n0 = (double)(num - n1 - n2);
      const double d1 = 1.0 - a, d2 = 2.0 - a;
      ex = (n0 * a * a + (double)n1 * d1 * d1 + (double)n2 * d2 * d2) * sc * sc;
      break;
    }
    case 3:
      break;
    case 4: {
      const double w = p * (1.0 - p);
      sc = sqrt(w);
      ex = w;
      break;
    }
    default:
      sc = sqrt(4.0 * p * (1.0 - p));
  }
  gsum[s] = sum;
  gnum[s] = num;
  avg[s] = a;
  scale[s] = sc;
  poly[s] = sum > 0 && sum < 2 * num;
  if (extra) extra[s] = ex;
}

}  // namespace

// packed: (S, B) uint8, B % 4 == 0; kind 0..5 as above. Outputs of length S:
// gsum, gnum int32; avg, scale float64; poly bool; extra float64, written
// when not null (kinds 2 and 4). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int snp_stats_launch(const void *packed, int S, int B, int kind,
                                void *gsum, void *gnum, void *avg,
                                void *scale, void *poly, void *extra,
                                void *stream) {
  if (S > 0)
    snp_stats_kernel<<<S, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t *>(packed), B, kind,
        static_cast<int *>(gsum), static_cast<int *>(gnum),
        static_cast<double *>(avg), static_cast<double *>(scale),
        static_cast<bool *>(poly), static_cast<double *>(extra));
  return static_cast<int>(cudaGetLastError());
}
