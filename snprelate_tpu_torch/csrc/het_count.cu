// K5 het_count: per-sample heterozygote count of one packed SNP chunk.
//
// Replaces the het term of snprelate_tpu/ops/pairwise.py:_eigmix_step,
// hetcnt += (geno == 1).sum(axis=0). For one packed chunk (S, N/4) it adds
// #{s : g[s, i] == 1} into an int32 (N,) carry in place; 0xFF padding
// decodes to 3 (missing) and counts nowhere.
//
// What bounds it on the card: bytes. It reads the packed chunk once (S*N/4
// bytes) and does a few integer operations per byte.
//
// Design: a column reduction. One thread per packed byte column (4 samples)
// loops over a slice of the chunk's SNP rows; neighbouring threads read
// neighbouring bytes of a row, so the loads coalesce. The SNP rows are cut
// into slices (the y axis of the grid) so that a narrow cohort still gives
// enough blocks, and each thread adds its four counts into the carry with
// integer atomics: integer sums do not depend on their order, so the result
// is exact and the same on every run.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int ROWS = 256;  // SNP rows per slice

__global__ void __launch_bounds__(THREADS)
het_count_kernel(const uint8_t *__restrict__ packed, int S, int B,
                 int *__restrict__ carry) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= B) return;
  const int s0 = blockIdx.y * ROWS, s1 = min(S, s0 + ROWS);
  int n[4] = {0, 0, 0, 0};
  for (int s = s0; s < s1; ++s) {
    const uint32_t b = __ldg(packed + (size_t)s * B + col);
#pragma unroll
    for (int j = 0; j < 4; ++j) n[j] += ((b >> (2 * j)) & 3u) == 1u;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (n[j]) atomicAdd(carry + 4 * col + j, n[j]);
}

}  // namespace

// packed: (S, B) uint8; carry: (4B,) int32, updated in place. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int het_count_launch(const void *packed, int S, int B, void *carry,
                                void *stream) {
  if (S > 0 && B > 0) {
    const dim3 grid((B + THREADS - 1) / THREADS, (S + ROWS - 1) / ROWS);
    het_count_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t *>(packed), S, B, static_cast<int *>(carry));
  }
  return static_cast<int>(cudaGetLastError());
}
