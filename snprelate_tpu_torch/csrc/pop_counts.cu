// K11 pop_counts: per-population allele counts and allele numbers of one
// packed SNP chunk.
//
// Replaces snprelate_tpu/models/fst.py:49, the jitted step of _pop_counts
// (decode2bit, then the (S, N) dosage and validity blocks against the
// (N, n_pop) one-hot population matrix on the MXU). For one packed chunk
// (S, B) uint8, 4 samples a byte with the first in the low bits and 0xFF
// padding (= missing), and a population code per sample (pop, (4B,)
// int32), it writes acnt[s, p] = the sum of the valid genotypes of the
// samples of population p at SNP s, and cnt[s, p] = 2 x their number of
// valid calls, both (S, n_pop) int32. Codes outside [0, n_pop) count
// nowhere.
//
// What bounds it on the card: bytes. It reads the packed chunk once
// (S * B bytes) and the codes from L2; there is no tensor-core work.
//
// Design: a segmented byte-stream reduction. One block owns R SNP rows;
// its threads walk the rows' 32-bit words (16 samples each) side by side,
// so the loads coalesce, and load the 16 samples' codes once for all R
// rows. Each valid call adds into per-population counters in shared memory
// with shared-memory atomics. The counters are kept in C copies (C up to
// 32, a thread uses copy lane % C), laid out so that the lanes of a warp
// hit different banks and different addresses when they count into the
// same population; at the end the block adds the copies and writes its
// rows. R and C are chosen so that the counters fit 48 KB; past R = C = 1
// the populations are split into groups of one launch each. Integer sums
// do not depend on their order: the result is exact and repeatable.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SMEM = 48 * 1024;  // bytes of counters a block may hold

__global__ void __launch_bounds__(THREADS)
pop_counts_kernel(const uint8_t *__restrict__ packed, int S, int B,
                  const int *__restrict__ pop, int n_pop, int p0, int np,
                  int R, int C, int *__restrict__ acnt,
                  int *__restrict__ cnt) {
  extern __shared__ int ctr[];  // [R][np][2][C]: allele count, then calls
  const int s0 = blockIdx.x * R;
  const int rows = min(R, S - s0);
  const int total = R * np * 2 * C;
  for (int i = threadIdx.x; i < total; i += THREADS) ctr[i] = 0;
  __syncthreads();

  const int copy = (threadIdx.x & 31) % C;
  const int W = B / 4;  // 32-bit words a row
  for (int w = threadIdx.x; w < W; w += THREADS) {
    int code[16];
    const int4 *pc = reinterpret_cast<const int4 *>(pop + 16 * w);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 v = __ldg(pc + q);
      code[4 * q] = v.x - p0;
      code[4 * q + 1] = v.y - p0;
      code[4 * q + 2] = v.z - p0;
      code[4 * q + 3] = v.w - p0;
    }
    for (int r = 0; r < rows; ++r) {
      const uint32_t x = __ldg(reinterpret_cast<const uint32_t *>(
          packed + (size_t)(s0 + r) * B) + w);
      if (x == 0xFFFFFFFFu) continue;  // 16 missing calls
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const uint32_t gk = (x >> (2 * k)) & 3u;
        if (gk == 3u || (unsigned)code[k] >= (unsigned)np) continue;
        int *c = ctr + ((r * np + code[k]) * 2) * C + copy;
        if (gk) atomicAdd(c, (int)gk);
        atomicAdd(c + C, 1);
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < rows * np * 2; i += THREADS) {
    const int *c = ctr + i * C;
    int sum = 0;
    for (int k = 0; k < C; ++k) sum += c[k];
    const int r = i / (2 * np), p = (i >> 1) % np;
    const size_t o = (size_t)(s0 + r) * n_pop + p0 + p;
    if (i & 1)
      cnt[o] = 2 * sum;
    else
      acnt[o] = sum;
  }
}

}  // namespace

// packed: (S, B) uint8, B % 16 == 0, 16-byte aligned; pop: (4B,) int32,
// 16-byte aligned; acnt, cnt: (S, n_pop) int32, written whole. Launches on
// `stream` (one kernel per group of populations whose counters fit);
// returns cudaGetLastError().
extern "C" int pop_counts_launch(const void *packed, int S, int B,
                                 const void *pop, int n_pop, void *acnt,
                                 void *cnt, void *stream) {
  if (S <= 0 || n_pop <= 0) return static_cast<int>(cudaGetLastError());
  const auto st = static_cast<cudaStream_t>(stream);
  auto bytes = [](int r, int np, int c) {
    return (long long)r * np * 2 * c * (long long)sizeof(int);
  };
  int R = 8, C = 32;
  while (C > 1 && bytes(R, n_pop, C) > SMEM) C /= 2;
  while (R > 1 && bytes(R, n_pop, C) > SMEM) R /= 2;
  const int group = (int)(SMEM / bytes(R, 1, C));  // populations a launch
  for (int p0 = 0; p0 < n_pop; p0 += group) {
    const int np = n_pop - p0 < group ? n_pop - p0 : group;
    pop_counts_kernel<<<(S + R - 1) / R, THREADS, bytes(R, np, C), st>>>(
        static_cast<const uint8_t *>(packed), S, B,
        static_cast<const int *>(pop), n_pop, p0, np, R, C,
        static_cast<int *>(acnt), static_cast<int *>(cnt));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
