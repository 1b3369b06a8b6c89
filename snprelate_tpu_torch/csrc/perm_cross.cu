// K15 perm_cross: the between-group sums of cut_tree's permutation splits,
// on the float64 tensor cores.
//
// Replaces snprelate_tpu/models/cluster.py:_perm_cross_dev (:63, jitted at
// :85), the device half of _perm_cross_means: out[p] = rowsum((U D) *
// (1 - U))[p] = sum over a with U[p, a] = 1 and b with U[p, b] = 0 of
// D[a, b], for the split indicators U (P, m) uint8 (0/1) of P permutations
// and the merge's distance block D (m, m) float64.
//
// What bounds it on the card: the float64 product, 2 P m^2 operations,
// against P m + 8 m^2 bytes: at P = 5,000, m = 1,000 0.149 ms at the 67
// TFLOP/s of the float64 tensor cores, the only float64 rate that reaches
// it. With 0/1 weights every product is an exact add of D[a, b] or of 0,
// so the result keeps the values of the JAX step's; only the order of the
// sums differs.
//
// Design (the shared parts in rand_mma.cuh, K3a / K3b's): every product is
// an mma.sync.m16n8k8 .f64. A block owns 128 permutations x 64 columns j
// of W = U D (8 warps of 32 x 32) and one slice of the summed axis a, which
// it walks in 64-deep stages, double buffered with cp.async: D's rows (64
// x 64 float64, 16-byte copies, or 8-byte ones where m is odd, ragged
// edges zero-filled) and U's rows as bytes. U's rows start at any byte (m
// = 129, 777), so a stage copies each row's 17 aligned 4-byte words that
// hold its 64 bytes, the last word of the tensor cut to its own bytes,
// and a lane reads its bytes past the row's offset in the first word; the
// bytes that run into the next row meet D rows past the slice, which are
// zero. A lane's A fragment (rows g + 8h, a = t + 4j) is formed from the
// bytes in registers: byte b becomes the double whose high word is
// -b & 0x3FF00000 and low word 0 (1.0 or 0.0), integer work with no
// conversion. The epilogue multiplies each W by (1 - U[p, j]) and sums a
// row's columns in a fixed order (a lane's 8, the 4 lanes of the row, the
// two column warps) into one partial per (permutation, slice, column
// tile); perm_cross_sum adds them in that order. No atomics: a second
// launch gives the same bits. Where the tiles do not fill the card (few
// permutations, cut_tree's smaller merges), the summed axis is cut into
// slices (ops/kernels.py perm_plan, the launch plan, mirrored by the CPU
// tests of tests/test_torch_perm_plan.py). What holds it at about half
// the bound (chip_smoke.py's `[time] perm_cross` line): at P = 5,000, m =
// 1,000 its 640 blocks are 2.42 waves of two an SM, and a lane makes
// eight byte loads a k step beside its eight products.

#include "rand_mma.cuh"

namespace {

using namespace rand_mma;

constexpr int BN = 64;   // columns j of a block tile
using T = Tile<BN>;      // 256 threads, two blocks an SM
constexpr int UW = 17;   // aligned words that hold a row's 64 stage bytes
constexpr int LDU = 4 * UW;  // a staged U row (bytes): 17 words, odd, so
                             // the 8 rows of a fragment load hit 8 banks
constexpr int U_BYTES = BM * LDU;                            // 8,704
constexpr int SMEM = STAGES * (T::B_BYTES + U_BYTES) + BM * 2 * 8;  // 93,184

__device__ __forceinline__ void cp4(void *dst, const void *src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem(dst)),
               "l"(src), "r"(bytes));
}

// Block (x, y, z): W rows p0 = 128 y .., columns c0 = 64 x .., the summed
// axis [z slice_len, (z + 1) slice_len); part[p][z gridDim.x + x] = the
// block's (1 - U)-weighted row sum.
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
perm_cross_part(const uint8_t *__restrict__ U, const double *__restrict__ D,
                int P, int m, bool vec, int slice_len,
                double *__restrict__ part) {
  extern __shared__ __align__(16) uint8_t sm[];
  double *bs = reinterpret_cast<double *>(sm);    // [STAGES][BK][LDB]
  uint8_t *us = sm + STAGES * T::B_BYTES;         // [STAGES][BM][LDU]
  double *red = reinterpret_cast<double *>(us + STAGES * U_BYTES);  // [BM][2]
  const int p0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  const int a_begin = blockIdx.z * slice_len;
  const int a_end = min(m, a_begin + slice_len);
  const int nst = (a_end - a_begin + BK - 1) / BK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2, gq = lane >> 2, t = lane & 3;
  const int rbase = 32 * wm + gq;  // the lane's rows: rbase + 16 mt + 8 h

  // U's bytes counted from the aligned word at or before its start
  const int u_off = static_cast<int>(reinterpret_cast<uintptr_t>(U) & 3);
  const uint8_t *const ub = U - u_off;
  const long long u_end = u_off + static_cast<long long>(P) * m;

  auto load_stage = [&](int it) {
    const int st = it % STAGES, a0 = a_begin + it * BK;
    load_operand<BN>(bs + st * BK * T::LDB, D, a0, a_end, m, c0, vec);
    uint8_t *u_st = us + st * U_BYTES;
    for (int e = tid; e < BM * UW; e += T::THREADS) {
      const int r = e / UW, w = e - UW * r, p = p0 + r;
      const long long wb =
          ((u_off + static_cast<long long>(p) * m + a0) & ~3LL) + 4 * w;
      const int n =
          p < P ? static_cast<int>(max(0LL, min(4LL, u_end - wb))) : 0;
      cp4(u_st + r * LDU + 4 * w, n > 0 ? ub + wb : ub, n);
    }
  };
  if (nst > 0) load_stage(0);
  commit();

  // the lane's four rows in a staged U tile: row start, the row's offset in
  // its first word (a0 is a multiple of 4) and the lane's t
  int urow[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rbase + 16 * mt + 8 * h;
      urow[mt][h] =
          r * LDU + t +
          static_cast<int>((u_off + static_cast<long long>(p0 + r) * m) & 3);
    }

  double acc[MT][NT][4] = {};
  for (int it = 0; it < nst; ++it) {
    wait<0>();
    __syncthreads();  // stage it has landed; stage it - 1 is consumed
    if (it + 1 < nst) load_stage(it + 1);
    commit();
    const int st = it % STAGES;
    const double *b_st = bs + st * BK * T::LDB;
    const uint8_t *u_st = us + st * U_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / KS; ++kk) {  // a = 8 kk + t + 4 j
      double a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int b = u_st[urow[mt][h] + KS * kk + 4 * j];
            a[mt][2 * j + h] = __hiloint2double(-b & 0x3FF00000, 0);
          }
      double b[NT][2];
      load_b<BN>(b, b_st, kk, 32 * wn, gq, t);
      product(acc, a, b);
    }
  }

  // W (1 - U) summed over the block's columns: the lane's 8 in order, then
  // the 4 lanes of the row, then the two column warps
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rbase + 16 * mt + 8 * h, p = p0 + r;
      double s = 0.0;
      if (p < P) {
        const uint8_t *up = U + static_cast<size_t>(p) * m;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = c0 + 32 * wn + 8 * nt + 2 * t + e;
            if (j < m)
              s = __dadd_rn(s, __dmul_rn(acc[mt][nt][2 * h + e],
                                         1.0 - static_cast<double>(
                                                   __ldg(up + j))));
          }
      }
      s = __dadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
      s = __dadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
      if (t == 0) red[2 * r + wn] = s;
    }
  __syncthreads();
  if (tid < BM && p0 + tid < P)
    part[static_cast<size_t>(p0 + tid) * gridDim.x * gridDim.z +
         blockIdx.z * gridDim.x + blockIdx.x] =
        __dadd_rn(red[2 * tid], red[2 * tid + 1]);
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

// U: (P, m) uint8 0/1; D: (m, m) float64; slice_len: summed-axis entries a
// slice, a multiple of 64; part: (P, ceil(m / 64) * ceil(m / slice_len))
// float64 scratch; out: (P,) float64. Launches on `stream`; returns the
// CUDA error (0 on success).
extern "C" int perm_cross_launch(const void *U, const void *D, int P, int m,
                                 int slice_len, void *part, void *out,
                                 void *stream) {
  if (P <= 0) return 0;
  const int nj = (m + BN - 1) / BN;
  const int nslice = m > 0 ? (m + slice_len - 1) / slice_len : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nj > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        perm_cross_part, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    const bool vec =
        m % 2 == 0 && reinterpret_cast<uintptr_t>(D) % 16 == 0;
    perm_cross_part<<<dim3(nj, (P + BM - 1) / BM, nslice), T::THREADS, SMEM,
                      st>>>(static_cast<const uint8_t *>(U),
                            static_cast<const double *>(D), P, m, vec,
                            slice_len, static_cast<double *>(part));
  }
  perm_cross_sum<<<(P + 255) / 256, 256, 0, st>>>(
      static_cast<const double *>(part), P, nj * nslice,
      static_cast<double *>(out));
  return static_cast<int>(cudaGetLastError());
}
