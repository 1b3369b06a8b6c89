// What K3a rand_h and K3b rand_yt share: the float64 tensor-core product
// (mma.sync.m16n8k8 .f64, Hopper's), the double-buffered cp.async stages of
// the float64 operand (G for rand_h, M for rand_yt), its fragment loads,
// the per-SNP decode table and the ordered sum of the slices' partial
// tiles. The stage depth, ring and tile widths were chosen on the card
// against 32-deep four-stage rings, three stages, one block an SM with
// more registers, 128-wide tiles and a product order by fragment row.
//
// K2b norm_gram (csrc/norm_gram.cu) uses its cp.async helpers; K7 pc_corr
// (csrc/pc_corr.cu) its product, operand stages and fragment loads.
//
// A block owns a BM x BN tile of the output (BN = 32 or 64, a template
// parameter, so a 32-wide product does no masked work) and walks its slice
// of the summed axis in stages of BK. Its warps each own a
// 32 x 32 tile: 2 x 4 products of 16 x 8, so one A fragment feeds four
// products and one B fragment two. Fragments, with g = lane / 4 and
// t = lane % 4 (PTX ISA, mma.m16n8k8 .f64):
//   a[2j + h] = A[g + 8h][t + 4j],  b[j] = B[t + 4j][g],
//   d[2h + e] = D[g + 8h][2t + e].
// A's rows and the summed index may stand for any samples or SNPs, as long
// as A, B and D agree; the kernels choose them so that a lane's 2-bit codes
// share bytes.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rand_mma {

constexpr int BM = 128;    // output rows per block
constexpr int BK = 64;     // summed-axis depth of one stage
constexpr int STAGES = 2;  // the cp.async ring: one stage lands while the
                           // other is multiplied
constexpr int KS = 8;      // depth of one product (m16n8k8)
constexpr int MT = 2;      // 16-row products per warp tile
constexpr int NT = 4;      // 8-column products per warp tile

template <int BN>
struct Tile {
  static constexpr int WN = BN / 32;             // warps along the columns
  static constexpr int THREADS = 32 * (BM / 32) * WN;
  static constexpr int MIN_BLOCKS = 4 / WN;  // 16 warps per SM: at most
                                             // 128 registers a thread
  static constexpr int LDB = BN + 8;  // padded operand row (doubles): 64
                                      // bytes past a multiple of 128, so a
                                      // fragment's 4 rows x 8 columns take
                                      // the least two wavefronts
  static constexpr int B_BYTES = BK * LDB * 8;
};

__device__ __forceinline__ void mma(double (&d)[4], const double (&a)[4],
                                    const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

__device__ __forceinline__ uint32_t smem(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes (8 with cp8) from global to shared, of which the first `bytes`
// are read and the rest zero-filled (bytes 0: nothing is read).
__device__ __forceinline__ void cp16(void *dst, const void *src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp8(void *dst, const void *src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + BK) and columns [c0, c0 + BN) of a row-major (rows, c)
// float64 matrix into dst[BK][LDB], rows from r_end and columns from c on
// zero-filled, by the block's THREADS threads. vec: 16-byte copies (c
// even, the matrix 16-byte aligned), else 8-byte ones.
template <int BN, int THREADS = Tile<BN>::THREADS>
__device__ __forceinline__ void load_operand(double *dst,
                                             const double *__restrict__ src,
                                             int r0, int r_end, int c, int c0,
                                             bool vec) {
  using T = Tile<BN>;
  for (int e = threadIdx.x; e < BK * BN / 2; e += THREADS) {
    const int r = e / (BN / 2), q = 2 * (e % (BN / 2));
    const int row = r0 + r, col = c0 + q;
    const int n = row < r_end ? max(0, min(2, c - col)) : 0;
    const double *s = n > 0 ? src + (size_t)row * c + col : src;
    double *d = dst + r * T::LDB + q;
    if (vec) {
      cp16(d, s, 8 * n);
    } else {
      cp8(d, s, n > 0 ? 8 : 0);
      cp8(d + 1, n > 1 ? s + 1 : src, n > 1 ? 8 : 0);
    }
  }
}

// The B fragments (W of 8 columns each) of the stage's 8-deep step kk for
// a warp whose columns start at column n0 of the tile.
template <int BN, int W = NT>
__device__ __forceinline__ void load_b(double (&b)[W][2], const double *bs,
                                       int kk, int n0, int g, int t) {
  const double *p = bs + (KS * kk + t) * Tile<BN>::LDB + n0 + g;
#pragma unroll
  for (int nt = 0; nt < W; ++nt) {
    b[nt][0] = p[8 * nt];
    b[nt][1] = p[4 * Tile<BN>::LDB + 8 * nt];
  }
}

__device__ __forceinline__ void product(double (&acc)[MT][NT][4],
                                        const double (&a)[MT][4],
                                        const double (&b)[NT][2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma(acc[mt][nt], a[mt], b[nt]);
}

// The decode table: tab[s] = the y of codes 0, 1, 2 and 3 (missing) of
// SNP s, (code - avg[s]) * scale[s] and 0, the same double the plain
// version forms.
__global__ void decode_table(const double *__restrict__ avg,
                             const double *__restrict__ scale, int S,
                             double4 *__restrict__ tab) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < S) {
    const double m = avg[s], sc = scale[s];
    tab[s] = make_double4((0.0 - m) * sc, (1.0 - m) * sc, (2.0 - m) * sc,
                          0.0);
  }
}

inline void table(const void *avg, const void *scale, int S, void *tab,
                  cudaStream_t st) {
  decode_table<<<(S + 255) / 256, 256, 0, st>>>(
      static_cast<const double *>(avg), static_cast<const double *>(scale), S,
      static_cast<double4 *>(tab));
}

// out[e] += the sum over slices z, in order, of part[z][e].
__global__ void reduce_slices(const double *__restrict__ part, int nslice,
                              long long len, double *__restrict__ out) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < len; e += (long long)gridDim.x * blockDim.x) {
    double t = 0.0;
    for (int z = 0; z < nslice; ++z) t += part[z * len + e];
    out[e] += t;
  }
}

inline void reduce(const double *part, int nslice, long long len,
                   double *out, cudaStream_t st) {
  const long long blocks = (len + 255) / 256;
  reduce_slices<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(
      part, nslice, len, out);
}

}  // namespace rand_mma
