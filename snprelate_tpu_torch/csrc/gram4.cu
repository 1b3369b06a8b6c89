// K8 gram5_cross and K16 gram6: the serving path's (query x cohort) count
// grams and the six one-hot plane grams, on int8 mma.sync. (K1 gram4 and
// its strip and tile modes K1r gram5_rows and K1t gram5_tile run on the
// int8 warpgroup products of csrc/gram5.cu.)
//
// K8 gram5_cross replaces _cross_gram_step (snprelate_tpu/ops/pairwise.py:545),
// the serving path's (query x cohort) update: for one packed cohort chunk,
// (S, N/4) bytes with the first sample in the low bits and 0xFF padding
// (= missing), and a query given as one code byte per genotype, (q, Sq)
// with 3 = missing (any code above 2 counts as missing, and so do the query
// columns from Sq to the chunk's S), it adds Qv'V, Qh'H, Qd'D, Qh'V and
// Qv'H into an int32 (5, q, N) carry, where V = [g != 3], H = [g == 1] and
// D = [g == 2] - [g == 0]. The query is small (1 to 64 rows in serving), so
// the cohort samples take the mma's M side and the queries its n8 side:
// one n8 fragment holds 8 queries, and no 64 x 64 tile is wasted on 8 live
// rows. The cohort stage is K16's; the query stage copies code bytes as
// they are (they are already sample-major with the SNP axis contiguous)
// and the same register basis serves both. The epilogue adds each fragment
// transposed into the (5, q, N) carry. At q = 8 it is bound by the packed
// chunk's bytes, at q = 64 by int8 operations. A variant that formed the
// query's V, H and D once per stage in shared memory, with one 8-warp
// block over 64 queries, measured slower on the card at q = 8 and 64 (160
// registers a thread, so one such block per SM).
//
// K16 gram6 replaces _gram6_step (snprelate_tpu/ops/pairwise.py:303,
// decode2bit -> genotype_planes -> _sym_grams): the six one-hot plane
// cross-grams I_a'I_b, (a, b) in (0,0), (0,1), (0,2), (1,1), (1,2), (2,2),
// I_a = [g == a] (missing, code 3, has all-zero planes), of one packed
// chunk, added into an int32 (6, N, N) carry, over the full square (the
// cross-grams with a != b are not symmetric).
//
// What bounds them on the card: int8 tensor-core operations, 2*S per
// output entry and gram, against S*N/4 bytes of input and the int32 carry
// read and written once per chunk.
//
// Design: one block owns one 64 x 64 output tile of all its grams and
// streams the chunk through shared memory in 128-SNP stages. A stage's
// packed bytes are transposed into one code byte per genotype, sample-major
// with the SNP axis contiguous, so every mma.sync fragment register is one
// conflict-free 32-bit shared load. The planes (K16) or the basis (K8) are
// formed from the code bytes in registers with a few bitwise operations,
// so they never exist in memory, and all grams come from the same
// fragments through mma.sync.m16n8k32 (s8 x s8 -> s32). The epilogue adds
// the tile into the carry; each tile has one owner, so no atomics. Moving
// K16 and K8 onto csrc/gram5.cu's body (wgmma, operands decoded once a
// stage into shared memory, cp.async ring), as K1 did, is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;      // samples per output-tile side
constexpr int BK = 128;       // SNPs per shared-memory stage
constexpr int LDS = BK + 16;  // padded row stride (bytes): 36 words, so the
                              // 8 rows x 4 words of a fragment hit 32 banks
constexpr int THREADS = 256;  // 8 warps: 2 (rows) x 4 (columns), 32 x 16 each

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four genotype codes, one per byte (0..3, 3 = missing) -> the V, H and D
// bytes of the same four genotypes (int8; D is -1 as 0xFF).
__device__ __forceinline__ void basis(uint32_t w, uint32_t &v, uint32_t &h,
                                      uint32_t &d) {
  const uint32_t ones = 0x01010101u;
  const uint32_t lo = w & ones, hi = (w >> 1) & ones;
  v = ones ^ (lo & hi);             // code != 3
  h = lo & ~hi;                     // code == 1
  const uint32_t two = hi & ~lo;    // code == 2 -> +1
  const uint32_t zero = ones ^ (lo | hi);  // code == 0 -> -1
  d = two | (zero * 0xFFu);         // 0/1 bytes times 255: no carries
}

// Four genotype codes -> the one-hot plane bytes I0, I1 and I2 of the
// same four genotypes (missing: all three 0).
__device__ __forceinline__ void planes(uint32_t w, uint32_t &p0,
                                       uint32_t &p1, uint32_t &p2) {
  const uint32_t ones = 0x01010101u;
  const uint32_t lo = w & ones, hi = (w >> 1) & ones;
  p0 = ones ^ (lo | hi);  // code == 0
  p1 = lo & ~hi;          // code == 1
  p2 = hi & ~lo;          // code == 2
}

__device__ __forceinline__ uint32_t lds32(const uint8_t *p) {
  return *reinterpret_cast<const uint32_t *>(p);
}

constexpr int NG = 6;  // K16's grams

// The plane grams I0'I0, I0'I1, I0'I2, I1'I1, I1'I2, I2'I2 of one 64 x 64
// tile (rows from sample i0 of pa, columns from sample j0 of pb, two
// (S, B) packed chunks that may be the same) over the whole chunk, into
// acc (av, ah and ad hold the planes 0, 1 and 2). Called by all THREADS
// threads of the block.
__device__ __forceinline__ void tile_grams(const uint8_t *__restrict__ pa,
                                           const uint8_t *__restrict__ pb,
                                           int S, int B, int i0, int j0,
                                           uint8_t (&sm)[2][TILE][LDS],
                                           int (&acc)[NG][2][2][4]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;

  // Stage fill: thread -> (side, SNP quad q, 16-sample word column wc).
  // It reads 4 packed words (4 SNPs x 16 samples) and writes 16 words of
  // 4 code bytes (one sample x 4 SNPs) into its side's tile.
  const int side = tid >> 7, q = lane, wc = warp & 3;
  const uint8_t *src = (side ? pb + (j0 >> 2) : pa + (i0 >> 2)) + 4 * wc;
  uint8_t *dst = &sm[side][16 * wc][4 * q];

#pragma unroll
  for (int x = 0; x < NG; ++x)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int f = 0; f < 4; ++f) acc[x][m][n][f] = 0;

  for (int k0 = 0; k0 < S; k0 += BK) {
    uint32_t w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int s = k0 + 4 * q + r;
      w[r] = s < S ? __ldg(reinterpret_cast<const uint32_t *>(
                         src + (size_t)s * B))
                   : 0xFFFFFFFFu;  // past the chunk: missing
    }
    __syncthreads();  // the previous stage's fragments are consumed
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int sh = 2 * j;
      const uint32_t c = ((w[0] >> sh) & 3u) | (((w[1] >> sh) & 3u) << 8) |
                         (((w[2] >> sh) & 3u) << 16) |
                         (((w[3] >> sh) & 3u) << 24);
      *reinterpret_cast<uint32_t *>(dst + j * LDS) = c;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t av[2][4], ah[2][4], ad[2][4], bv[2][2], bh[2][2], bd[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint8_t *p = &sm[0][wm * 32 + m * 16 + g][kk + 4 * t];
        planes(lds32(p), av[m][0], ah[m][0], ad[m][0]);
        planes(lds32(p + 8 * LDS), av[m][1], ah[m][1], ad[m][1]);
        planes(lds32(p + 16), av[m][2], ah[m][2], ad[m][2]);
        planes(lds32(p + 8 * LDS + 16), av[m][3], ah[m][3], ad[m][3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const uint8_t *p = &sm[1][wn * 16 + n * 8 + g][kk + 4 * t];
        planes(lds32(p), bv[n][0], bh[n][0], bd[n][0]);
        planes(lds32(p + 16), bv[n][1], bh[n][1], bd[n][1]);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          mma_s8(acc[0][m][n], av[m], bv[n]);  // I0'I0
          mma_s8(acc[1][m][n], av[m], bh[n]);  // I0'I1
          mma_s8(acc[2][m][n], av[m], bd[n]);  // I0'I2
          mma_s8(acc[3][m][n], ah[m], bh[n]);  // I1'I1
          mma_s8(acc[4][m][n], ah[m], bd[n]);  // I1'I2
          mma_s8(acc[5][m][n], ad[m], bd[n]);  // I2'I2
        }
    }
  }
}

// Epilogue: gram x of the tile += acc[x] in place, the tile's first row at
// row r0 of a carry whose grams are `plane` entries apart with row stride
// ld. Fragment f sits at row g (+8 for f >= 2) and column 2t + (f & 1) of
// its 16 x 8 mma tile.
__device__ __forceinline__ void add_tile(int *__restrict__ carry,
                                         long long plane, long long ld,
                                         long long r0, long long c0,
                                         const int (&acc)[NG][2][2][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int x = 0; x < NG; ++x)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const long long r = r0 + wm * 32 + m * 16 + g;
        const long long c = c0 + wn * 16 + n * 8 + 2 * t;
        int2 *p = reinterpret_cast<int2 *>(carry + x * plane + r * ld + c);
        int2 v = p[0];
        v.x += acc[x][m][n][0];
        v.y += acc[x][m][n][1];
        p[0] = v;
        int2 *p8 = reinterpret_cast<int2 *>(carry + x * plane + (r + 8) * ld + c);
        v = p8[0];
        v.x += acc[x][m][n][2];
        v.y += acc[x][m][n][3];
        p8[0] = v;
      }
}

// K16: block (x, y) owns rows 64y and columns 64x of all six plane grams.
__global__ void __launch_bounds__(THREADS)
gram6_kernel(const uint8_t *__restrict__ packed, int S, int B,
             int *__restrict__ carry) {
  __shared__ __align__(16) uint8_t sm[2][TILE][LDS];  // [row|col side][sample][snp]
  const long long N = 4LL * B;
  const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  int acc[NG][2][2][4];  // [gram][m tile][n tile][fragment]
  tile_grams(packed, packed, S, B, i0, j0, sm, acc);
  add_tile(carry, N * N, N, i0, j0, acc);
}

// K8: block (x, y) owns cohort samples 64x.. and queries QT y.., QT = 8 NF.
// Warp w owns cohort rows 16w.. of the tile and all NF n8 fragments.
template <int NF>
__global__ void __launch_bounds__(128)
gram5_cross_kernel(const uint8_t *__restrict__ packed, int S, int B,
                   const uint8_t *__restrict__ query, int q_rows, long long ldq,
                   int Sq, int *__restrict__ carry) {
  constexpr int QT = 8 * NF;
  __shared__ __align__(16) uint8_t sc[TILE][LDS];  // cohort [sample][snp]
  __shared__ __align__(16) uint8_t sq[QT][LDS];    // query [query][snp]
  const long long N = 4LL * B;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * TILE, q0 = blockIdx.y * QT;

  // cohort fill, as K16's: thread -> (SNP quad lane, 16-sample word warp)
  const uint8_t *src = packed + (i0 >> 2) + 4 * warp;
  uint8_t *dst = &sc[16 * warp][4 * lane];

  int acc[5][NF][4];
#pragma unroll
  for (int x = 0; x < 5; ++x)
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int f = 0; f < 4; ++f) acc[x][n][f] = 0;
  for (int k0 = 0; k0 < S; k0 += BK) {
    uint32_t w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int s = k0 + 4 * lane + r;
      w[r] = s < S ? __ldg(reinterpret_cast<const uint32_t *>(
                         src + (size_t)s * B))
                   : 0xFFFFFFFFu;  // past the chunk: missing
    }
    // query fill: QT rows x 32 words of 4 SNP codes, byte loads (the
    // query slice has no alignment), missing past Sq and q_rows
    uint32_t qw[QT / 4];
#pragma unroll
    for (int i = 0; i < QT / 4; ++i) {
      const int slot = tid + 128 * i, row = slot >> 5, col = 4 * (slot & 31);
      const int qr = q0 + row;
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int s = k0 + col + b;
        uint32_t c = 3u;
        if (qr < q_rows && s < Sq) {
          c = __ldg(query + (size_t)qr * ldq + s);
          c = c > 3u ? 3u : c;
        }
        word |= c << (8 * b);
      }
      qw[i] = word;
    }
    __syncthreads();  // the previous stage's fragments are consumed
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int sh = 2 * j;
      const uint32_t c = ((w[0] >> sh) & 3u) | (((w[1] >> sh) & 3u) << 8) |
                         (((w[2] >> sh) & 3u) << 16) |
                         (((w[3] >> sh) & 3u) << 24);
      *reinterpret_cast<uint32_t *>(dst + j * LDS) = c;
    }
#pragma unroll
    for (int i = 0; i < QT / 4; ++i) {
      const int slot = tid + 128 * i;
      *reinterpret_cast<uint32_t *>(&sq[slot >> 5][4 * (slot & 31)]) = qw[i];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t av[4], ah[4], ad[4];
      const uint8_t *p = &sc[16 * warp + g][kk + 4 * t];
      basis(lds32(p), av[0], ah[0], ad[0]);
      basis(lds32(p + 8 * LDS), av[1], ah[1], ad[1]);
      basis(lds32(p + 16), av[2], ah[2], ad[2]);
      basis(lds32(p + 8 * LDS + 16), av[3], ah[3], ad[3]);
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        uint32_t bv[2], bh[2], bd[2];
        const uint8_t *pq = &sq[8 * n + g][kk + 4 * t];
        basis(lds32(pq), bv[0], bh[0], bd[0]);
        basis(lds32(pq + 16), bv[1], bh[1], bd[1]);
        mma_s8(acc[0][n], av, bv);  // Qv'V
        mma_s8(acc[1][n], ah, bh);  // Qh'H
        mma_s8(acc[2][n], ad, bd);  // Qd'D
        mma_s8(acc[3][n], av, bh);  // Qh'V
        mma_s8(acc[4][n], ah, bv);  // Qv'H
      }
    }
  }

  // epilogue: fragment f of n8 tile n is cohort row g (+8 for f >= 2) and
  // query 2t + (f & 1); carry[x][query][sample] += it
  const long long plane = (long long)q_rows * N;
  const long long r = i0 + 16 * warp + g;
#pragma unroll
  for (int n = 0; n < NF; ++n)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int qr = q0 + 8 * n + 2 * t + (f & 1);
      if (qr < q_rows) {
        int *p = carry + (long long)qr * N + r + 8 * (f >> 1);
#pragma unroll
        for (int x = 0; x < 5; ++x) p[x * plane] += acc[x][n][f];
      }
    }
}

}  // namespace

// packed: (S, B) uint8, B % 16 == 0; carry: (6, 4B, 4B) int32, the plane
// grams in _SYM_PAIRS order, updated in place. Launches on `stream`;
// returns cudaGetLastError().
extern "C" int gram6_launch(const void *packed, int S, int B, void *carry,
                            void *stream) {
  const int tiles = 4 * B / TILE;
  if (tiles > 0 && S > 0)
    gram6_kernel<<<dim3(tiles, tiles), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t *>(packed), S, B, static_cast<int *>(carry));
  return static_cast<int>(cudaGetLastError());
}

// packed: (S, B) uint8, B % 16 == 0 (the cohort chunk); query: q_rows rows
// of code bytes with row stride ldq, of which the first Sq <= S columns are
// read; carry: (5, q_rows, 4B) int32, updated in place. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int gram5_cross_launch(const void *packed, int S, int B,
                                  const void *query, int q_rows,
                                  long long ldq, int Sq, void *carry,
                                  void *stream) {
  const int tiles = 4 * B / TILE;
  if (tiles > 0 && q_rows > 0 && S > 0) {
    const auto *pk = static_cast<const uint8_t *>(packed);
    const auto *qy = static_cast<const uint8_t *>(query);
    auto *cr = static_cast<int *>(carry);
    const auto st = static_cast<cudaStream_t>(stream);
    if (q_rows <= 8)
      gram5_cross_kernel<1><<<dim3(tiles, 1), 128, 0, st>>>(
          pk, S, B, qy, q_rows, ldq, Sq, cr);
    else if (q_rows <= 16)
      gram5_cross_kernel<2><<<dim3(tiles, 1), 128, 0, st>>>(
          pk, S, B, qy, q_rows, ldq, Sq, cr);
    else
      gram5_cross_kernel<4><<<dim3(tiles, (q_rows + 31) / 32), 128, 0,
                                 st>>>(pk, S, B, qy, q_rows, ldq, Sq, cr);
  }
  return static_cast<int>(cudaGetLastError());
}
