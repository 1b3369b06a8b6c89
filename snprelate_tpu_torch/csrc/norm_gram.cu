// K2b norm_gram: fused 2-bit decode + normalization + covariance gram, with
// the GCTA valid-and-polymorphic count gram on request; its strip mode
// norm_gram_rows and its tile mode norm_gram_tile.
//
// Replaces snprelate_tpu/ops/pairwise.py:_pca_step (make_pca_block ->
// _sym_blocks) and _gcta_step, and the float grams of _king_homo_step and
// _eigmix_step. For one packed SNP chunk and its per-SNP avg/scale (from
// snp_stats) it adds X'X into a float64 (N, N) carry, where
//   x[s, i] = (g - avg[s]) * scale[s] for a valid call, 0 for a missing one
// (mean imputation, then centering), or, in indicator mode,
//   x[s, i] = scale[s] for a valid call, 0 for a missing one,
// so X'X = sum_s scale[s]^2 v_i v_j, the allele-frequency-weighted validity
// grams of KING-homo and EIGMIX. With a count carry (GCTA) it also adds the
// int32 gram of vp[s, i] = valid[s, i] and poly[s].
//
// The strip mode replaces _gcta_rows_step and _pca_rows_step
// (snprelate_tpu/ops/pairwise.py:806, :821) and the float strips of
// _king_homo_rows_step and _eigmix_rows_step (:1090, :1141): for the sample
// rows [row0, row0 + R) it adds X_r'X into a float64 (R, N) carry (and the
// count gram into an int32 (R, N) carry), every tile of the rectangle
// computed, none mirrored.
//
// The tile mode replaces _gcta_tile_scan_c (snprelate_tpu/ops/tiles.py:241)
// and the float grams of _eigmix_tile_scan_c and _king_homo_tile_scan_c
// (:886, :1035): X_i'X_j of two packed sample-group slabs (S, g/4) of one
// super tile, every tile of the (g, g) square computed, added into a
// float64 (g, g) carry (and the count gram into an int32 one). With
// `divide` set (GCTA) the epilogue then replaces each entry by
// carry / (2 vcarry), the per-pair missing denominator applied on the card
// as the JAX scan does, so only the finished GRM tile leaves it. The
// caller splits a tile past 2^24 SNPs into launches below it and divides
// on the last.
//
// What bounds it on the card: float32 operations, S*N*(N+1) for the
// symmetric gram (and as many again for the GCTA count gram), against
// S*N/4 bytes of input and the carries read and written once per chunk.
//
// Design: X'X and the count gram are symmetric, so only the tiles on and
// above the diagonal are computed: one block owns one 64 x 64 upper output
// tile, adds it into the carry at its place and, transposed, at its mirror
// place below the diagonal; blocks of lower tiles return at once. In strip
// mode a block owns one tile of the rectangle and adds it at its place. A
// block
// streams the chunk in 32-SNP stages. Each stage decodes its packed words
// and normalizes in registers (x in double, rounded once to float), so the
// normalized block
// never exists in device memory, and stores float tiles in shared memory
// with the sample axis contiguous. Each thread accumulates a 4 x 4 block of
// products with float32 FMAs over one stage, then adds the stage's sums
// into float64 registers, and those into the float64 carry in the
// epilogue: float32 sums stay 32 terms long whatever the chunk length,
// where sums over a whole chunk lose accuracy with its length (PERF.md has
// the measured errors of both). Products x_i x_j and x_j x_i are summed in
// the same order within a diagonal tile and the mirrored tiles are copies,
// so the result is exactly symmetric. The count gram is summed as 0/1
// floats, exact below 2^24 SNPs per chunk, and converted to int32 in the
// epilogue. Tensor cores (3xTF32 or FP64 MMA) are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;      // samples per output-tile side
constexpr int BK = 32;        // SNPs per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

enum Mode { SQUARE, ROWS, TILES };

// SQUARE: the upper triangle of the square (row0 = 0, pb = pa). ROWS: the
// strip mode, block (x, y) owning rows row0 + 64y of the packed chunk and
// columns 64x, at row 64y of the carry (pb = pa). TILES: block (x, y) owning
// rows 64y of pa and columns 64x of pb, every tile (row0 = 0); `divide`
// (with GCTA) ends with carry / (2 vcarry).
template <bool GCTA, Mode MODE>
__global__ void __launch_bounds__(THREADS)
norm_gram_kernel(const uint8_t *__restrict__ pa, const uint8_t *__restrict__ pb,
                 int S, int B, int row0, const double *__restrict__ avg,
                 const double *__restrict__ scale,
                 const bool *__restrict__ poly, int indicator,
                 double *__restrict__ carry, int *__restrict__ vcarry,
                 int divide) {
  __shared__ __align__(16) float xs[2][BK][TILE];  // [row|col side][snp][sample]
  __shared__ __align__(16) float vs[GCTA ? 2 : 1][GCTA ? BK : 1][TILE];

  // a lower tile of the square: written by its mirror
  if (MODE == SQUARE && blockIdx.x < blockIdx.y) return;
  const long long N = 4LL * B;
  const int r0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  const int i0 = row0 + r0;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  // Stage fill: thread -> (side, SNP sr, 16-sample word column wc).
  const int side = tid >> 7, sr = (tid & 127) >> 2, wc = tid & 3;
  const uint8_t *src = (side ? pb + (j0 >> 2) : pa + (i0 >> 2)) + 4 * wc;

  double sum[4][4];
  float cnt[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      sum[a][b] = 0.0;
      cnt[a][b] = 0.f;
    }

  for (int k0 = 0; k0 < S; k0 += BK) {
    const int s = k0 + sr;
    uint32_t w = 0xFFFFFFFFu;  // past the chunk: missing
    double m = 0.0, sc = 0.0;
    bool pl = false;
    if (s < S) {
      w = __ldg(reinterpret_cast<const uint32_t *>(src + (size_t)s * B));
      m = avg[s];
      sc = scale[s];
      if constexpr (GCTA) pl = poly[s];
    }
    __syncthreads();  // the previous stage is consumed
    float x[16], v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t c = (w >> (2 * j)) & 3u;
      x[j] = c != 3u ? (float)(indicator ? sc : ((double)c - m) * sc) : 0.f;
      v[j] = (c != 3u && pl) ? 1.f : 0.f;
    }
    float4 *xd = reinterpret_cast<float4 *>(&xs[side][sr][16 * wc]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      xd[j] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
    if constexpr (GCTA) {
      float4 *vd = reinterpret_cast<float4 *>(&vs[side][sr][16 * wc]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        vd[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    }
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float4 ra = *reinterpret_cast<const float4 *>(&xs[0][k][4 * ty]);
      const float4 cb = *reinterpret_cast<const float4 *>(&xs[1][k][4 * tx]);
      const float r[4] = {ra.x, ra.y, ra.z, ra.w};
      const float c[4] = {cb.x, cb.y, cb.z, cb.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(r[a], c[b], acc[a][b]);
      if constexpr (GCTA) {
        const float4 rv = *reinterpret_cast<const float4 *>(&vs[0][k][4 * ty]);
        const float4 cv = *reinterpret_cast<const float4 *>(&vs[1][k][4 * tx]);
        const float p[4] = {rv.x, rv.y, rv.z, rv.w};
        const float q[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) cnt[a][b] = fmaf(p[a], q[b], cnt[a][b]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) sum[a][b] += (double)acc[a][b];
  }

  // Epilogue: carries += tile and, off the diagonal of the square, their
  // mirror tiles += its transpose (in place); each pair of tiles has one
  // owner. In TILES mode with `divide`, the GRM entry replaces the sum.
  const bool mirror = MODE == SQUARE && i0 != j0;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const long long r = r0 + 4 * ty + a, c = j0 + 4 * tx + b;
      const double total = carry[r * N + c] + sum[a][b];
      if (mirror) carry[c * N + r] += sum[a][b];
      if constexpr (GCTA) {
        const int v = vcarry[r * N + c] + __float2int_rn(cnt[a][b]);
        vcarry[r * N + c] = v;
        if (mirror) vcarry[c * N + r] += __float2int_rn(cnt[a][b]);
        carry[r * N + c] = (MODE == TILES && divide)
                               ? total / (2.0 * (double)v) : total;
      } else {
        carry[r * N + c] = total;
      }
    }
}

template <Mode MODE>
int launch(const void *pa, const void *pb, int S, int B, int row0, int rows,
           const void *avg, const void *scale, const void *poly,
           int indicator, void *carry, void *vcarry, int divide,
           void *stream) {
  const int tiles = 4 * B / TILE;
  const dim3 grid(tiles, rows / TILE);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t *p = static_cast<const uint8_t *>(pa);
  const uint8_t *q = static_cast<const uint8_t *>(pb);
  const double *a = static_cast<const double *>(avg);
  const double *s = static_cast<const double *>(scale);
  if (rows <= 0 || tiles <= 0) return static_cast<int>(cudaGetLastError());
  if (vcarry)
    norm_gram_kernel<true, MODE><<<grid, THREADS, 0, st>>>(
        p, q, S, B, row0, a, s, static_cast<const bool *>(poly), indicator,
        static_cast<double *>(carry), static_cast<int *>(vcarry), divide);
  else
    norm_gram_kernel<false, MODE><<<grid, THREADS, 0, st>>>(
        p, q, S, B, row0, a, s, nullptr, indicator,
        static_cast<double *>(carry), nullptr, 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// packed: (S, B) uint8, B % 16 == 0, S < 2^24; avg, scale: (S,) float64;
// indicator: 0 or 1 (x = scale on valid calls; avg is then unused);
// carry: (4B, 4B) float64, updated in place. With vcarry (4B, 4B) int32
// (GCTA) it also needs poly (S,) bool and adds the count gram into vcarry
// in place; with vcarry null, poly is not read. Launches on `stream`;
// returns cudaGetLastError().
extern "C" int norm_gram_launch(const void *packed, int S, int B,
                                const void *avg, const void *scale,
                                const void *poly, int indicator, void *carry,
                                void *vcarry, void *stream) {
  return launch<SQUARE>(packed, packed, S, B, 0, 4 * B, avg, scale, poly,
                        indicator, carry, vcarry, 0, stream);
}

// The strip mode: as norm_gram_launch, with carry (rows, 4B) float64 and
// vcarry (rows, 4B) int32 (or null) holding the sample rows
// [row0, row0 + rows); row0 and rows multiples of 64, row0 + rows <= 4B.
extern "C" int norm_gram_rows_launch(const void *packed, int S, int B,
                                     int row0, int rows, const void *avg,
                                     const void *scale, const void *poly,
                                     int indicator, void *carry, void *vcarry,
                                     void *stream) {
  return launch<ROWS>(packed, packed, S, B, row0, rows, avg, scale, poly,
                      indicator, carry, vcarry, 0, stream);
}

// The tile mode: slab_i, slab_j (S, B) uint8 each (may be the same
// pointer), the other arguments as norm_gram_launch with carry (4B, 4B)
// float64 and vcarry (4B, 4B) int32 (or null) holding the rows of slab_i
// against the columns of slab_j. divide: 1 (needs vcarry) to end with
// carry = carry / (2 vcarry) entrywise.
extern "C" int norm_gram_tile_launch(const void *slab_i, const void *slab_j,
                                     int S, int B, const void *avg,
                                     const void *scale, const void *poly,
                                     int indicator, void *carry, void *vcarry,
                                     int divide, void *stream) {
  return launch<TILES>(slab_i, slab_j, S, B, 0, 4 * B, avg, scale, poly,
                      indicator, carry, vcarry, divide, stream);
}
