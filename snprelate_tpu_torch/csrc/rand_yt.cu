// K3b rand_yt: fused 2-bit decode + randomized-PCA normalization + thin
// transposed product, carry += Y' M, of one packed SNP chunk or
// sample-group slab, on the float64 tensor cores.
//
// Replaces snprelate_tpu/models/pca_randomized.py:_g_step and the G part of
// _power_pass (G_next += Y' H), _t_step / _t_pass (T += U_H' Y, kept here
// transposed as T' += Y' U_H), and the slab route's g_accum and t_accum
// (pca_randomized.py:325,415) and the rank PCA's W_r = Y_r' H_r. For packed
// rows (S, N/4), their per-SNP avg/scale and M (S, c) float64, it adds Y' M
// into a float64 (N, c) carry in place, where
//   y[s, i] = (g - avg[s]) * scale[s] for a valid call, 0 for a missing one.
// c is k (aux_dim) for the power passes, hsize = k (iter_num + 1) for the
// projection pass and the number of PCs for the sample loadings.
//
// What bounds it on the card: float64 operations, 2*S*N*c, against S*N/4
// bytes of packed input, S*c*8 bytes of M and 2*N*c*8 bytes of carry read
// and written. At S = 4096, N = 100,096 that is 5.2e10 flop for c = 64 and
// 5.8e11 flop for c = 704: 0.78 and 8.6 ms at the 67 TFLOP/s of the
// float64 tensor cores.
//
// Design (the shared parts in rand_mma.cuh): every product is an
// mma.sync.m16n8k8 .f64 (the card's full float64 tensor rate; m8n8k4 gets
// half of it) with A = Y' (samples x SNPs). A block owns 128 samples x BN
// columns of the carry (BN = 32 for c <= 32, so the sample loadings'
// c = 32 does no masked work; else 64: c = 320 and 704 are whole 64-wide
// tiles, and a 128-wide tile of 16 warps measured slower at c = 704) and
// one slice of the SNP axis, which it walks in 64-SNP stages, double
// buffered with cp.async: per stage the SNPs' packed bytes of the block's
// samples (64 x 32 bytes), their rows of the decode table (four float64 per
// SNP, (0, 1, 2 - avg) * scale and 0, formed once per call by decode_table:
// the plain version's doubles) and their rows of M (64 x BN float64, rows
// padded so a fragment load takes the least wavefronts). Y never exists in
// memory. The fragment rows are mapped to samples so that a lane's four
// rows (two products of 16 rows, g and g + 8) are the four samples of one
// code byte, 4g + 2mt + h of its warp's 32: per SNP the lane reads one
// byte and looks its four codes up in one table row, in registers (no
// float64 shared tile, no extra barrier); the epilogue writes each row back
// to its sample. Ragged edges are zero-filled by the copies: SNPs past the
// slice (table rows 0, so y = 0), samples past N (N = 4B is only sure to
// be a multiple of 64) and columns past c; the epilogue writes only rows
// below N and columns below c. Blocks of one slice are adjacent in the
// grid (row tiles fastest), so they read that slice of M from L2 together.
// At the full 100k width the sample axis gives 782 row tiles, enough to
// fill the card with one slice, and the epilogue adds the tile straight
// into the carry. Few samples (a 7,936-sample slab gives 62 row tiles) cut
// the SNP axis into slices (ops/kernels.py rand_plan: the fewest that keep
// the resident blocks 90 % busy): each block writes its slice's partial
// tile to a scratch buffer and a second kernel adds the slices in slice
// order into the carry. No atomics either way, so repeated runs are
// bitwise equal.
//
// What holds it at about 60-65 % of the tensor rate: as rand_h, 128
// registers a thread (two blocks of 8 warps an SM), so each 8-deep step
// waits on its shared loads (two code bytes, eight table lookups and eight
// M fragments a warp for eight products); at c = 704 every one of the 11
// column tiles decodes the codes again.

#include "rand_mma.cuh"

namespace {

using namespace rand_mma;

template <int BN>
constexpr int smem_bytes() {
  return STAGES * (Tile<BN>::B_BYTES + BK * 4 * 8 + BK * BM / 4);
}

// Block z sums the SNPs [z * slice_len, (z + 1) * slice_len). part null:
// carry += the tile; else part[z] = the tile.
template <int BN>
__global__ void __launch_bounds__(Tile<BN>::THREADS, Tile<BN>::MIN_BLOCKS)
rand_yt_part(const uint8_t *__restrict__ packed, int S, int B,
             const double *__restrict__ table, const double *__restrict__ m,
             int c, bool vec, int slice_len, double *__restrict__ carry,
             double *__restrict__ part) {
  using T = Tile<BN>;
  extern __shared__ __align__(16) uint8_t sm[];
  double *bs = reinterpret_cast<double *>(sm);  // [STAGES][BK][LDB]
  double *ts = bs + STAGES * BK * T::LDB;       // [STAGES][BK][4]
  uint8_t *cs = reinterpret_cast<uint8_t *>(ts + STAGES * BK * 4);
                                                // [STAGES][BK][BM / 4]
  const int N = 4 * B;
  const int i0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * slice_len;
  const int k_end = min(S, k_begin + slice_len);
  const int nst = (k_end - k_begin + BK - 1) / BK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2, gq = lane >> 2, t = lane & 3;
  const int cb = 8 * wm + gq;  // the lane's code byte in a stage row

  auto load_stage = [&](int it) {
    const int st = it % STAGES, k0 = k_begin + it * BK;
    load_operand<BN>(bs + st * BK * T::LDB, m, k0, k_end, c, c0, vec);
    for (int e = tid; e < BK * 4; e += T::THREADS) {
      const int r = (e >> 1) & (BK - 1), half = e & 1, s = k0 + r;
      if (e < BK * 2) {  // the table row: two 16-byte halves
        cp16(ts + (st * BK + r) * 4 + 2 * half,
             s < k_end ? table + 4 * (size_t)s + 2 * half : table,
             s < k_end ? 16 : 0);
      } else {  // the block's 32 code bytes of SNP s, as two 16-byte copies
        const int off = i0 / 4 + 16 * half;
        const bool ok = s < k_end && off < B;
        cp16(cs + (st * BK + r) * (BM / 4) + 16 * half,
             ok ? packed + (size_t)s * B + off : packed, ok ? 16 : 0);
      }
    }
  };
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) {
    if (it < nst) load_stage(it);
    commit();
  }

  double acc[MT][NT][4] = {};
  for (int it = 0; it < nst; ++it) {
    wait<STAGES - 2>();
    __syncthreads();  // stage it has landed; stage it - 1 is consumed
    if (it + STAGES - 1 < nst) load_stage(it + STAGES - 1);
    commit();
    const int st = it % STAGES;
    const double *b_st = bs + st * BK * T::LDB;
    const double *t_st = ts + st * BK * 4;
    const uint8_t *c_st = cs + st * BK * (BM / 4);
#pragma unroll
    for (int kk = 0; kk < BK / KS; ++kk) {
      double a[MT][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ks = KS * kk + t + 4 * j;  // the lane's SNP of the stage
        const uint32_t w = c_st[ks * (BM / 4) + cb];
        const double *tr = t_st + ks * 4;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            a[mt][2 * j + h] = tr[(w >> (2 * (2 * mt + h))) & 3u];
      }
      double b[NT][2];
      load_b<BN>(b, b_st, kk, 32 * wn, gq, t);
      product(acc, a, b);
    }
  }

  // Epilogue: carry += tile (in place; each entry has one owner), or the
  // slice's partial into part[z]. Fragment row g + 8h of product mt is
  // sample 4g + 2mt + h of the warp's 32.
  double *out = part == nullptr ? carry : part + (size_t)blockIdx.z * N * c;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + 32 * wm + 4 * gq + 2 * mt + h;
      if (i >= N) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 32 * wn + 8 * nt + 2 * t + e;
          if (col >= c) continue;
          const double v = acc[mt][nt][2 * h + e];
          if (part == nullptr)
            out[(size_t)i * c + col] += v;
          else
            out[(size_t)i * c + col] = v;
        }
    }
}

template <int BN>
void launch(dim3 grid, cudaStream_t st, const uint8_t *packed, int S, int B,
            const double *table, const double *m, int c, bool vec,
            int slice_len, double *carry, double *part) {
  constexpr int bytes = smem_bytes<BN>();
  cudaFuncSetAttribute(rand_yt_part<BN>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  rand_yt_part<BN><<<grid, Tile<BN>::THREADS, bytes, st>>>(
      packed, S, B, table, m, c, vec, slice_len, carry, part);
}

}  // namespace

// packed: (S, B) uint8, B % 16 == 0; avg, scale: (S,) float64; m: (S, c)
// float64; width: columns per block tile (32 or 64); table: scratch
// of 4S float64 (the decode table); carry: (4B, c) float64 += Y' M, the
// SNP axis cut into slices of slice_len (a multiple of 64) and added in
// slice order. part: scratch of nslice * 4B * c float64, unused (may be
// null) with one slice (slice_len >= S). Launches on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for another width).
extern "C" int rand_yt_launch(const void *packed, int S, int B,
                              const void *avg, const void *scale,
                              const void *m, int c, int width, int slice_len,
                              void *table, void *part, void *carry,
                              void *stream) {
  if (c > 0 && B > 0 && S > 0) {
    if (width != 32 && width != 64)
      return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    rand_mma::table(avg, scale, S, table, st);
    const int nslice = (S + slice_len - 1) / slice_len;
    const dim3 grid((4 * B + rand_mma::BM - 1) / rand_mma::BM,
                    (c + width - 1) / width, nslice);
    double *p = nslice > 1 ? static_cast<double *>(part) : nullptr;
    const bool vec = c % 2 == 0 && reinterpret_cast<uintptr_t>(m) % 16 == 0;
    const auto *pk = static_cast<const uint8_t *>(packed);
    const auto *tb = static_cast<const double *>(table);
    const auto *md = static_cast<const double *>(m);
    double *cd = static_cast<double *>(carry);
    if (width == 32)
      launch<32>(grid, st, pk, S, B, tb, md, c, vec, slice_len, cd, p);
    else
      launch<64>(grid, st, pk, S, B, tb, md, c, vec, slice_len, cd, p);
    if (p != nullptr)
      rand_mma::reduce(p, nslice, (long long)4 * B * c, cd, st);
  }
  return static_cast<int>(cudaGetLastError());
}
