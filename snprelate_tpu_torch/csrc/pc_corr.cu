// K7 pc_corr: fused 2-bit decode + the pairwise-complete Pearson
// correlation of every SNP of one packed chunk with every eigenvector, on
// the float64 tensor cores.
//
// Replaces snprelate_tpu/ops/loadings.py:_corr_step (SNP_PC_Corr,
// genPCA.cpp:820-842). For one packed chunk (S, N/4) and the eigenvectors
// E (N, K) float64 (zero rows past the samples), it writes corr (S, K)
// float64: over the valid calls of SNP s, with g the genotype and v = 1,
//   xy = sum g e_k, x = sum v e_k, xx = sum v e_k^2,
//   y = sum g, yy = sum g^2, m = the number of valid calls,
//   corr = (xy - x y / m) / sqrt((xx - x^2 / m) (yy - y^2 / m)),
// NaN where m <= 1 or the product under the root is not positive (the JAX
// step's rule, loadings.py:92-97).
//
// What bounds it on the card: float64 operations, 3 * 2 * S * N * K (three
// products against E), against S * N / 4 bytes of packed input and N * K *
// 8 bytes of E. At S = 4,096, N = 100,096, K = 32 that is 7.9e10 flop
// against 0.13 GB: 1.17 ms at the 67 TFLOP/s of the float64 tensor cores,
// the only float64 rate that reaches it.
//
// Design (K3a rand_h's, the shared parts in rand_mma.cuh): every product
// is an mma.sync.m16n8k8 .f64. A block owns 128 SNP rows x 32 columns of
// the three products, G E, V E and V (E∘E), and one slice of the sample
// axis, which it walks in 64-sample stages double-buffered with cp.async:
// the rows' packed bytes (128 x 16) and the stage's rows of E (64 x 32
// float64, rows padded so a fragment load takes the least wavefronts). G
// and V never exist in memory: a lane's A fragment holds rows g + 8h at
// samples t + 4j, so per 32 samples it reads each of its rows' 8 bytes once
// (a 64-bit shared load) and turns code c into g (0, 1, 2, 0) and v (1, 1,
// 1, 0) with one multiply-add and two byte permutes that pick the doubles'
// high words from constants (no table, no conversion). E∘E is squared in
// registers from E's B fragments, one multiply a fragment element for the
// four products it feeds, so it needs neither a second (N, K) operand in
// memory nor a squaring pass over the shared stage. Each warp owns 16
// rows x 16 columns of the tile in all three products (24 accumulators, 48
// registers), so the block's 16 warps stay within 128 registers a thread
// (ptxas: 120, no spills) and fill the SM; the block has the SM to itself
// (one block an SM). A 32 x 16 warp tile (8 warps of 206 registers, two
// products a fragment of B) was 1 % slower on the card and is gone.
// y, yy and m are integer counts of the same 64-bit words by popcount (the
// first column warps of column tile 0), exact in float64, so c2 = yy -
// y^2 / m is formed from exact values as the plain version forms it (a
// monomorphic SNP gives exactly 0, hence NaN, on both). The sample axis
// is cut into slices (ops/kernels.py corr_plan: the fewest that keep the
// card's SMs 90 % busy); each block writes its partial sums to scratch and
// pc_corr_finish adds the slices in slice order and forms the correlation
// with the JAX step's operations. No atomics: a second launch gives the
// same bits.

#include "rand_mma.cuh"

namespace {

using namespace rand_mma;

constexpr int BN = 32;         // columns of a block tile
constexpr int WM = 16;         // SNP rows of a warp tile: one m16 product
constexpr int WN = 16;         // columns of a warp tile
constexpr int NTW = WN / KS;   // 8-column products of a warp tile: 2
constexpr int THREADS = 32 * (BM / WM) * (BN / WN);         // 512
constexpr int LDB = Tile<BN>::LDB;
constexpr int C_BYTES = BM * BK / 4;                        // 2,048
constexpr int SMEM = STAGES * (Tile<BN>::B_BYTES + C_BYTES);  // 45,056

// Code c (0-3) -> g (0, 1, 2, 0) and v (1, 1, 1, 0) as doubles: a byte
// permute picks each one's high word, bytes 2c and 2c + 1 of a constant
// pair, above a zero byte twice; the low words are 0.
__device__ __forceinline__ void decode_gv(uint32_t c, double &g, double &v) {
  const uint32_t sel = 0x1077u + 0x2200u * c;
  g = __hiloint2double(static_cast<int>(
                           __byte_perm(0x3FF00000u, 0x00004000u, sel)), 0);
  v = __hiloint2double(static_cast<int>(
                           __byte_perm(0x3FF03FF0u, 0x00003FF0u, sel)), 0);
}

// One row's 8 codes of slot t (bits 8i and 8i + 1 of w) into its counts:
// y += #1 + 2 #2, yy += #1 + 4 #2, m += #valid.
__device__ __forceinline__ void count(uint64_t w, int &y, int &yy, int &m) {
  const uint64_t ones = 0x0101010101010101ull;
  const uint64_t lo = w & ones, hi = (w >> 1) & ones;
  const int n1 = __popcll(lo & ~hi), n2 = __popcll(hi & ~lo);
  y += n1 + 2 * n2;
  yy += n1 + 4 * n2;
  m += 8 - __popcll(lo & hi);
}

// Block (x, y, z): SNP rows s0 = 128 x .., columns c0 = 32 y .. of E, the
// samples [z slice_len, (z + 1) slice_len). part[z] (3, S, K) = the
// slice's G E, V E and V (E∘E); spart[z] (3, S) = its y, yy and m (written
// by column tile 0).
__global__ void __launch_bounds__(THREADS, 1)
pc_corr_part(const uint8_t *__restrict__ packed, int S, int B,
             const double *__restrict__ e, int K, bool vec, int slice_len,
             double *__restrict__ part, double *__restrict__ spart) {
  extern __shared__ __align__(16) uint8_t sm[];
  double *bs = reinterpret_cast<double *>(sm);     // [STAGES][BK][LDB]
  uint8_t *cs = sm + STAGES * Tile<BN>::B_BYTES;   // [STAGES][BM][BK / 4]
  const int N = 4 * B;
  const int s0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
  const int i_begin = blockIdx.z * slice_len;
  const int nst = (min(N, i_begin + slice_len) - i_begin) / BK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % (BM / WM), wn = warp / (BM / WM);
  const int gq = lane >> 2, t = lane & 3;
  const int rbase = WM * wm + gq;  // the lane's rows: rbase + 8 h

  auto load_stage = [&](int it) {
    const int st = it % STAGES, i0 = i_begin + it * BK;
    load_operand<BN, THREADS>(bs + st * BK * LDB, e, i0, N, K, c0, vec);
    for (int r = tid; r < BM; r += THREADS) {
      const int s = s0 + r;
      cp16(cs + (st * BM + r) * (BK / 4),
           s < S ? packed + (size_t)s * B + i0 / 4 : packed, s < S ? 16 : 0);
    }
  };
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) {
    if (it < nst) load_stage(it);
    commit();
  }

  double xy[NTW][4] = {}, x[NTW][4] = {}, xx[NTW][4] = {};
  int y[2] = {}, yy[2] = {}, m[2] = {};
  const bool stats = wn == 0 && blockIdx.y == 0;
  for (int it = 0; it < nst; ++it) {
    wait<STAGES - 2>();
    __syncthreads();  // stage it has landed; stage it - 1 is consumed
    if (it + STAGES - 1 < nst) load_stage(it + STAGES - 1);
    commit();
    const int st = it % STAGES;
    const double *b_st = bs + st * BK * LDB;
    const uint8_t *c_st = cs + st * BM * (BK / 4);
#pragma unroll
    for (int q = 0; q < BK / 32; ++q) {  // 32 samples: 8 bytes of a row
      uint64_t w[2];  // the lane's rows' bytes, shifted to slot t
#pragma unroll
      for (int h = 0; h < 2; ++h)
        w[h] = *reinterpret_cast<const uint64_t *>(
                   c_st + (rbase + 8 * h) * (BK / 4) + 8 * q) >> (2 * t);
      if (stats) {
#pragma unroll
        for (int h = 0; h < 2; ++h) count(w[h], y[h], yy[h], m[h]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // samples 8 kk + t + 4 j
        double b[NTW][2], b2[NTW][2];
        load_b<BN, NTW>(b, b_st, 4 * q + kk, WN * wn, gq, t);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) b2[nt][j] = b[nt][j] * b[nt][j];
        double ag[4], av[4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            decode_gv(static_cast<uint32_t>(w[h] >> (8 * (2 * kk + j))) & 3u,
                      ag[2 * j + h], av[2 * j + h]);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          mma(xy[nt], ag, b[nt]);
          mma(x[nt], av, b[nt]);
          mma(xx[nt], av, b2[nt]);
        }
      }
    }
  }

  const size_t z = blockIdx.z;
  if (stats) {  // a row's four slots are lanes t
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int a = y[h], b = yy[h], c = m[h];
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        b += __shfl_xor_sync(0xffffffffu, b, o);
        c += __shfl_xor_sync(0xffffffffu, c, o);
      }
      const int s = s0 + rbase + 8 * h;
      if (t == 0 && s < S) {
        double *sp = spart + z * 3 * S;
        sp[s] = (double)a;
        sp[(size_t)S + s] = (double)b;
        sp[2 * (size_t)S + s] = (double)c;
      }
    }
  }

  const size_t plane = (size_t)S * K;
  double *out = part + z * 3 * plane;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = s0 + rbase + 8 * h;
    if (r >= S) continue;
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int col = c0 + WN * wn + 8 * nt + 2 * t + f;
        if (col >= K) continue;
        const size_t o = (size_t)r * K + col;
        out[o] = xy[nt][2 * h + f];
        out[plane + o] = x[nt][2 * h + f];
        out[2 * plane + o] = xx[nt][2 * h + f];
      }
  }
}

// corr[s, k] from the slices' partials, added in slice order.
__global__ void pc_corr_finish(const double *__restrict__ part,
                               const double *__restrict__ spart, int nslice,
                               int S, int K, double *__restrict__ corr) {
  const long long len = (long long)S * K;
  for (long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       q < len; q += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(q / K);
    double sxy = 0.0, sx = 0.0, sxx = 0.0, y = 0.0, yy = 0.0, m = 0.0;
    for (int z = 0; z < nslice; ++z) {
      const double *p = part + (size_t)z * 3 * len;
      sxy += p[q];
      sx += p[len + q];
      sxx += p[2 * len + q];
      const double *sp = spart + (size_t)z * 3 * S;
      y += sp[r];
      yy += sp[S + r];
      m += sp[2 * S + r];
    }
    double out = __longlong_as_double(0x7ff8000000000000LL);  // NaN
    if (m > 1.0) {
      const double c1 = sxx - sx * sx / m;
      const double c2 = yy - y * y / m;
      const double val = c1 * c2;
      if (val > 0.0) out = (sxy - sx * y / m) / sqrt(val);
    }
    corr[q] = out;
  }
}

}  // namespace

// packed: (S, B) uint8, B % 16 == 0; e: (4B, K) float64; slice_len:
// samples per slice, a multiple of 64 (ops/kernels.py:corr_plan); part:
// scratch of nslice * 3 * S * K float64 and spart of nslice * 3 * S float64
// (nslice = ceil(4B / slice_len)); corr: (S, K) float64, written (NaN
// throughout when B is 0). Launches on `stream`; returns the CUDA error (0
// on success).
extern "C" int pc_corr_launch(const void *packed, int S, int B,
                              const void *e, int K, int slice_len,
                              void *part, void *spart, void *corr,
                              void *stream) {
  if (S > 0 && K > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int nslice = B > 0 ? (4 * B + slice_len - 1) / slice_len : 0;
    if (nslice > 0) {
      const cudaError_t err = cudaFuncSetAttribute(
          pc_corr_part, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
      if (err != cudaSuccess) return static_cast<int>(err);
      const bool vec =
          K % 2 == 0 && reinterpret_cast<uintptr_t>(e) % 16 == 0;
      pc_corr_part<<<dim3((S + BM - 1) / BM, (K + BN - 1) / BN, nslice),
                     THREADS, SMEM, st>>>(
          static_cast<const uint8_t *>(packed), S, B,
          static_cast<const double *>(e), K, vec, slice_len,
          static_cast<double *>(part), static_cast<double *>(spart));
    }
    const long long len = (long long)S * K;
    const long long blocks = (len + 255) / 256;
    pc_corr_finish<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(
        static_cast<const double *>(part),
        static_cast<const double *>(spart), nslice, S, K,
        static_cast<double *>(corr));
  }
  return static_cast<int>(cudaGetLastError());
}
