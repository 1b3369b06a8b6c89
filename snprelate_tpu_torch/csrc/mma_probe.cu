// A probe of Hopper's tensor-core shapes (no kernel of the port): the
// float64 mma.sync m8n8k4 (Ampere's) and m16n8k4, m16n8k8, m16n8k16 (sm_90)
// that K3a rand_h and K3b rand_yt use; the TF32 shape m16n8k8 .tf32
// (float32 accumulate) of K2b norm_gram's 3xTF32 float gram, with its
// cvt.rna.tf32.f32 split; and the int8 shapes (s8 x s8 -> s32):
// mma.sync m16n8k32 (K2b's count gram) and wgmma m64n64k32 and m64n128k32
// with both operands in shared memory, and with A from registers (K1, K1r
// gram5_rows and K1t gram5_tile: csrc/wgmma_s8.cuh) m64n64k32 and
// m64n128k32, m64n96k32 (K16 gram6) and m64n32k32 and m64n16k32 (K8
// gram5_cross's 16-query tile).
//
// Mode 0 checks a shape's fragment layout: one warp loads A (M x K) and
// B (K x N), both row-major, into fragments by the layout K3a rand_h and
// K3b rand_yt assume, multiplies from zero and stores D (M x N) by the
// same layout; the caller compares D with A B. The layout, with
// g = lane / 4 and t = lane % 4:
//   a[2j + h] = A[g + 8h][t + 4j]   (m8n8k4: a[0] = A[g][t])
//   b[j]      = B[t + 4j][g]
//   d[2h + e] = D[g + 8h][2t + e]
// Mode 1 times the shape's issue rate: every warp of `blocks` blocks of
// 256 threads runs `iters` rounds of eight independent products on
// register operands, and each thread writes its sum to out (so nothing is
// optimised away). 2 M N K flop per product. The TF32 shape takes float32
// operands (A (16, 8), B (8, 8), D (16, 8)), each rounded to TF32 with
// cvt.rna in mode 0, and has the same fragment layout; its mode 2 splits
// `iters` floats a[i] into out[2i] = tf32(a[i]) and
// out[2i + 1] = tf32(a[i] - out[2i]), as norm_gram's table does.
//
// The int8 shapes take A (M x K) and B' (N x K), both K-major int8, and
// give D = A B (int32). mma.sync m16n8k32 (K = 32): a[2i + h] = the 4
// bytes A[g + 8h][16i + 4t ..], b[i] = B'[g][16i + 4t ..], d as above. The
// wgmma shapes (M = 64, K = 128: four k32 products from one 128-byte
// swizzled row, the descriptor advanced 32 bytes each) write A and B' into
// shared memory with wg::sw128 and read D by the accumulator layout of
// csrc/wgmma_s8.cuh, one warpgroup. Their mode 1 runs two warpgroups a
// block of 256 threads, each issuing four products a round on 128
// accumulator registers, one commit group a round with one group left in
// flight.
//
//   python3 chip_smoke.py --mma-probe

#include <cstdint>
#include <cuda_runtime.h>

#include "wgmma_s8.cuh"

namespace {

template <int M, int K>
__device__ __forceinline__ void mma(double (&d)[M / 4], const double *a,
                                    const double *b) {
  if constexpr (M == 8) {
    asm volatile(
        "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
        "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
        : "+d"(d[0]), "+d"(d[1])
        : "d"(a[0]), "d"(b[0]));
  } else if constexpr (K == 4) {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  } else if constexpr (K == 8) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, "
        "{%0,%1,%2,%3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
          "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
  }
}

template <int M, int K>
__global__ void layout(const double *A, const double *B, double *D) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  double a[M == 8 ? K / 4 : K / 2], b[K / 4];
  for (int j = 0; j < K / 4; ++j) {
    b[j] = B[(t + 4 * j) * 8 + g];
    for (int h = 0; h < M / 8; ++h)
      a[(M / 8) * j + h] = A[(g + 8 * h) * K + t + 4 * j];
  }
  double d[M / 4] = {};
  mma<M, K>(d, a, b);
  for (int h = 0; h < M / 8; ++h)
    for (int e = 0; e < 2; ++e) D[(g + 8 * h) * 8 + 2 * t + e] = d[2 * h + e];
}

template <int M, int K>
__global__ void __launch_bounds__(256) rate(const double *A, int iters,
                                            double *out) {
  double a[M == 8 ? K / 4 : K / 2], b[K / 4];
  for (int i = 0; i < (M == 8 ? K / 4 : K / 2); ++i) a[i] = A[i];
  for (int i = 0; i < K / 4; ++i) b[i] = A[16 + i];
  double d[8][M / 4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int r = 0; r < 8; ++r) mma<M, K>(d[r], a, b);
  double s = 0.0;
  for (int r = 0; r < 8; ++r)
    for (int e = 0; e < M / 4; ++e) s += d[r][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned *a,
                                         const unsigned *b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void layout_tf32(const float *A, const float *B, float *D) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  unsigned a[4], b[2];
  for (int j = 0; j < 2; ++j) {
    b[j] = tf32(B[(t + 4 * j) * 8 + g]);
    for (int h = 0; h < 2; ++h)
      a[2 * j + h] = tf32(A[(g + 8 * h) * 8 + t + 4 * j]);
  }
  float d[4] = {};
  mma_tf32(d, a, b);
  for (int h = 0; h < 2; ++h)
    for (int e = 0; e < 2; ++e) D[(g + 8 * h) * 8 + 2 * t + e] = d[2 * h + e];
}

__global__ void __launch_bounds__(256) rate_tf32(const float *A, int iters,
                                                 float *out) {
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = tf32(A[i]);
  for (int i = 0; i < 2; ++i) b[i] = tf32(A[16 + i]);
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int r = 0; r < 8; ++r) mma_tf32(d[r], a, b);
  float s = 0.f;
  for (int r = 0; r < 8; ++r)
    for (int e = 0; e < 4; ++e) s += d[r][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void split_tf32(const float *x, int n, float *out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const unsigned hi = tf32(x[i]);
    out[2 * i] = __uint_as_float(hi);
    out[2 * i + 1] = __uint_as_float(tf32(x[i] - __uint_as_float(hi)));
  }
}

// ------------------------------------------------------------------ int8

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t word(const int8_t *p) {
  return static_cast<uint32_t>(static_cast<uint8_t>(p[0])) |
         (static_cast<uint32_t>(static_cast<uint8_t>(p[1])) << 8) |
         (static_cast<uint32_t>(static_cast<uint8_t>(p[2])) << 16) |
         (static_cast<uint32_t>(static_cast<uint8_t>(p[3])) << 24);
}

// A (16, 32), B' (8, 32) -> D (16, 8)
__global__ void layout_s8(const int8_t *A, const int8_t *Bt, int *D) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t a[4], b[2];
  for (int i = 0; i < 2; ++i) {
    b[i] = word(Bt + g * 32 + 16 * i + 4 * t);
    for (int h = 0; h < 2; ++h)
      a[2 * i + h] = word(A + (g + 8 * h) * 32 + 16 * i + 4 * t);
  }
  int d[4] = {};
  mma_s8(d, a, b);
  for (int h = 0; h < 2; ++h)
    for (int e = 0; e < 2; ++e) D[(g + 8 * h) * 8 + 2 * t + e] = d[2 * h + e];
}

__global__ void __launch_bounds__(256) rate_s8(const int8_t *A, int iters,
                                               int *out) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = word(A + 4 * i);
  for (int i = 0; i < 2; ++i) b[i] = word(A + 16 + 4 * i);
  int d[8][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int r = 0; r < 8; ++r) mma_s8(d[r], a, b);
  int s = 0;
  for (int r = 0; r < 8; ++r)
    for (int e = 0; e < 4; ++e) s += d[r][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// 1,024-aligned shared memory for a 64 x 128 A tile and an N x 128 B' tile
template <int N>
struct WgTiles {
  uint8_t raw[1024 + 64 * 128 + N * 128];
  __device__ uint8_t *a() {
    return raw + ((1024u - (wg::smem_addr(raw) & 1023u)) & 1023u);
  }
  __device__ uint8_t *b() { return a() + 64 * 128; }
};

// A (64, 128), B' (N, 128) -> D (64, N), one warpgroup; RS: A's fragments
// from registers.
template <int N, bool RS>
__global__ void __launch_bounds__(128) layout_wg(const int8_t *A,
                                                 const int8_t *Bt, int *D) {
  __shared__ WgTiles<N> sm;
  uint8_t *sa = sm.a(), *sb = sm.b();
  const int tid = threadIdx.x;
  for (int i = tid; i < 64 * 128; i += 128)
    sa[wg::sw128(i >> 7, i & 127)] = static_cast<uint8_t>(A[i]);
  for (int i = tid; i < N * 128; i += 128)
    sb[wg::sw128(i >> 7, i & 127)] = static_cast<uint8_t>(Bt[i]);
  wg::fence_proxy_async();
  __syncthreads();
  const int w = tid >> 5, l = tid & 31;
  int d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0;
  uint32_t a[4][4] = {};
  if constexpr (RS)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          a[kk][2 * i + h] = word(A + (16 * w + l / 4 + 8 * h) * 128 +
                                  32 * kk + 16 * i + 4 * (l % 4));
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = wg::desc(wg::smem_addr(sb) + 32 * kk);
    if constexpr (RS) {
      wg::mma_rs<N>(d, a[kk], db);
    } else {
      const uint64_t da = wg::desc(wg::smem_addr(sa) + 32 * kk);
      if constexpr (N == 64)
        wg::mma_n64(d, da, db);
      else
        wg::mma_n128(d, da, db);
    }
  }
  wg::commit();
  wg::wait<0>();
  wg::keep(d);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        D[(16 * w + l / 4 + 8 * h) * N + 8 * j + 2 * (l % 4) + e] =
            d[4 * j + 2 * h + e];
}

// Two warpgroups a block, each four products a round (n64: four 32-register
// accumulators; n128: two of 64), one commit group a round, one left in
// flight.
template <int N, bool RS>
__global__ void __launch_bounds__(256) rate_wg(const int8_t *A, int iters,
                                               int *out) {
  __shared__ WgTiles<N> sm;
  uint8_t *sa = sm.a(), *sb = sm.b();
  for (int i = threadIdx.x; i < (64 + N) * 128; i += 256)
    sa[i] = static_cast<uint8_t>(A[i & 31]);  // sa, then sb, contiguous
  wg::fence_proxy_async();
  __syncthreads();
  constexpr int NACC = N == 64 ? 4 : 2;  // accumulators a warpgroup
  int d[NACC][N / 2];
#pragma unroll
  for (int r = 0; r < NACC; ++r)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) d[r][i] = 0;
  uint32_t a[4];
  for (int i = 0; i < 4; ++i) a[i] = word(A + 4 * i);
  const uint32_t sa0 = wg::smem_addr(sa), sb0 = wg::smem_addr(sb);
  wg::fence();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = wg::desc(sb0 + 32 * kk);
      if constexpr (RS)
        wg::mma_rs<N>(d[kk % NACC], a, db);
      else if constexpr (N == 64)
        wg::mma_n64(d[kk % NACC], wg::desc(sa0 + 32 * kk), db);
      else
        wg::mma_n128(d[kk % NACC], wg::desc(sa0 + 32 * kk), db);
    }
    wg::commit();
    wg::wait<1>();
  }
  wg::wait<0>();
  int s = 0;
#pragma unroll
  for (int r = 0; r < NACC; ++r) {
    wg::keep(d[r]);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) s += d[r][i];
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// shape 5 m16n8k32 (mma.sync), 6 wgmma n64, 7 wgmma n128, 8 wgmma n64 and
// 9 wgmma n128 with A from registers, then with A from registers 10 n96
// (K16 gram6), 11 n32 and 12 n16 (K8 gram5_cross's 16-query tile)
void run_s8(int shape, int mode, const int8_t *a, const int8_t *b, int *out,
            int iters, int blocks, cudaStream_t st) {
  if (shape == 5 && mode == 0)
    layout_s8<<<1, 32, 0, st>>>(a, b, out);
  else if (shape == 5)
    rate_s8<<<blocks, 256, 0, st>>>(a, iters, out);
  else if (shape == 6 && mode == 0)
    layout_wg<64, false><<<1, 128, 0, st>>>(a, b, out);
  else if (shape == 6)
    rate_wg<64, false><<<blocks, 256, 0, st>>>(a, iters, out);
  else if (shape == 7 && mode == 0)
    layout_wg<128, false><<<1, 128, 0, st>>>(a, b, out);
  else if (shape == 7)
    rate_wg<128, false><<<blocks, 256, 0, st>>>(a, iters, out);
  else if (shape == 8 && mode == 0)
    layout_wg<64, true><<<1, 128, 0, st>>>(a, b, out);
  else if (shape == 8)
    rate_wg<64, true><<<blocks, 256, 0, st>>>(a, iters, out);
  else if (shape == 9 && mode == 0)
    layout_wg<128, true><<<1, 128, 0, st>>>(a, b, out);
  else if (shape == 9)
    rate_wg<128, true><<<blocks, 256, 0, st>>>(a, iters, out);
  else if (shape == 10 && mode == 0)
    layout_wg<96, true><<<1, 128, 0, st>>>(a, b, out);
  else if (shape == 10)
    rate_wg<96, true><<<blocks, 256, 0, st>>>(a, iters, out);
  else if (shape == 11 && mode == 0)
    layout_wg<32, true><<<1, 128, 0, st>>>(a, b, out);
  else if (shape == 11)
    rate_wg<32, true><<<blocks, 256, 0, st>>>(a, iters, out);
  else if (mode == 0)
    layout_wg<16, true><<<1, 128, 0, st>>>(a, b, out);
  else
    rate_wg<16, true><<<blocks, 256, 0, st>>>(a, iters, out);
}

template <int M, int K>
void run(int mode, const void *a, const void *b, void *out, int iters,
         int blocks, cudaStream_t st) {
  if (mode == 0)
    layout<M, K><<<1, 32, 0, st>>>(static_cast<const double *>(a),
                                   static_cast<const double *>(b),
                                   static_cast<double *>(out));
  else
    rate<M, K><<<blocks, 256, 0, st>>>(static_cast<const double *>(a), iters,
                                       static_cast<double *>(out));
}

}  // namespace

// shape: 0 m8n8k4, 1 m16n8k4, 2 m16n8k8, 3 m16n8k16 (float64), 4 m16n8k8
// .tf32; int8: 5 m16n8k32 (mma.sync), 6 wgmma m64n64k32, 7 wgmma
// m64n128k32 (shared-memory operands), 8 wgmma m64n64k32, 9 wgmma
// m64n128k32, 10 m64n96k32, 11 m64n32k32 and 12 m64n16k32 (A from
// registers). mode 0: a (M, K), b (K, 8) row-major
// in, out (M, 8); int8: a (M, K) and b = B' (N, K) int8, out (M, N)
// int32; mode 1: a holds at least 32 values, out blocks * 256 values
// (int32 for int8); mode 2 (shape 4): a holds `iters` floats, out
// 2 * iters. float64 for shapes 0-3, float32 for shape 4. Returns
// cudaGetLastError().
extern "C" int mma_probe_launch(int shape, int mode, const void *a,
                                const void *b, void *out, int iters,
                                int blocks, void *stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fa = static_cast<const float *>(a);
  float *fo = static_cast<float *>(out);
  if (shape >= 5)
    run_s8(shape, mode, static_cast<const int8_t *>(a),
           static_cast<const int8_t *>(b), static_cast<int *>(out), iters,
           blocks, st);
  else if (shape == 4 && mode == 0)
    layout_tf32<<<1, 32, 0, st>>>(fa, static_cast<const float *>(b), fo);
  else if (shape == 4 && mode == 1)
    rate_tf32<<<blocks, 256, 0, st>>>(fa, iters, fo);
  else if (shape == 4)
    split_tf32<<<(iters + 255) / 256, 256, 0, st>>>(fa, iters, fo);
  else if (shape == 0)
    run<8, 4>(mode, a, b, out, iters, blocks, st);
  else if (shape == 1)
    run<16, 4>(mode, a, b, out, iters, blocks, st);
  else if (shape == 2)
    run<16, 8>(mode, a, b, out, iters, blocks, st);
  else
    run<16, 16>(mode, a, b, out, iters, blocks, st);
  return static_cast<int>(cudaGetLastError());
}
