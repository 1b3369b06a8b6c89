// A probe of Hopper's float64 tensor-core shapes (no kernel of the port):
// mma.sync m8n8k4 (Ampere's) and m16n8k4, m16n8k8, m16n8k16 (sm_90).
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
// optimised away). 2 M N K flop per product.
//
//   python3 chip_smoke.py --mma-probe

#include <cuda_runtime.h>

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

// shape: 0 m8n8k4, 1 m16n8k4, 2 m16n8k8, 3 m16n8k16. mode 0: a (M, K),
// b (K, 8) row-major float64 in, out (M, 8); mode 1: a holds at least 20
// float64, out blocks * 256 float64. Returns cudaGetLastError().
extern "C" int mma_probe_launch(int shape, int mode, const void *a,
                                const void *b, void *out, int iters,
                                int blocks, void *stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (shape == 0)
    run<8, 4>(mode, a, b, out, iters, blocks, st);
  else if (shape == 1)
    run<16, 4>(mode, a, b, out, iters, blocks, st);
  else if (shape == 2)
    run<16, 8>(mode, a, b, out, iters, blocks, st);
  else
    run<16, 16>(mode, a, b, out, iters, blocks, st);
  return static_cast<int>(cudaGetLastError());
}
