// A probe of Hopper's float64 tensor-core shapes (no kernel of the port):
// mma.sync m8n8k4 (Ampere's) and m16n8k4, m16n8k8, m16n8k16 (sm_90); and of
// the TF32 shape m16n8k8 .tf32 (float32 accumulate) that K2b norm_gram's
// 3xTF32 float gram uses, with its cvt.rna.tf32.f32 split.
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
// .tf32. mode 0: a (M, K), b (K, 8) row-major in, out (M, 8); mode 1: a
// holds at least 20 values, out blocks * 256 values; mode 2 (shape 4): a
// holds `iters` floats, out 2 * iters. float64 for shapes 0-3, float32 for
// shape 4. Returns cudaGetLastError().
extern "C" int mma_probe_launch(int shape, int mode, const void *a,
                                const void *b, void *out, int iters,
                                int blocks, void *stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fa = static_cast<const float *>(a);
  float *fo = static_cast<float *>(out);
  if (shape == 4 && mode == 0)
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
