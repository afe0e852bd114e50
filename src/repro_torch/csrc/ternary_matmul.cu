// Dense ternary matmul for NVIDIA Hopper (sm_90a): out[B,N] = x[B,K] @ w[K,N]
// with int8 weights in {-1,0,+1} and float32 accumulation.  Plain C
// interface, loaded with ctypes by repro_torch/kernels/ternary_matmul.py.
//
// Replaces the TPU kernel `ternary_matmul_pallas`
// (src/repro/kernels/ternary_matmul.py; body `_ternary_matmul_kernel`), the
// Pallas form of the ideal digital reference `ideal_ternary_matmul`.  Its
// plain PyTorch version is repro_torch/kernels/ref.py::ternary_matmul_ref.
// x is float32 or bfloat16 (widened to float32 on load); the weights stay
// int8 in device memory, one byte each, and are widened in shared memory.
//
// What bounds it on the H100: 2*B*K*N operations against reading x once,
// the weights once and writing the f32 output once (3.35 TB/s).  With
// {0,1} x every partial sum is an integer below 2^24, exact in f32 in any
// order, so the result is bit-identical to any other f32 product, and the
// tensor cores (TF32, 495 TFLOP/s) would sum it exactly: at the detector's
// s0 product (B=294,912, K=540, N=60) the 0.708 GB of bytes, 0.211 ms,
// bound it.  Other f32 x needs true f32, the FFMA pipes (67 TFLOP/s): the
// same shape's 19.1 GFLOP take 0.285 ms there.
//
// This first design is a shared-memory tiled FFMA GEMM:
//   * a thread block owns a 64x64 output tile; 256 threads, thread (ty, tx)
//     owns rows ty + 16*i and columns tx + 16*j (i, j < 4), so reads of the
//     weight tile are conflict-free and stores are 64-byte runs;
//   * it walks K in 32-deep steps, staging the x tile transposed (padded by
//     one column, so the transposing store is conflict-free) and the
//     widened weight tile in shared memory; each staged value feeds four
//     FFMAs;
//   * ragged B, K and N are masked here; the caller pads nothing.
// Faster designs (tensor cores, which sum the {0,1} x ternary products
// exactly; TMA and a pipelined K walk; a split over K for small B) are
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // output rows per thread block
constexpr int kBN = 64;        // output columns per thread block
constexpr int kBK = 32;        // K step staged in shared memory
constexpr int kLanes = 16;     // 16 x 16 threads, 4 x 4 outputs each
constexpr int kT = 4;
constexpr int kThreads = kLanes * kLanes;

template <bool kBf16>
__device__ __forceinline__ float load_x(const void* x, long long i) {
  if constexpr (kBf16) {
    const uint32_t bits = static_cast<const uint16_t*>(x)[i];
    return __uint_as_float(bits << 16);
  } else {
    return static_cast<const float*>(x)[i];
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
ternary_matmul_kernel(const void* __restrict__ x,
                      const int8_t* __restrict__ w, float* __restrict__ out,
                      int B, int K, int N) {
  __shared__ float s_x[kBK][kBM + 1];
  __shared__ float s_w[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % kLanes;
  const int ty = tid / kLanes;
  const long long row0 = (long long)blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;

  float acc[kT][kT];
#pragma unroll
  for (int i = 0; i < kT; ++i)
#pragma unroll
    for (int j = 0; j < kT; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // a warp reads 32 consecutive elements of one row of x
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, kk = e % kBK;
      const long long b = row0 + r;
      const int k = k0 + kk;
      s_x[kk][r] = (b < B && k < K) ? load_x<kBf16>(x, b * K + k) : 0.0f;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int kk = e / kBN, nn = e % kBN;
      const int k = k0 + kk, n = col0 + nn;
      s_w[kk][nn] = (k < K && n < N)
                        ? static_cast<float>(w[(long long)k * N + n])
                        : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kT], v[kT];
#pragma unroll
      for (int i = 0; i < kT; ++i) a[i] = s_x[kk][ty + kLanes * i];
#pragma unroll
      for (int j = 0; j < kT; ++j) v[j] = s_w[kk][tx + kLanes * j];
#pragma unroll
      for (int i = 0; i < kT; ++i)
#pragma unroll
        for (int j = 0; j < kT; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const long long b = row0 + ty + kLanes * i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const int n = col0 + tx + kLanes * j;
      if (n < N) out[b * N + n] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int ternary_matmul_launch(const void* x, const void* w, void* out,
                                     int B, int K, int N, int x_bf16,
                                     void* stream) {
  if (B <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto fw = static_cast<const int8_t*>(w);
  auto fout = static_cast<float*>(out);
  if (x_bf16)
    ternary_matmul_kernel<true><<<grid, kThreads, 0, st>>>(x, fw, fout, B, K,
                                                           N);
  else
    ternary_matmul_kernel<false><<<grid, kThreads, 0, st>>>(x, fw, fout, B,
                                                            K, N);
  return (int)cudaGetLastError();
}
