// Elementwise float32 math in XLA's CPU rounding, for NVIDIA Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// repro_torch/kernels/xla_math.py.
//
// No TPU kernel stands behind these: the JAX package leaves this math to
// XLA, which fuses it into the die sampling (`jax.random.normal`'s erf_inv,
// the device-variation mask's exp, `src/repro/core/nonideal.py`) and into
// the oracle's epilogue (`a * b + c` contracted into one fused multiply-add).
// The port reproduces XLA CPU's bits (repro_torch/xla_order.py), whose plain
// PyTorch versions emulate each fused multiply-add in float64 with a
// round-to-odd fix: about ten elementwise passes each, and tens of them per
// normal drawn.  These kernels compute the same functions in one pass each,
// op for op in the plain versions' order:
//   * xla_fma:     out = a * b + c rounded once (`__fmaf_rn`), a, b and c
//                  broadcast tensors (up to kMaxDims axes, any strides) or
//                  scalars; plain version xla_order.fma_plain;
//   * xla_erf_inv: out = scale * erf_inv(x), XLA's float32 erf_inv with
//                  XLA CPU's log1p and a correctly rounded sqrt; plain
//                  version xla_order.erf_inv_plain;
//   * xla_exp:     out = exp(x), XLA CPU's float32 exp; plain version
//                  xla_order.exp_plain.
// Every add, multiply, divide and square root is an explicit `__f*_rn`
// intrinsic, so nvcc contracts nothing on its own, and nothing is built
// with fast math, so subnormals are kept (the flushes of XLA's log1p and
// exp are written out, as in the plain versions).  The result is
// bit-identical to the plain versions for every non-NaN input.
//
// What bounds them on the H100: bytes.  Each reads its inputs once and
// writes its output once (3.35 TB/s); the ~60 flops of erf_inv per element
// take ~1/10 of that time at the FFMA rate.  Each thread handles one
// element per step of a grid-stride loop; broadcast operands of xla_fma are
// read through their strides, so nothing is expanded in device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDims = 8;
constexpr int kMaxBlocks = 132 * 16;

// operand modes of xla_fma
constexpr int kScalar = 0;
constexpr int kContiguous = 1;
constexpr int kStrided = 2;

struct FmaArgs {
  const float* ptr[3];
  float scalar[3];
  int mode[3];
  int ndim;
  long long size[kMaxDims];
  long long stride[3][kMaxDims];
};

__global__ void __launch_bounds__(kThreads)
xla_fma_kernel(FmaArgs a, float* __restrict__ out, long long n) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    long long off[3] = {i, i, i};
    if (a.mode[0] == kStrided || a.mode[1] == kStrided ||
        a.mode[2] == kStrided) {
      long long rem = i;
      off[0] = off[1] = off[2] = 0;
      for (int d = a.ndim - 1; d >= 0; --d) {
        const long long idx = rem % a.size[d];
        rem /= a.size[d];
#pragma unroll
        for (int k = 0; k < 3; ++k) off[k] += idx * a.stride[k][d];
      }
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (a.mode[k] == kContiguous) off[k] = i;
    }
    float v[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      v[k] = a.mode[k] == kScalar ? a.scalar[k] : a.ptr[k][off[k]];
    out[i] = __fmaf_rn(v[0], v[1], v[2]);
  }
}

constexpr float kFltMin = 0x1p-126f;

// XLA CPU's float32 log: log(m * 2^e), m in [sqrt(1/2), sqrt(2)), as a
// degree-9 polynomial in z = m - 1 in three interleaved Horner chains
__device__ __forceinline__ float xla_log(float y) {
  constexpr float kP[9] = {
      0x1.204376p-4f,  -0x1.d7a37p-4f,  -0x1.fcba9ep-4f,
      0x1.23d37ep-3f,  0x1.999d58p-3f,  -0x1.fffff8p-3f,
      0x1.de4a34p-4f,  -0x1.555ca0p-3f, 0x1.555554p-2f};
  constexpr float kSqrtHalf = 0x1.6a09e6p-1f;
  constexpr float kLn2Lo = -0x1.bd0106p-13f;
  constexpr float kLn2Hi = 0x1.63p-1f;
  const float ym = y > kFltMin ? y : kFltMin;
  const int bits = __float_as_int(ym);
  float e = (float)((bits >> 23) - 127);
  const float m = __int_as_float((bits & 0x7FFFFF) | 0x3F000000);
  const bool low = m < kSqrtHalf;
  e = __fsub_rn(__fadd_rn(e, 1.0f), low ? 1.0f : 0.0f);
  const float z = __fadd_rn(__fsub_rn(m, 1.0f), low ? m : 0.0f);
  const float z2 = __fmul_rn(z, z);
  const float z3 = __fmul_rn(z2, z);
  const float a = __fmaf_rn(__fmaf_rn(z, kP[0], kP[1]), z, kP[6]);
  const float b = __fmaf_rn(__fmaf_rn(z, kP[2], kP[3]), z, kP[7]);
  const float c = __fmaf_rn(__fmaf_rn(z, kP[4], kP[5]), z, kP[8]);
  const float t = __fmaf_rn(__fmaf_rn(__fmaf_rn(a, z3, b), z3, c), z3,
                            __fmul_rn(e, kLn2Lo));
  float r = __fmaf_rn(e, kLn2Hi, __fadd_rn(__fmaf_rn(-z2, 0.5f, z), t));
  if (y <= 0.0f) r = __int_as_float(0x7FC00000);
  if (y == 0.0f) r = -INFINITY;
  if (y == INFINITY) r = y;
  return r;
}

// XLA CPU's float32 log1p: x - x^2/2 + x^3 P(x)/Q(x) below
// |x| = sqrt(2) - 1, log(1 + x) above; subnormal x flushed to zero
__device__ __forceinline__ float xla_log1p(float x) {
  constexpr float kQ[7] = {1.0f,           0x1.e2035ap+3f, 0x1.4c30b6p+6f,
                           0x1.bb865ap+7f, 0x1.351946p+8f, 0x1.b0db14p+7f,
                           0x1.e0f304p+5f};
  constexpr float kPp[7] = {0x1.7bc096p-15f, 0x1.fe818ap-2f, 0x1.a509f4p+2f,
                            0x1.de9738p+4f,  0x1.e798ecp+5f, 0x1.c8e75ap+5f,
                            0x1.40a202p+4f};
  constexpr float kSmall = 0x1.a8279ap-2f;
  if (fabsf(x) < kFltMin) x = __fmul_rn(x, 0.0f);
  const float zero = __fmul_rn(x, 0.0f);
  float q = __fadd_rn(zero, kQ[0]);
#pragma unroll
  for (int i = 1; i < 7; ++i) q = __fmaf_rn(q, x, kQ[i]);
  float p = __fadd_rn(zero, kPp[0]);
#pragma unroll
  for (int i = 1; i < 7; ++i) p = __fmaf_rn(p, x, kPp[i]);
  const float x2 = __fmul_rn(x, x);
  const float small = __fadd_rn(
      x, __fmaf_rn(x2, -0.5f, __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(p, q))));
  return fabsf(x) < kSmall ? small : xla_log(__fadd_rn(x, 1.0f));
}

// XLA's float32 erf_inv (Giles' single-precision polynomial), each Horner
// step one fused multiply-add
__device__ __forceinline__ float xla_erf_inv(float x) {
  constexpr float kLt5[9] = {
      0x1.e2cb1p-26f,  0x1.70966cp-22f,  -0x1.d8e6aep-19f,
      -0x1.26b582p-18f, 0x1.ca65b6p-13f, -0x1.48a81p-10f,
      -0x1.11c9dep-8f, 0x1.f91ec6p-3f,   0x1.805c5ep+0f};
  constexpr float kGt5[9] = {
      -0x1.a3e136p-13f, 0x1.a76ad6p-14f, 0x1.61b8e4p-10f,
      -0x1.e17bcep-9f,  0x1.7824f6p-8f,  -0x1.f38baep-8f,
      0x1.354afcp-7f,   0x1.006db6p+0f,  0x1.6a9efcp+1f};
  float w = -xla_log1p(__fmul_rn(x, -x));
  const bool small = w < 5.0f;
  w = small ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = small ? kLt5[0] : kGt5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, w, small ? kLt5[i] : kGt5[i]);
  return fabsf(x) == 1.0f ? __fmul_rn(x, INFINITY) : __fmul_rn(p, x);
}

// XLA CPU's float32 exp (Cephes' expf): x = n ln2 + r, e^r a degree-7
// polynomial, results below FLT_MIN flushed to zero
__device__ __forceinline__ float xla_exp(float x) {
  constexpr float kLo = -0x1.5f3334p+6f;
  constexpr float kHi = 0x1.633334p+6f;
  constexpr float kLog2e = 0x1.715476p+0f;
  constexpr float kLn2Lo = -0x1.bd0106p-13f;
  constexpr float kLn2Hi = 0x1.63p-1f;
  constexpr float kP[6] = {0x1.a0d2cep-13f, 0x1.6e879cp-10f, 0x1.111210p-7f,
                           0x1.555382p-5f,  0x1.555554p-3f,  0.5f};
  if (x == x) x = fminf(fmaxf(x, kLo), kHi);  // NaN passes, as torch.clamp
  float n = floorf(__fmaf_rn(x, kLog2e, 0.5f));
  if (n == n) n = fminf(fmaxf(n, -127.0f), 127.0f);
  const float r = __fmaf_rn(-kLn2Lo, n, __fmaf_rn(-kLn2Hi, n, x));
  float y = kP[0];
#pragma unroll
  for (int i = 1; i < 6; ++i) y = __fmaf_rn(y, r, kP[i]);
  y = __fadd_rn(1.0f, __fmaf_rn(y, __fmul_rn(r, r), r));
  const float scale = __int_as_float(((int)n + 127) << 23);
  y = __fmul_rn(y, scale);
  return y < kFltMin ? 0.0f : y;
}

__global__ void __launch_bounds__(kThreads)
xla_erf_inv_kernel(const float* __restrict__ x, float* __restrict__ out,
                   float scale, long long n) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads)
    out[i] = __fmul_rn(scale, xla_erf_inv(x[i]));
}

__global__ void __launch_bounds__(kThreads)
xla_exp_kernel(const float* __restrict__ x, float* __restrict__ out,
               long long n) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads)
    out[i] = xla_exp(x[i]);
}

unsigned grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return (unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

// a, b, c: device pointers, or null for the scalar of the same slot;
// geom: ndim sizes, then ndim strides (in elements) for each of a, b, c;
// contiguous[k] != 0 when operand k is laid out as the output.
extern "C" int xla_fma_launch(const void* a, const void* b, const void* c,
                              float sa, float sb, float sc,
                              const int* contiguous, void* out, long long n,
                              int ndim, const long long* geom, void* stream) {
  if (n <= 0 || ndim < 0 || ndim > kMaxDims) return (int)cudaErrorInvalidValue;
  FmaArgs args;
  const void* ptrs[3] = {a, b, c};
  const float scalars[3] = {sa, sb, sc};
  args.ndim = ndim;
  for (int d = 0; d < ndim; ++d) args.size[d] = geom[d];
  for (int k = 0; k < 3; ++k) {
    args.ptr[k] = static_cast<const float*>(ptrs[k]);
    args.scalar[k] = scalars[k];
    args.mode[k] = ptrs[k] == nullptr ? kScalar
                   : contiguous[k]    ? kContiguous
                                      : kStrided;
    for (int d = 0; d < ndim; ++d) args.stride[k][d] = geom[(k + 1) * ndim + d];
  }
  xla_fma_kernel<<<grid_for(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      args, static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

extern "C" int xla_erf_inv_launch(const void* x, void* out, float scale,
                                  long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  xla_erf_inv_kernel<<<grid_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), scale, n);
  return (int)cudaGetLastError();
}

extern "C" int xla_exp_launch(const void* x, void* out, long long n,
                              void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  xla_exp_kernel<<<grid_for(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}
