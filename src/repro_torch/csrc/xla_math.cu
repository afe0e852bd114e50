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
// erf_inv and exp live in xla_math.cuh, which the die-sampling kernel
// (threefry.cu) shares: the sampling itself no longer launches these two.
// Every add, multiply, divide and square root is an explicit `__f*_rn`
// intrinsic, so nvcc contracts nothing on its own, and nothing is built
// with fast math, so subnormals are kept (the flushes of XLA's log1p and
// exp are written out, as in the plain versions).  The result is
// bit-identical to the plain versions for every non-NaN input.
//
// What bounds them on the H100: bytes.  Each reads its inputs once and
// writes its output once (3.35 TB/s); the ~60 flops of erf_inv per element
// take ~1/10 of that time at the FFMA rate.  xla_erf_inv and xla_exp handle
// one element per thread and step of a grid-stride loop.  xla_fma reads
// broadcast operands through their strides, so nothing is expanded in
// device memory; what its index arithmetic costs it keeps off the bytes'
// path: the launcher merges the axes that are contiguous for all three
// operands (the SA epilogue's sigma [B, N] against [C, B, N] becomes two
// axes), indexes in 32 bits when the output and every offset fit, divides
// by each axis's size with a precomputed magic number (a high multiply, an
// add and a shift instead of a 64-bit % and /), and, when the innermost
// axis is a multiple of 4 long and each tensor operand is contiguous or
// broadcast along it, lets each thread take 4 elements with float4 loads
// and stores.  The 64-bit general path remains for the rest.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "xla_math.cuh"

namespace {

using namespace xla_math;

constexpr int kThreads = 256;
constexpr int kMaxDims = 8;
constexpr int kMaxBlocks = 132 * 16;

// xla_fma's general path: 64-bit offsets, one % and / per axis
struct FmaArgs {
  const float* ptr[3];  // null for the scalar of the same slot
  float scalar[3];
  int ndim;
  long long size[kMaxDims];
  long long stride[3][kMaxDims];
};

__global__ void __launch_bounds__(kThreads)
xla_fma64_kernel(FmaArgs a, float* __restrict__ out, long long n) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    long long rem = i, off[3] = {0, 0, 0};
    for (int d = a.ndim - 1; d >= 0; --d) {
      const long long idx = rem % a.size[d];
      rem /= a.size[d];
#pragma unroll
      for (int k = 0; k < 3; ++k) off[k] += idx * a.stride[k][d];
    }
    float v[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      v[k] = a.ptr[k] ? a.ptr[k][off[k]] : a.scalar[k];
    out[i] = __fmaf_rn(v[0], v[1], v[2]);
  }
}

// Division by a fixed divisor d in [1, 2^31) of a dividend below 2^31: one
// high multiply, an add and a shift (Granlund and Montgomery's magic
// number, as PyTorch's IntDivider computes it).
struct DivMod {
  unsigned d, magic, shift;
};

__device__ __forceinline__ unsigned fast_div(unsigned n, const DivMod& m) {
  return (__umulhi(n, m.magic) + n) >> m.shift;
}

// xla_fma's 32-bit paths: at most kDims32 axes left after coalescing, every
// offset below 2^31
constexpr int kDims32 = 4;

struct Fma32Args {
  const float* ptr[3];  // null for the scalar of the same slot
  float scalar[3];
  DivMod size[kDims32];
  unsigned stride[3][kDims32];
};

// Offsets of element i in the three operands; axis 0 needs no division.
template <int kDims>
__device__ __forceinline__ void offsets32(const Fma32Args& a, unsigned i,
                                          unsigned off[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) off[k] = 0;
#pragma unroll
  for (int d = kDims - 1; d > 0; --d) {
    const unsigned q = fast_div(i, a.size[d]);
    const unsigned idx = i - q * a.size[d].d;
#pragma unroll
    for (int k = 0; k < 3; ++k) off[k] += idx * a.stride[k][d];
    i = q;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) off[k] += i * a.stride[k][0];
}

// One element per thread and step (kVec false), or four (kVec true: the
// innermost axis is a multiple of 4 long and every tensor operand is
// contiguous along it, 16-byte aligned, or broadcast along it), read and
// written as float4.
template <int kDims, bool kVec>
__global__ void __launch_bounds__(kThreads)
xla_fma32_kernel(Fma32Args a, float* __restrict__ out, unsigned items) {
  for (unsigned t = blockIdx.x * kThreads + threadIdx.x; t < items;
       t += gridDim.x * kThreads) {
    unsigned off[3];
    if constexpr (kVec) {
      offsets32<kDims>(a, 4 * t, off);
      float4 v[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (a.ptr[k] == nullptr) {
          v[k] = make_float4(a.scalar[k], a.scalar[k], a.scalar[k],
                             a.scalar[k]);
        } else if (a.stride[k][kDims - 1] == 1) {
          v[k] = *reinterpret_cast<const float4*>(a.ptr[k] + off[k]);
        } else {
          const float s = a.ptr[k][off[k]];
          v[k] = make_float4(s, s, s, s);
        }
      }
      reinterpret_cast<float4*>(out)[t] =
          make_float4(__fmaf_rn(v[0].x, v[1].x, v[2].x),
                      __fmaf_rn(v[0].y, v[1].y, v[2].y),
                      __fmaf_rn(v[0].z, v[1].z, v[2].z),
                      __fmaf_rn(v[0].w, v[1].w, v[2].w));
    } else {
      offsets32<kDims>(a, t, off);
      float v[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        v[k] = a.ptr[k] ? a.ptr[k][off[k]] : a.scalar[k];
      out[t] = __fmaf_rn(v[0], v[1], v[2]);
    }
  }
}

DivMod make_divmod(unsigned d) {
  unsigned shift = 0;
  while (shift < 32 && (1ull << shift) < d) ++shift;
  const unsigned long long magic =
      ((1ull << 32) * ((1ull << shift) - d)) / d + 1;
  return DivMod{d, (unsigned)magic, shift};
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

template <int kDims, bool kVec>
void launch_fma32(const Fma32Args& args, float* out, long long n,
                  cudaStream_t stream) {
  const unsigned items = (unsigned)(kVec ? n / 4 : n);
  xla_fma32_kernel<kDims, kVec><<<grid_for(items), kThreads, 0, stream>>>(
      args, out, items);
}

template <bool kVec>
void launch_fma32_dims(const Fma32Args& args, int ndim, float* out,
                       long long n, cudaStream_t stream) {
  switch (ndim) {
    case 1: launch_fma32<1, kVec>(args, out, n, stream); break;
    case 2: launch_fma32<2, kVec>(args, out, n, stream); break;
    case 3: launch_fma32<3, kVec>(args, out, n, stream); break;
    default: launch_fma32<4, kVec>(args, out, n, stream); break;
  }
}

}  // namespace

// a, b, c: device pointers, or null for the scalar of the same slot;
// geom: ndim sizes, then ndim strides (in elements) for each of a, b, c,
// axes coalesced by the caller (repro_torch/kernels/xla_math.py); path:
// kPath64, or kPath32 / kPathVec4, which the caller picks only when n and
// every offset are below 2^31 and ndim <= kDims32 (kPathVec4 also needs the
// innermost axis a multiple of 4 long, each tensor operand's stride along
// it 0 or 1, and, where it is 1, a 16-byte aligned pointer and other
// strides that are multiples of 4).
constexpr int kPath64 = 0;
constexpr int kPath32 = 1;
constexpr int kPathVec4 = 2;

extern "C" int xla_fma_launch(const void* a, const void* b, const void* c,
                              float sa, float sb, float sc, void* out,
                              long long n, int ndim, const long long* geom,
                              int path, void* stream) {
  if (n <= 0 || ndim < 1 || ndim > kMaxDims ||
      (path != kPath64 && (ndim > kDims32 || n >= (1ll << 31))))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[3] = {a, b, c};
  const float scalars[3] = {sa, sb, sc};
  auto* dst = static_cast<float*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  if (path == kPath64) {
    FmaArgs args;
    args.ndim = ndim;
    for (int k = 0; k < 3; ++k) {
      args.ptr[k] = static_cast<const float*>(ptrs[k]);
      args.scalar[k] = scalars[k];
      for (int d = 0; d < ndim; ++d) {
        args.size[d] = geom[d];
        args.stride[k][d] = geom[(k + 1) * ndim + d];
      }
    }
    xla_fma64_kernel<<<grid_for(n), kThreads, 0, st>>>(args, dst, n);
    return (int)cudaGetLastError();
  }
  Fma32Args args;
  for (int k = 0; k < 3; ++k) {
    args.ptr[k] = static_cast<const float*>(ptrs[k]);
    args.scalar[k] = scalars[k];
    for (int d = 0; d < kDims32; ++d) {
      args.size[d] = make_divmod(d < ndim ? (unsigned)geom[d] : 1u);
      args.stride[k][d] = d < ndim ? (unsigned)geom[(k + 1) * ndim + d] : 0u;
    }
  }
  if (path == kPathVec4)
    launch_fma32_dims<true>(args, ndim, dst, n, st);
  else
    launch_fma32_dims<false>(args, ndim, dst, n, st);
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
