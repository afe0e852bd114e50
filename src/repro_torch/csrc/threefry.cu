// Die sampling for NVIDIA Hopper (sm_90a): JAX's threefry-2x32 draws, one
// launch per draw.  Plain C interface, loaded with ctypes by
// repro_torch/kernels/threefry.py.
//
// What it replaces: no TPU kernel.  The JAX package samples its dies with
// `jax.random` (`src/repro/core/nonideal.py:64`, `sample_variation_mask`;
// the SA offsets and fallback bits of `resolve_sa` and the engine), which
// XLA fuses into the sweep.  The port's plain version (repro_torch/prng.py,
// `*_plain`) runs the 20-round block function as ~170 int64 elementwise
// torch ops per call, with `& 0xFFFFFFFF` masks, then the uniform, XLA's
// erf_inv and exp as passes of their own; on the card that was most of a
// detector chunk's launches and kernel time.  Here one thread runs the block
// function in uint32 registers (rotations as `__funnelshift_l`) and carries
// its words on through the float tail to the output, so each draw is one
// launch that reads its keys and writes its output once.
//
// Calls (keys [L, 2] int64, the two 32-bit words of each of L keys):
//   * threefry_pairs_launch: fold_in, out[l] = block(key l, counters (0,
//     data[l])), data from an int64 array or one scalar, the same under
//     both schemes; or the partitionable split, key i of key l = block(key
//     l, (0, i)) (the original scheme's split is a draw of 2 * num raw
//     words);
//   * threefry_draw_launch: n words per key in either scheme's counter layout
//     (repro_torch/prng.py's docstring): partitionable, one block per word i
//     at counters (i >> 32, i & mask), word = o0 ^ o1; original, one block
//     per counter pair j < h = ceil(n / 2) at (j, j + h), or (j, 0) for the
//     padded last pair of an odd n, writing o0 to word j and o1 to word
//     j + h.  Each word then goes through one tail: the raw word (int64);
//     uniform fma(f, hi - lo, lo) clamped below at lo, f the top 23 bits as
//     a float in [0, 1); normal, factor * erf_inv(uniform on (nextafter(-1,
//     0), 1)); the log-normal mask exp(normal); bernoulli (uniform < p) as
//     float32 {0, 1}.
// Bit-identity with the plain version: the block function is exact integer
// arithmetic; the uniform's f * (hi - lo) + lo is one `__fmaf_rn`, as XLA
// contracts it inside `jax.random.uniform` and the plain version computes
// it (`xla_order.fma_plain`); hi - lo and the normal's float32(scale *
// float32(sqrt 2)) come from the host, rounded as the plain version rounds
// them; erf_inv and exp are the shared `xla_math.cuh` functions that
// xla_math.cu's kernels use, op for op the plain versions' order.
//
// What bounds it on the H100: operations.  A word costs one block function
// (20 rounds of add, rotate, xor, and 6 key injections: ~110 int32
// operations) plus its tail (~60 float32 operations for a normal); at the
// first layer's periphery draw (4 chips x 294,912 x 60 = 70.8 M words)
// that is ~0.5 ms at the int32 rate against 0.085 ms to write the output.
// A grid-stride loop over each key's words (blockIdx.y picks the key) keeps
// every thread on independent blocks; nothing touches shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "xla_math.cuh"

namespace {

using namespace xla_math;

constexpr int kThreads = 256;
constexpr unsigned kMaxBlocksX = 132 * 16;
constexpr unsigned kMaxBlocksY = 65535;

// tails of a draw
constexpr int kBits = 0;
constexpr int kUniform = 1;
constexpr int kNormal = 2;
constexpr int kLogNormal = 3;
constexpr int kBernoulli = 4;

struct Tail {
  float lo;      // uniform: float32 minval
  float span;    // uniform: float32(maxval - minval)
  float factor;  // normal: float32(scale * float32(sqrt 2))
  float p;       // bernoulli: float32 p
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

// The threefry-2x32 block function, 20 rounds, in place on the counters.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;
#define TF_ROUNDS_A TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ROUNDS_B TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k0;
  x1 += k1;
  TF_ROUNDS_A
  x0 += k1;
  x1 += k2 + 1u;
  TF_ROUNDS_B
  x0 += k2;
  x1 += k0 + 2u;
  TF_ROUNDS_A
  x0 += k0;
  x1 += k1 + 3u;
  TF_ROUNDS_B
  x0 += k1;
  x1 += k2 + 4u;
  TF_ROUNDS_A
  x0 += k2;
  x1 += k0 + 5u;
#undef TF_ROUNDS_B
#undef TF_ROUNDS_A
#undef TF_ROUND
}

// Word w through the tail, written to element i of the output.
template <int kTail>
__device__ __forceinline__ void put(void* out, long long i, uint32_t w,
                                    const Tail& t) {
  if constexpr (kTail == kBits) {
    static_cast<long long*>(out)[i] = (long long)w;
  } else {
    const float f = __fsub_rn(__uint_as_float((w >> 9) | 0x3F800000u), 1.0f);
    float u = __fmaf_rn(f, t.span, t.lo);
    u = u < t.lo ? t.lo : u;
    float v = u;
    if constexpr (kTail == kBernoulli) v = u < t.p ? 1.0f : 0.0f;
    if constexpr (kTail == kNormal || kTail == kLogNormal)
      v = __fmul_rn(t.factor, xla_erf_inv(u));
    if constexpr (kTail == kLogNormal) v = xla_exp(v);
    static_cast<float*>(out)[i] = v;
  }
}

template <bool kOriginal, int kTail>
__global__ void __launch_bounds__(kThreads)
draw_kernel(const long long* __restrict__ keys, long long key_stride,
            void* __restrict__ out, long long n_keys, unsigned long long n,
            Tail t) {
  // blocks per key: one per word, or one per counter pair
  const unsigned long long m = kOriginal ? (n + 1) / 2 : n;
  for (long long l = blockIdx.y; l < n_keys; l += gridDim.y) {
    const uint32_t k0 = (uint32_t)keys[l * key_stride];
    const uint32_t k1 = (uint32_t)keys[l * key_stride + 1];
    const long long base = l * (long long)n;
    for (unsigned long long j =
             blockIdx.x * (unsigned long long)kThreads + threadIdx.x;
         j < m; j += (unsigned long long)gridDim.x * kThreads) {
      uint32_t x0, x1;
      if constexpr (kOriginal) {
        x0 = (uint32_t)j;
        x1 = j + m < n ? (uint32_t)(j + m) : 0u;
      } else {
        x0 = (uint32_t)(j >> 32);
        x1 = (uint32_t)j;
      }
      threefry(k0, k1, x0, x1);
      if constexpr (kOriginal) {
        put<kTail>(out, base + (long long)j, x0, t);
        if (j + m < n) put<kTail>(out, base + (long long)(j + m), x1, t);
      } else {
        put<kTail>(out, base + (long long)j, x0 ^ x1, t);
      }
    }
  }
}

// Key pairs: fold_in (one per key, counters (0, data[l]) or (0, scalar))
// or the partitionable split (num per key, counters (0, i), scalar 0);
// out [total, 2].
__global__ void __launch_bounds__(kThreads)
pairs_kernel(const long long* __restrict__ keys, long long key_stride,
             const long long* __restrict__ data, uint32_t scalar,
             long long* __restrict__ out, long long total, long long num) {
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x;
       e < total; e += (long long)gridDim.x * kThreads) {
    const long long l = e / num;
    uint32_t x0 = 0u;
    uint32_t x1 =
        data ? (uint32_t)data[e] : scalar + (uint32_t)(e - l * num);
    threefry((uint32_t)keys[l * key_stride],
             (uint32_t)keys[l * key_stride + 1], x0, x1);
    out[2 * e] = (long long)x0;
    out[2 * e + 1] = (long long)x1;
  }
}

unsigned blocks_for(unsigned long long m) {
  const unsigned long long blocks = (m + kThreads - 1) / kThreads;
  return (unsigned)(blocks < kMaxBlocksX ? blocks : kMaxBlocksX);
}

template <bool kOriginal>
void launch_draw(const long long* keys, long long key_stride, void* out,
                 long long n_keys,
                 unsigned long long n, int tail, const Tail& t,
                 cudaStream_t stream) {
  const unsigned long long m = kOriginal ? (n + 1) / 2 : n;
  const dim3 grid(blocks_for(m),
                  (unsigned)(n_keys < kMaxBlocksY ? n_keys : kMaxBlocksY));
  switch (tail) {
    case kBits:
      draw_kernel<kOriginal, kBits><<<grid, kThreads, 0, stream>>>(
          keys, key_stride, out, n_keys, n, t);
      break;
    case kUniform:
      draw_kernel<kOriginal, kUniform><<<grid, kThreads, 0, stream>>>(
          keys, key_stride, out, n_keys, n, t);
      break;
    case kNormal:
      draw_kernel<kOriginal, kNormal><<<grid, kThreads, 0, stream>>>(
          keys, key_stride, out, n_keys, n, t);
      break;
    case kLogNormal:
      draw_kernel<kOriginal, kLogNormal><<<grid, kThreads, 0, stream>>>(
          keys, key_stride, out, n_keys, n, t);
      break;
    default:
      draw_kernel<kOriginal, kBernoulli><<<grid, kThreads, 0, stream>>>(
          keys, key_stride, out, n_keys, n, t);
      break;
  }
}

}  // namespace

// keys: n_keys pairs of int64 words, key_stride elements apart; out
// [n_keys, n] (int64 for tail 0, float32 otherwise); original != 0 for the
// original scheme; n < 2^32 words per key.
extern "C" int threefry_draw_launch(const void* keys, long long key_stride,
                                    void* out,
                                    long long n_keys, long long n,
                                    int original, int tail, float lo,
                                    float span, float factor, float p,
                                    void* stream) {
  if (n_keys <= 0 || n <= 0 || n > 0xFFFFFFFFll || tail < kBits ||
      tail > kBernoulli)
    return (int)cudaErrorInvalidValue;
  const Tail t{lo, span, factor, p};
  const auto* k = static_cast<const long long*>(keys);
  auto* st = static_cast<cudaStream_t>(stream);
  if (original)
    launch_draw<true>(k, key_stride, out, n_keys, (unsigned long long)n,
                      tail, t, st);
  else
    launch_draw<false>(k, key_stride, out, n_keys, (unsigned long long)n,
                       tail, t, st);
  return (int)cudaGetLastError();
}

// fold_in: num = 1, data [n_keys] int64 or null for `scalar`; partitionable
// split: data null, scalar 0, num keys per key; out [n_keys * num, 2].
extern "C" int threefry_pairs_launch(const void* keys, long long key_stride,
                                     const void* data,
                                     unsigned scalar, void* out,
                                     long long n_keys, long long num,
                                     void* stream) {
  if (n_keys <= 0 || num <= 0 || num > 0xFFFFFFFFll ||
      (data != nullptr && num != 1))
    return (int)cudaErrorInvalidValue;
  const long long total = n_keys * num;
  const long long blocks = (total + kThreads - 1) / kThreads;
  pairs_kernel<<<(unsigned)(blocks < kMaxBlocksX ? blocks : kMaxBlocksX),
                 kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), key_stride,
      static_cast<const long long*>(data), scalar,
      static_cast<long long*>(out), total, num);
  return (int)cudaGetLastError();
}
