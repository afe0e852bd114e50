// Die sampling for NVIDIA Hopper (sm_90a): JAX's threefry-2x32 draws, one
// launch per draw.  Plain C interface, loaded with ctypes by
// repro_torch/kernels/threefry.py.
//
// What it replaces: no TPU kernel.  The JAX package samples its dies with
// `jax.random` (`src/repro/core/nonideal.py:64`, `sample_variation_mask`;
// the SA offsets and fallback bits of `resolve_sa` and the engine), which
// XLA fuses into the sweep.  The port's plain version (repro_torch/prng.py,
// `*_plain`) runs the 20-round block function as ~170 int64 elementwise
// torch ops per call, with `& 0xFFFFFFFF` masks, then the tail
// (`prng.tail_plain`: the uniform, XLA's erf_inv and exp) as passes of its
// own.  Here one thread runs the block function in uint32 registers and
// carries its words on through the float tail to the output, so each draw
// is one launch that reads its keys and writes its output once.
//
// Calls (keys [L, 2] int64, the two 32-bit words of each of L keys):
//   * threefry_pairs_launch: fold_in, out[l] = block(key l, counters (0,
//     data[l])), data from an int64 array or one scalar, the same under
//     both schemes; or the partitionable split, key i of key l = block(key
//     l, (0, i)) (the original scheme's split is a draw of 2 * num raw
//     words);
//   * threefry_draw_launch: n words per key in either scheme's counter layout
//     (repro_torch/prng.py's docstring): partitionable, one block per word i
//     at counters (0, i) (i < 2^32), word = o0 ^ o1; original, one block
//     per counter pair j < m = ceil(n / 2) at (j, j + m), or (j, 0) for the
//     padded last pair of an odd n, writing o0 to word j and o1 to word
//     j + m.  Each word then goes through one tail: the raw word (int64);
//     uniform fma(f, hi - lo, lo) clamped below at lo, f the top 23 bits as
//     a float in [0, 1); normal, factor * erf_inv(uniform on (nextafter(-1,
//     0), 1)); the log-normal mask exp(normal); bernoulli (uniform < p) as
//     float32 {0, 1};
//   * threefry_measured_launch: the measured device backend's mask,
//     `jnp.interp(norm.cdf(normal), xp, fp)` (`src/repro/device/
//     measured.py:98-100`): the normal at scale sqrt(1/2) (the cdf's w, the
//     two constants folded into one as XLA folds them), XLA's ndtr on it
//     (erf below |w| = sqrt(1/2), erfc above) and the interpolation over a
//     table of 2 to 32 quantiles (finite, not decreasing) that travels by
//     value in the launch's parameters;
//   * threefry_tail_launch, threefry_measured_tail_launch (checks only): the
//     same tails on given words.
// Bit-identity with the plain version: the block function is exact integer
// arithmetic; the uniform's f * (hi - lo) + lo is one `__fmaf_rn`, as XLA
// contracts it inside `jax.random.uniform` and the plain version computes
// it (`xla_order.fma_plain`); hi - lo and the normal's float32(scale *
// float32(sqrt 2)) come from the host, rounded as the plain version rounds
// them; erf_inv and exp are the shared `xla_math.cuh` functions that
// xla_math.cu's kernels use, op for op the plain versions' order, and so
// are the pieces of the measured tail's erf and erfc, which `cdf_word`
// puts together in `xla_order.ndtr_from_w`'s order; its interpolation is
// `xla_order.interp`'s order.  The
// tails take only the top 23 bits of a word, so `chip_smoke.py` phase 3
// holds each of them on all 2^23 of its inputs (`threefry_tail_launch`
// against `prng.tail_plain`).
//
// What bounds it on the H100: instruction issue, and for the integer-only
// tails the ALU pipe.  A word needs one block function (20 rounds of an
// add, a funnel shift and an xor, and the key injections: 68 int32
// instructions a word in the partitionable scheme, 34 in the original)
// plus its tail (36 float32 instructions for a normal on its cheaper
// branches, 2 for bernoulli); the funnel shifts and xors issue only on the
// ALU pipe (64 per SM and clock), the adds on the ALU or, as IMAD, on the
// FMA pipe, every instruction through one issue slot of 128 per SM and
// clock (`chip_smoke.py::threefry_bound_ms`).  `chip_smoke.py` phase 4
// prints the SASS of each main loop per word: about 148 instructions for
// the normal (25 more in the block that erf_inv's vote guards), 73 for
// bernoulli, 112 for the normal under the original scheme and 173 for the
// log-normal mask, against 216, 85, 196 and 241 of the one-word-a-thread
// kernel before.  The design spends as few instructions a word as it can:
//   * each thread takes kWords consecutive counters per step and stores
//     them 16 bytes at a time (a row's words up to its first 16-byte
//     boundary, and its last few, go through scalar stores); indices are
//     32-bit within a key, and the partitionable scheme's high counter word
//     is the constant 0, folded into the first key injection;
//   * the normal and the log-normal mask write the block function's adds
//     as IMAD (`kImadAdds`); the key's injection constants stay in
//     registers (`pinned`) instead of being recomputed every step;
//   * bernoulli turns the word into its float32 {0, 1} with an IMAD.WIDE
//     against an integer threshold that the host derives from p, and an
//     IMAD; the normal's uniform needs no clamp (u = 2 f + lo is exact and
//     never below lo), and its constants are immediates;
//   * the normal runs the main paths of log1p and erf_inv (no special case
//     fires on its inputs, see `log1p_words`): log1p's rational branch
//     divides with `div_rn_normal`, without `__fdiv_rn`'s range check, and
//     erf_inv's upper polynomial and its square root run only in warps where
//     some lane needs them (a vote a word; every loop's trip count is
//     uniform over a warp, so every lane reaches it).
// The measured tail (the normal's instructions, then the cdf and the
// interpolation) loads nothing from the constant bank in its loop:
//   * its table travels by value in the launch's parameters, so two
//     concurrent draws of different tables share nothing, and each block
//     stages it once into 648 bytes of shared memory (`stage_table`): the
//     slots' starts xs[32], +inf past the table, and a 16-byte record of
//     constants a slot, read with one load after the search;
//   * a 5-step branch-free bisection over xs finds the slot, which is
//     `jnp.interp`'s searchsorted(xp, u, side='right') clipped to [1, n -
//     1] (ties pick the last, -0 compares equal to +0); slot 0 (below
//     xp[0]) and the empty segments hold a constant record, so of XLA's
//     three clamps only the upper end is left to a compare;
//   * the cdf (`cdf_word`) runs erf's and erfc's branches on every lane and
//     selects, as both run in almost every warp anyway; they share w^2 and
//     one division, and erfc's rare S polynomial waits for a warp vote.
// Tried and left out (PERF.md): all adds as IMAD for bernoulli (2.7%
// slower than ptxas's own split), rotations on the FMA pipe as IMAD and
// IMAD.HI (14-16% slower), log1p's inputs sorted by branch through shared
// memory (5% slower).
// Only the measured tail touches shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cmath>

#include "xla_math.cuh"

namespace {

using namespace xla_math;

constexpr int kThreads = 256;
// counters a thread takes per step: two 16-byte stores of float32 words
constexpr int kWords = 8;
constexpr unsigned kMaxBlocksX = 132 * 16;
constexpr unsigned kMaxBlocksY = 65535;
constexpr unsigned kAllLanes = 0xFFFFFFFFu;

// tails of a draw
constexpr int kBits = 0;
constexpr int kUniform = 1;
constexpr int kNormal = 2;
constexpr int kLogNormal = 3;
constexpr int kBernoulli = 4;
constexpr int kMeasured = 5;
// quantiles a measured tail's table may hold
constexpr int kMaxTable = 32;

// the normal's uniform: lo = nextafter(-1, 0), span = 2
constexpr float kNormalLo = -0x1.fffffep-1f;

// One slot of the measured table: f = fma((u - x0) / dx, df, f0), read with
// one 16-byte shared load
struct __align__(16) Seg {
  float x0, f0, dx, df;
};

// The measured tail's table of n quantiles xp (finite, non-decreasing) and
// factors fp as the slots of a search: a word takes the last slot k whose
// start xs[k] is at or below its u (slot 0 if none; xs[0] is never read,
// xs[k] = +inf from k = n on).  Slot k in [1, n - 1] starts at xs[k] =
// xp[k - 1] and holds `jnp.interp`'s segment k - 1: x0 = xp[k - 1], f0 =
// fp[k - 1], dx and df its float32 widths in x and f.  Slot 0 (below xp[0])
// and every segment at most 2^-46 wide hold the constant f0: {0, f0, 1, +-0
// with f0's sign}, since fma(u, +-0, f0) = f0 for every u >= +0.  Above
// x_hi = xp[n - 1] a word takes f_hi = fp[n - 1].
struct Table {
  float xs[kMaxTable];
  Seg seg[kMaxTable];
  float x_hi, f_hi;
};

// the table, staged in shared memory once per block
__shared__ Table staged;

// what each thread keeps of the measured table in registers: the middle
// slot's start (the bisection's first step) and the upper end
struct Hot {
  float mid, x_hi, f_hi;
};

struct Tail {
  float lo;      // uniform: float32 minval
  float span;    // uniform: float32(maxval - minval)
  float factor;  // normal: float32(scale * float32(sqrt 2))
  // bernoulli: word w gives the float32 bits hit + (w >= thr) * step, and
  // w >= thr is the carry out of w + ge_bias, ge_bias = 2^32 - thr
  unsigned long long ge_bias;
  uint32_t hit, step;
  uint32_t one;  // 1, passed at run time so that x + y * one stays an IMAD
  Table table;   // measured
};

// How a tail's block function adds.  The normal and the log-normal mask
// write the adds as multiply-adds by a 1 that the compiler cannot see,
// which issue as IMAD on the FMA pipe and leave the ALU pipe (64 per SM
// and clock) to the funnel shifts, the xors and the tail's compares and
// selects (2.6% faster than plain adds); the other tails keep plain adds,
// which ptxas splits between IADD3 and IMAD itself (all IMAD was 2.7%
// slower for bernoulli).  PERF.md has the trials.
template <int kTail>
constexpr bool kImadAdds =
    kTail == kNormal || kTail == kLogNormal || kTail == kMeasured;

template <bool kImad>
__device__ __forceinline__ uint32_t add(uint32_t x, uint32_t y,
                                        uint32_t one) {
  if constexpr (kImad)
    return x + y * one;
  else
    return x + y;
}

// x, which the compiler must keep in a register from here on instead of
// recomputing it on every trip of a loop
__device__ __forceinline__ uint32_t pinned(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

// a key's words and the constants of its five later injections, pinned
// in registers
struct Key {
  uint32_t k0, k1, k2, c1, c2, c3, c4, c5;
};

__device__ __forceinline__ Key make_key(const long long* key) {
  Key k;
  k.k0 = pinned((uint32_t)key[0]);
  k.k1 = pinned((uint32_t)key[1]);
  k.k2 = pinned(k.k0 ^ k.k1 ^ 0x1BD11BDAu);
  k.c1 = pinned(k.k2 + 1u);
  k.c2 = pinned(k.k0 + 2u);
  k.c3 = pinned(k.k1 + 3u);
  k.c4 = pinned(k.k2 + 4u);
  k.c5 = pinned(k.k0 + 5u);
  return k;
}

// The threefry-2x32 block function, 20 rounds, in place on counters that
// already hold the first key injection (x0 + k0, x1 + k1).
template <bool kImad>
__device__ __forceinline__ void threefry(const Key& k, uint32_t one,
                                         uint32_t& x0, uint32_t& x1) {
#define TF_ROUND(r)                 \
  x0 = add<kImad>(x0, x1, one);     \
  x1 = rotl(x1, r) ^ x0;
#define TF_ROUNDS_A TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ROUNDS_B TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
#define TF_INJECT(a, b)           \
  x0 = add<kImad>(x0, k.a, one);  \
  x1 = add<kImad>(x1, k.b, one);
  TF_ROUNDS_A
  TF_INJECT(k1, c1)
  TF_ROUNDS_B
  TF_INJECT(k2, c2)
  TF_ROUNDS_A
  TF_INJECT(k0, c3)
  TF_ROUNDS_B
  TF_INJECT(k1, c4)
  TF_ROUNDS_A
  TF_INJECT(k2, c5)
#undef TF_INJECT
#undef TF_ROUNDS_B
#undef TF_ROUNDS_A
#undef TF_ROUND
}

// The blocks of kWords consecutive counters j = c, c + 1, ...:
// partitionable, a[q] = o0 ^ o1 of the block at (0, j); original, a[q] = o0
// and b[q] = o1 of the block at (j, j + m), or at (j, 0) from j = mb on
// where kEdge says that the group may reach the padded pair.  The first
// injection is added to c once; the counters step from it as IMADs.
template <bool kOriginal, bool kImad, bool kEdge>
__device__ __forceinline__ void blocks(const Key& k, uint32_t one,
                                       uint32_t c, uint32_t m, uint32_t mb,
                                       uint32_t (&a)[kWords],
                                       uint32_t (&b)[kWords]) {
  const uint32_t c0 = add<kImad>(c, k.k0, one);
  const uint32_t c1 =
      add<kImad>(kOriginal ? add<kImad>(c, m, one) : c, k.k1, one);
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    uint32_t x0 = kOriginal ? add<true>(c0, q, one) : k.k0;
    uint32_t x1 = add<true>(c1, q, one);
    if (kOriginal && kEdge && c + q >= mb) x1 = k.k1;
    threefry<kImad>(k, one, x0, x1);
    a[q] = kOriginal ? x0 : x0 ^ x1;
    b[q] = x1;
  }
}

// the top 23 bits of a word as a float in [0, 1)
__device__ __forceinline__ float unit(uint32_t w) {
  return __fsub_rn(__uint_as_float((w >> 9) | 0x3F800000u), 1.0f);
}

// log1p(x) for the normal's x = -u^2, u = 2 f + lo, in place.  u is exact
// and lies in [-1 + 2^-24, 1 - 3 2^-24], so x lies in [-1 + 2^-23,
// -2^-48]: x is never subnormal, 1 + x is a positive normal float, and |u|
// is never 1.  Both branches run on every lane (the rational one on about
// 64% of the inputs); sorting a warp's inputs by branch through shared
// memory was slower (PERF.md).
__device__ __forceinline__ void log1p_words(float (&x)[kWords]) {
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    const float small = log1p_small(x[q]);
    const float large = log_core(__fadd_rn(x[q], 1.0f));
    x[q] = fabsf(x[q]) < kLog1pSmall ? small : large;
  }
}

// factor * erf_inv(u) from l = log1p(-u^2), as xla_erf_inv computes it:
// erf_inv's upper polynomial (w >= 5, |u| > 0.9966) runs only where a lane
// of the warp needs it, so every lane of the warp must reach the vote.
__device__ __forceinline__ float normal_word(float u, float l,
                                             float factor) {
  const float w = -l;
  float p = erf_inv_lt5(w);
  if (__any_sync(kAllLanes, !(w < kErfInvSplit))) {
    const float upper = erf_inv_gt5(w);
    if (!(w < kErfInvSplit)) p = upper;
  }
  return __fmul_rn(factor, __fmul_rn(p, u));
}

// The measured table from the launch's parameters into shared memory, by
// the block's first kMaxTable threads; every thread of the block calls it
// before its first word.  The upper end goes through shared memory too:
// taken from the parameters, ptxas would load f_hi from the constant bank
// for every word's select.
__device__ __forceinline__ Hot stage_table(const Table& t) {
  if (threadIdx.x < kMaxTable) {
    staged.xs[threadIdx.x] = t.xs[threadIdx.x];
    staged.seg[threadIdx.x] = t.seg[threadIdx.x];
  }
  if (threadIdx.x == 0) staged.x_hi = t.x_hi, staged.f_hi = t.f_hi;
  __syncthreads();
  return Hot{staged.xs[16], staged.x_hi, staged.f_hi};
}

// x, computed here: the compiler may not sink its computation into a branch
// of a later select
__device__ __forceinline__ float computed(float x) {
  asm volatile("" : "+f"(x));
  return x;
}

// `jax.scipy.special.ndtr` from w = z sqrt(1/2) on, |w| < 4, in the order of
// `xla_order.ndtr_from_w` (erf below |w| = sqrt(1/2), erfc above), both
// branches on every lane and the result selected: erf's x^2 and erfc's a^2
// are one product; one correctly rounded division gives erf's quotient on
// the lanes below sqrt(1/2) and 1 / a^2 on the others; erfc's S polynomial
// (a >= 2, ~0.5% of words) runs only where a lane of the warp needs it, so
// every lane of the warp must reach the vote.  Every operand of the
// divisions is normal (w is never 0 nor subnormal, Q(w^2) lies in [1, 1.3],
// a in [2^-24, 4]), so `div_rn_normal` rounds them as `__fdiv_rn` does.
__device__ __forceinline__ float cdf_word(float w) {
  const float a = fabsf(w);
  const float a2 = __fmul_rn(w, w);
  const bool small = a < kHalfSqrt2;
  const float num = __fmul_rn(w, erf_p(a2));
  const float d = div_rn_normal(small ? num : 1.0f, small ? erf_q(a2) : a2);
  float poly = erfc_r(d);
  if (__any_sync(kAllLanes, !(a < 2.0f))) {
    const float s = erfc_s(d);
    if (!(a < 2.0f)) poly = s;
  }
  const float big =
      __fmul_rn(__fmul_rn(exp_main(-a2), rcp_rn_normal(a)), poly);
  const float e = a < 1.0f ? erfc_lt1(a, a2) : big;
  const float upper = computed(w > 0.0f ? __fsub_rn(2.0f, e) : e);
  return __fmul_rn(small ? __fadd_rn(1.0f, d) : upper, 0.5f);
}

// `jnp.interp(u, xp, fp)` over the staged table, u in [+0, 1] (the order of
// `xla_order.interp`): the slot by a 5-step branch-free bisection (the
// first step's start xs[16] in a register), then one 16-byte load of its
// constants, the division, the fused multiply-add and the upper end
__device__ __forceinline__ float interp_word(float u, const Hot& h) {
  const float* x = staged.xs + (h.mid <= u ? 16 : 0);
#pragma unroll
  for (int step = 8; step > 0; step >>= 1)
    if (x[step] <= u) x += step;
  const Seg g = staged.seg[x - staged.xs];
  const float f = __fmaf_rn(__fdiv_rn(__fsub_rn(u, g.x0), g.dx), g.df, g.f0);
  return u > h.x_hi ? h.f_hi : f;
}

// Words through the tail, in place (float32 tails leave their bits).
// Called by every lane of a warp together.
// (`h`: what the measured tail keeps of its staged table in registers)
template <int kTail>
__device__ __forceinline__ void apply_tail(uint32_t (&w)[kWords],
                                           const Tail& t, const Hot& h = {}) {
  if constexpr (kTail == kBernoulli) {
    // an IMAD.WIDE and an IMAD, on the FMA pipe
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      const unsigned long long s = (unsigned long long)w[q] * t.one
                                   + t.ge_bias;
      w[q] = t.hit + (uint32_t)(s >> 32) * t.step;
    }
  } else if constexpr (kTail == kUniform) {
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      const float v = __fmaf_rn(unit(w[q]), t.span, t.lo);
      w[q] = __float_as_uint(v < t.lo ? t.lo : v);
    }
  } else if constexpr (kTail == kNormal || kTail == kLogNormal ||
                       kTail == kMeasured) {
    // the normal's constants are fixed (the launcher checks them)
    float u[kWords], l[kWords];
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      u[q] = __fmaf_rn(unit(w[q]), 2.0f, kNormalLo);
      l[q] = __fmul_rn(u[q], -u[q]);
    }
    log1p_words(l);
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      float v = normal_word(u[q], l[q], t.factor);
      if constexpr (kTail == kLogNormal) v = xla_exp(v);
      // the measured mask: v = w, the cdf's z sqrt(1/2)
      if constexpr (kTail == kMeasured)
        v = interp_word(cdf_word(v), h);
      w[q] = __float_as_uint(v);
    }
  }
}

// the element size of a tail's output: int64 words or float32
template <int kTail>
constexpr unsigned kElem = kTail == kBits ? 8 : 4;

// kWords outputs at elements i.. of row; `vec`: 16-byte stores, which
// need row + i on a 16-byte boundary
template <int kTail>
__device__ __forceinline__ void store(char* row, uint32_t i,
                                      const uint32_t (&w)[kWords], bool vec) {
  if constexpr (kTail == kBits) {
    auto* p = reinterpret_cast<long long*>(row) + i;
#pragma unroll
    for (int q = 0; q < kWords; q += 2) {
      if (vec)
        *reinterpret_cast<uint4*>(p + q) = make_uint4(w[q], 0u, w[q + 1], 0u);
      else
        p[q] = (long long)w[q], p[q + 1] = (long long)w[q + 1];
    }
  } else {
    auto* p = reinterpret_cast<uint32_t*>(row) + i;
#pragma unroll
    for (int q = 0; q < kWords; q += 4) {
      if (vec)
        *reinterpret_cast<uint4*>(p + q) =
            make_uint4(w[q], w[q + 1], w[q + 2], w[q + 3]);
      else
        p[q] = w[q], p[q + 1] = w[q + 1], p[q + 2] = w[q + 2],
        p[q + 3] = w[q + 3];
    }
  }
}

// the outputs of counters c + q in [lo, hi) at elements c + q of row
template <int kTail>
__device__ __forceinline__ void store_range(char* row, uint32_t c,
                                            const uint32_t (&w)[kWords],
                                            uint32_t lo, uint32_t hi) {
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    const uint32_t i = c + q;
    if (i < lo || i >= hi) continue;
    if constexpr (kTail == kBits)
      reinterpret_cast<long long*>(row)[i] = (long long)w[q];
    else
      reinterpret_cast<uint32_t*>(row)[i] = w[q];
  }
}

// One row of n words per key.  Counters (words, or pairs under the
// original scheme) [head, head + kWords * G) go in groups of kWords, one
// group per lane and step, with 16-byte stores: `head` counters bring the
// row to a 16-byte boundary.  The rest, fewer than kWords at each end,
// go to lanes 0 and 1 of the row's first warp.  Every loop's trip count
// is uniform over a warp.
template <bool kOriginal, int kTail>
__global__ void __launch_bounds__(kThreads)
draw_kernel(const long long* __restrict__ keys, long long key_stride,
            void* __restrict__ out, unsigned n_keys, uint32_t n,
            const __grid_constant__ Tail t) {
  constexpr unsigned kE = kElem<kTail>;
  constexpr bool kImad = kImadAdds<kTail>;
  const uint32_t one = t.one;
  // counters per key; those whose every word lands in the row
  const uint32_t m = kOriginal ? (uint32_t)(((unsigned long long)n + 1) / 2)
                               : n;
  const uint32_t full = kOriginal ? n - m : n;
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t first = blockIdx.x * kThreads + (threadIdx.x & ~31u);
  const uint32_t step = gridDim.x * kThreads;
  Hot h{};
  if constexpr (kTail == kMeasured) h = stage_table(t.table);
  for (unsigned l = blockIdx.y; l < n_keys; l += gridDim.y) {
    const Key k = make_key(keys + (long long)l * key_stride);
    char* row = static_cast<char*>(out) + (size_t)l * n * kE;
    char* row_b = row + (size_t)m * kE;  // the original scheme's o1 words
    const uint32_t to16 = (uint32_t)((16u - ((uintptr_t)row & 15u)) & 15u) / kE;
    const uint32_t head = to16 < full ? to16 : full;
    const uint32_t groups = (full - head) / kWords;
    const bool vec_b = (((uintptr_t)row_b + (uintptr_t)head * kE) & 15u) == 0;
    for (uint32_t g0 = first; g0 < groups; g0 += step) {
      const uint32_t g = g0 + lane;
      const uint32_t c = head + g * kWords;
      uint32_t a[kWords], b[kWords];
      blocks<kOriginal, kImad, false>(k, one, c, m, full, a, b);
      apply_tail<kTail>(a, t, h);
      if (g < groups) store<kTail>(row, c, a, true);
      if constexpr (kOriginal) {
        apply_tail<kTail>(b, t, h);
        if (g < groups) store<kTail>(row_b, c, b, vec_b);
      }
    }
    if (blockIdx.x == 0 && threadIdx.x < 32) {
      // lane 0: counters [0, head); lane 1: [head + kWords * groups, m)
      const uint32_t tail0 = head + groups * kWords;
      const uint32_t c = lane == 0 ? head - kWords : tail0;
      uint32_t a[kWords], b[kWords];
      blocks<kOriginal, kImad, true>(k, one, c, m, full, a, b);
      const uint32_t lo = lane == 0 ? 0u : tail0;
      apply_tail<kTail>(a, t, h);
      if (lane < 2) store_range<kTail>(row, c, a, lo, lane == 0 ? head : m);
      if constexpr (kOriginal) {
        apply_tail<kTail>(b, t, h);
        if (lane < 2)
          store_range<kTail>(row_b, c, b, lo, lane == 0 ? head : full);
      }
    }
  }
}

// The tails alone, on n words (n a multiple of kWords), for the checks.
template <int kTail>
__global__ void __launch_bounds__(kThreads)
tail_kernel(const long long* __restrict__ words, float* __restrict__ out,
            uint32_t n, const __grid_constant__ Tail t) {
  const uint32_t groups = n / kWords;
  Hot h{};
  if constexpr (kTail == kMeasured) h = stage_table(t.table);
  for (uint32_t g0 = blockIdx.x * kThreads + (threadIdx.x & ~31u);
       g0 < groups; g0 += gridDim.x * kThreads) {
    const uint32_t g = g0 + (threadIdx.x & 31u);
    uint32_t w[kWords];
#pragma unroll
    for (int q = 0; q < kWords; ++q)
      w[q] = g < groups ? (uint32_t)words[g * kWords + q] : 0u;
    apply_tail<kTail>(w, t, h);
    if (g < groups) store<kTail>(reinterpret_cast<char*>(out), g * kWords, w,
                                 false);
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
    const Key k = make_key(keys + l * key_stride);
    uint32_t x0 = k.k0;
    uint32_t x1 =
        (data ? (uint32_t)data[e] : scalar + (uint32_t)(e - l * num)) + k.k1;
    threefry<false>(k, 1u, x0, x1);
    out[2 * e] = (long long)x0;
    out[2 * e + 1] = (long long)x1;
  }
}

unsigned blocks_for(unsigned long long items) {
  const unsigned long long blocks = (items + kThreads - 1) / kThreads;
  return (unsigned)(blocks < 1 ? 1 : blocks < kMaxBlocksX ? blocks
                                                          : kMaxBlocksX);
}

// The tail's constants: bernoulli's u < p, u = k 2^-23 for the word's top
// 23 bits k, holds for k < T = ceil(p 2^23), that is for words below thr =
// T << 9, T clamped to [0, 2^23] (none for p <= 0 or NaN, all from T =
// 2^23 on): 1.0 below thr, 0.0 from it on.
Tail make_tail(float lo, float span, float factor, float p) {
  const double x = ceil((double)p * 8388608.0);
  const unsigned long long thr =
      (unsigned long long)(x >= 8388608.0 ? 8388608.0 : x > 0.0 ? x : 0.0)
      << 9;
  return Tail{lo, span, factor, (1ull << 32) - thr, 0x3F800000u,
              0u - 0x3F800000u, 1u};
}

template <bool kOriginal, int kTail>
void launch_draw_tail(dim3 grid, const long long* keys, long long key_stride,
                      void* out, unsigned n_keys, uint32_t n, const Tail& t,
                      cudaStream_t stream) {
  draw_kernel<kOriginal, kTail><<<grid, kThreads, 0, stream>>>(
      keys, key_stride, out, n_keys, n, t);
}

template <bool kOriginal>
void launch_draw(const long long* keys, long long key_stride, void* out,
                 unsigned n_keys, uint32_t n, int tail, const Tail& t,
                 cudaStream_t stream) {
  const unsigned long long m = kOriginal ? (n + 1ull) / 2 : n;
  const dim3 grid(blocks_for((m + kWords - 1) / kWords),
                  n_keys < kMaxBlocksY ? n_keys : kMaxBlocksY);
  switch (tail) {
    case kBits:
      launch_draw_tail<kOriginal, kBits>(grid, keys, key_stride, out, n_keys,
                                         n, t, stream);
      break;
    case kUniform:
      launch_draw_tail<kOriginal, kUniform>(grid, keys, key_stride, out,
                                            n_keys, n, t, stream);
      break;
    case kNormal:
      launch_draw_tail<kOriginal, kNormal>(grid, keys, key_stride, out,
                                           n_keys, n, t, stream);
      break;
    case kLogNormal:
      launch_draw_tail<kOriginal, kLogNormal>(grid, keys, key_stride, out,
                                              n_keys, n, t, stream);
      break;
    case kMeasured:
      launch_draw_tail<kOriginal, kMeasured>(grid, keys, key_stride, out,
                                             n_keys, n, t, stream);
      break;
    default:
      launch_draw_tail<kOriginal, kBernoulli>(grid, keys, key_stride, out,
                                              n_keys, n, t, stream);
      break;
  }
}

// the tails that take given constants: the normal's are fixed; the
// measured tail comes only through the launchers that take its table
bool tail_ok(int tail, float lo, float span) {
  if (tail < kBits || tail > kBernoulli) return false;
  if (tail == kNormal || tail == kLogNormal)
    return lo == kNormalLo && span == 2.0f;
  return true;
}

// the slot that gives f0 for every u >= +0
Seg constant_seg(float f0) { return Seg{0.0f, f0, 1.0f, copysignf(0.0f, f0)}; }

// The measured table from n float32 quantiles xp and factors fp; false
// unless 2 <= n <= kMaxTable, every value and every float32 difference of
// neighbours is finite and xp does not decrease (`prng.check_table`'s
// terms).  Widths are float32 differences, as `jnp.interp` takes them.
bool make_table(const float* xp, const float* fp, int n, Table& t) {
  if (xp == nullptr || fp == nullptr || n < 2 || n > kMaxTable) return false;
  for (int j = 0; j < n; ++j) {
    if (!std::isfinite(xp[j]) || !std::isfinite(fp[j])) return false;
    if (j > 0 && (!(xp[j] >= xp[j - 1]) ||
                  !std::isfinite(xp[j] - xp[j - 1]) ||
                  !std::isfinite(fp[j] - fp[j - 1])))
      return false;
  }
  t = Table{};
  t.xs[0] = -INFINITY;
  t.seg[0] = constant_seg(fp[0]);
  for (int k = 1; k < kMaxTable; ++k) {
    t.xs[k] = k < n ? xp[k - 1] : INFINITY;
    if (k >= n) continue;
    const float dx = xp[k] - xp[k - 1];
    t.seg[k] = fabsf(dx) <= 0x1p-46f
                   ? constant_seg(fp[k - 1])
                   : Seg{xp[k - 1], fp[k - 1], dx, fp[k] - fp[k - 1]};
  }
  t.x_hi = xp[n - 1];
  t.f_hi = fp[n - 1];
  return true;
}

}  // namespace

// keys: n_keys pairs of int64 words, key_stride elements apart; out
// [n_keys, n] (int64 for tail 0, float32 otherwise); original != 0 for the
// original scheme; n < 2^32 words per key, n_keys < 2^32; the normal and
// log-normal tails take lo = nextafter(-1, 0) and span = 2 only.
extern "C" int threefry_draw_launch(const void* keys, long long key_stride,
                                    void* out,
                                    long long n_keys, long long n,
                                    int original, int tail, float lo,
                                    float span, float factor, float p,
                                    void* stream) {
  if (n_keys <= 0 || n_keys > 0xFFFFFFFFll || n <= 0 || n > 0xFFFFFFFFll ||
      !tail_ok(tail, lo, span))
    return (int)cudaErrorInvalidValue;
  const Tail t = make_tail(lo, span, factor, p);
  const auto* k = static_cast<const long long*>(keys);
  auto* st = static_cast<cudaStream_t>(stream);
  if (original)
    launch_draw<true>(k, key_stride, out, (unsigned)n_keys, (uint32_t)n,
                      tail, t, st);
  else
    launch_draw<false>(k, key_stride, out, (unsigned)n_keys, (uint32_t)n,
                       tail, t, st);
  return (int)cudaGetLastError();
}

// The measured tail's draw: as threefry_draw_launch with tail 5, the
// normal's constants, factor = float32(sqrt(1/2) * float32(sqrt 2)) and the
// table of n_table quantiles xp and factors fp (host float32 arrays).
extern "C" int threefry_measured_launch(const void* keys, long long key_stride,
                                        void* out, long long n_keys,
                                        long long n, int original,
                                        float factor, const float* xp,
                                        const float* fp, int n_table,
                                        void* stream) {
  if (n_keys <= 0 || n_keys > 0xFFFFFFFFll || n <= 0 || n > 0xFFFFFFFFll)
    return (int)cudaErrorInvalidValue;
  Tail t = make_tail(kNormalLo, 2.0f, factor, 0.5f);
  if (!make_table(xp, fp, n_table, t.table))
    return (int)cudaErrorInvalidValue;
  const auto* k = static_cast<const long long*>(keys);
  auto* st = static_cast<cudaStream_t>(stream);
  if (original)
    launch_draw<true>(k, key_stride, out, (unsigned)n_keys, (uint32_t)n,
                      kMeasured, t, st);
  else
    launch_draw<false>(k, key_stride, out, (unsigned)n_keys, (uint32_t)n,
                       kMeasured, t, st);
  return (int)cudaGetLastError();
}

// The measured tail alone on n words (n a multiple of 8), for the checks.
extern "C" int threefry_measured_tail_launch(const void* words, void* out,
                                             long long n, float factor,
                                             const float* xp, const float* fp,
                                             int n_table, void* stream) {
  if (n <= 0 || n > 0xFFFFFFFFll || n % kWords != 0)
    return (int)cudaErrorInvalidValue;
  Tail t = make_tail(kNormalLo, 2.0f, factor, 0.5f);
  if (!make_table(xp, fp, n_table, t.table))
    return (int)cudaErrorInvalidValue;
  tail_kernel<kMeasured><<<blocks_for((unsigned long long)n / kWords),
                           kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(words), static_cast<float*>(out),
      (uint32_t)n, t);
  return (int)cudaGetLastError();
}

// words: n int64 values whose low 32 bits are the words; out: n float32;
// n a multiple of 4 below 2^32; tail 1-4 with the draw's constants.
extern "C" int threefry_tail_launch(const void* words, void* out,
                                    long long n, int tail, float lo,
                                    float span, float factor, float p,
                                    void* stream) {
  if (n <= 0 || n > 0xFFFFFFFFll || n % kWords != 0 || tail == kBits ||
      !tail_ok(tail, lo, span))
    return (int)cudaErrorInvalidValue;
  const Tail t = make_tail(lo, span, factor, p);
  const auto* w = static_cast<const long long*>(words);
  auto* o = static_cast<float*>(out);
  const unsigned grid = blocks_for((unsigned long long)n / kWords);
  auto* st = static_cast<cudaStream_t>(stream);
  switch (tail) {
    case kUniform:
      tail_kernel<kUniform><<<grid, kThreads, 0, st>>>(w, o, (uint32_t)n, t);
      break;
    case kNormal:
      tail_kernel<kNormal><<<grid, kThreads, 0, st>>>(w, o, (uint32_t)n, t);
      break;
    case kLogNormal:
      tail_kernel<kLogNormal><<<grid, kThreads, 0, st>>>(w, o, (uint32_t)n,
                                                         t);
      break;
    default:
      tail_kernel<kBernoulli><<<grid, kThreads, 0, st>>>(w, o, (uint32_t)n,
                                                         t);
      break;
  }
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
