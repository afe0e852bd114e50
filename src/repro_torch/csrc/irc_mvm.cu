// Fused single-shot IRC crossbar MVM + nonideal epilogue, chip-batched, for
// NVIDIA Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// repro_torch/kernels/irc_mvm.py.
//
// Replaces the TPU kernels `irc_mvm_chips_pallas` and `irc_mvm_pallas`
// (src/repro/kernels/irc_mvm.py; bodies `_irc_mvm_chips_kernel`,
// `_irc_mvm_kernel`, helpers `_accum_step`, `_epilogue_tile`,
// `_nl_ratio_inline`).  Its plain PyTorch version is
// repro_torch/kernels/ref.py::irc_mvm_chips_ref.
//
// What it computes, per chip c, word-line row b and output column n:
//   block currents  I±[k] = sum_{r in IR block k} x[b,r] * e±[r,n]  (32 rows)
//   counts          p±    = sum_r x[b,r] * g±[r,n]
//   IR drop         suffix S[k] = sum_{j>=k} I[j];  cum[k] = sum_{j<=k} S[j] - S[0]
//                   (both sums as two-level scans in runs of 16, see below)
//                   i = sum_k I[k] * clip(1 - alpha * cum[k], 0, 1)
//   nonlinearity    i *= ratio(p)  (piecewise quartic, clamped to [0, 320])
//   output "diff"   i+ - i-
//   output binary   (i+ - i- + sigma(p+ + p-) * eps) > 0, replaced by rnd
//                   where min(i±) < sense_low or max(i±) > sense_high.
//
// Layouts: x is [B,R] shared by every chip or [C,B,R] per chip; e± are
// [C,R,N]; g± are [R,N] shared or [C,R,N]; eps/rnd/out are [C,B,N].  A shared
// operand is passed with chip stride 0, so one code path serves all four.
// Ragged edges (R not a multiple of 32, N not of the column tile, B not of
// the row tile) are masked here; the caller pads nothing.  R <= 1024.
//
// Bit-identity rules (the plain version's float32 order, which is the JAX
// reference's on XLA's CPU backend, repro_torch/xla_order.py):
//   * a block current is one chain of f32 fused multiply-adds over the 32
//     rows of its IR block in ascending order, starting from +0 (rows past R
//     are zeros and run through the chain, as the plain version pads them);
//     no tensor cores, no split of a block across threads, no reassociation;
//   * a count is one such chain over all R rows in ascending order.  Where
//     every x and g value of an IR block, and of every block before it, is
//     0 or 1, the chain's value is an exact integer (< 2^24), so the kernel
//     adds the block's popcount instead and gets the same bits; it checks
//     the staged values of every block for that;
//   * the epilogue: two-level scans of 16 for the IR-drop suffix sums and
//     their prefix sums, a sequential weighted block sum, and a fused
//     multiply-add exactly where XLA contracts one (the IR factor, the Horner
//     steps, i+ * r+ - i- unless the sensing window reads i+ * r+, sigma,
//     diff + sigma * eps).  Every multiply and add there is an explicit
//     __fmul_rn/__fadd_rn/__fmaf_rn, so nvcc contracts nothing on its own.
//
// What bounds it on the H100, at the detector's s0b1 shape (C=4,
// B=294,912, R=572, N=60): the two block-current products need 8.1e10 f32
// FFMAs, 2.4 ms at the 67 TFLOP/s FFMA peak, against 1.06 ms of device
// memory traffic (3.55 GB, 2.7 GB of it x).  The design:
//   * a thread block owns one chip, BM word-line rows and 32 columns, with
//     BM / TM x 16 threads; thread (ty, tx) owns the TM rows ty + i BM / TM
//     and columns 2tx and 2tx + 1, a TM x 2 micro-tile of FFMA chains.  The
//     row tile (BM, TM) is a launch argument, one of the candidates that
//     `launch_tile` instantiates (kernels/irc_mvm.py::TILES; (32, 2), 256
//     threads, by default), picked per problem by the port's autotuner
//     (kernels/autotune.py).  It changes only which thread owns which row,
//     never the order of a sum, so every tile gives the same bits;
//   * it walks R in 32-row IR blocks, double-buffered: cp.async stages the
//     next block's x tile (16-byte copies; rows padded to 36 floats, so the
//     float4 reads of four word-line rows hit distinct banks) and its four
//     plane slices (8-byte copies, interleaved per column pair as
//     {e+ e+ e- e-} and {g+ g+ g- g-}) while the current block computes;
//     one __syncthreads() per IR block.  Operands that are not 16/8-byte
//     aligned, or R or N not a multiple of 4/2, take 4-byte copies;
//   * per 4 plane rows a thread reads 2 float4 of x and 4 float4 of the e
//     planes for 32 FFMAs; a warp spans 4 word-line rows x 8 column pairs,
//     so no read has a bank conflict.  A float4 read delivers 16 bytes to
//     each lane, at the SM's 128 bytes per clock, so these 3 bytes per FFMA
//     hold the loop near a third of the FFMA peak;
//   * the counts come from bit masks, built once per IR block and thread
//     block by ballots (one per x row, eight per warp for the g columns),
//     in the same pass that checks the block for values other than 0 and 1;
//     each thread adds popcount(x mask & g mask) one IR block later, after
//     the barrier that publishes the masks.  A block that fails the check,
//     and every block after it, takes the FFMA chain over its still-staged
//     values instead, with one more barrier;
//   * each thread parks its block currents (8 floats per IR block) in a
//     local array, which lives in L1 and L2: in shared memory they take
//     8 KB per IR block of a thread block, so at nb = 18 only one thread
//     block of 8 warps fits on an SM, and the kernel runs slower with one
//     than with the two or three that fit without them.  The epilogue reads
//     them back in block order and runs in registers, writing one f32 per
//     output.
// Later work: thread-block clusters with TMA multicast of the plane slices
// (every row tile of a chip stages the same slices from L2), all groups of
// a layer in one launch, a persistent grid that overlaps one tile's
// epilogue with the next tile's loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlk = 32;            // rows per IR-drop block
constexpr int kTileN = 32;          // output columns per thread block
constexpr int kPairs = kTileN / 2;  // column pairs: the column threads
constexpr int kXStride = kBlk + 4;  // floats per staged x row
constexpr int kPlaneTile = kBlk * kTileN * 2;  // floats of {e+,e-} or {g+,g-}

struct Params {
  float ir_alpha, sense_low, sense_high, sa_c0, sa_c1, sa_c2, sa_extra;
  int flags;
};

enum : int {
  kNonlinearity = 1, kIrDrop = 2, kSa = 4, kRange = 8, kOutputDiff = 16
};

__device__ __forceinline__ float horner(const float* c, float p) {
  float acc = c[0];
#pragma unroll
  for (int i = 1; i < 5; ++i) acc = __fmaf_rn(acc, p, c[i]);
  return acc;
}

__device__ __forceinline__ float nl_ratio(float p_raw) {
  const float lo_c[5] = {1.0286e-8f, -3.79e-6f, 5.3e-4f, -3.92e-2f, 2.5f};
  const float hi_c[5] = {1.8063e-11f, -3.204e-8f, 2.2495e-5f, -8.057e-3f,
                         1.707f};
  float p = fminf(fmaxf(p_raw, 0.0f), 320.0f);
  float r = (p <= 140.0f) ? horner(lo_c, p) : horner(hi_c, p);
  return (p_raw < 0.5f) ? 1.0f : r;
}

// IR-drop weighted sum of the nb real block currents (nb <= NB; NB is the
// register array's compile-time size), in the plain version's float32
// order (repro_torch/xla_order.py): suffix sums and their prefix sums as a
// two-level scan in runs of kScan along the scanned order, the factor
// 1 - alpha * cum one fused multiply-add, the weighted sum sequential from
// block 0 with one fused multiply-add per block.
constexpr int kScan = 16;

template <int NB>
__device__ __forceinline__ float line_current(const float (&I)[NB], int nb,
                                              float alpha, bool ir) {
  if (!ir) {
    float s = I[0];
#pragma unroll
    for (int k = 1; k < NB; ++k)
      if (k < nb) s = __fadd_rn(s, I[k]);
    return s;
  }
  // suffix sums: the scan runs over q = nb - 1 - k, block nb - 1 first
  float S[NB];
  float local = 0.0f, carry = 0.0f;
#pragma unroll
  for (int k = NB - 1; k >= 0; --k) {
    S[k] = 0.0f;
    if (k < nb) {
      const int q = nb - 1 - k;
      if (q % kScan == 0) {
        if (k + 1 < NB && q > 0) carry = S[k + 1];
        local = I[k];
      } else {
        local = __fadd_rn(local, I[k]);
      }
      S[k] = (q < kScan) ? local : __fadd_rn(local, carry);
    }
  }
  float prev = 0.0f, line = 0.0f;
  local = 0.0f;
  carry = 0.0f;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    if (k < nb) {
      if (k % kScan == 0) {
        if (k > 0) carry = prev;
        local = S[k];
      } else {
        local = __fadd_rn(local, S[k]);
      }
      prev = (k < kScan) ? local : __fadd_rn(local, carry);
      const float cum = __fadd_rn(prev, -S[0]);
      const float f = fminf(fmaxf(__fmaf_rn(-alpha, cum, 1.0f), 0.0f), 1.0f);
      line = (k == 0) ? __fmul_rn(I[0], f) : __fmaf_rn(I[k], f, line);
    }
  }
  return line;
}


__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = ok ? bytes : 0;      // 0 source bytes: zero fill
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
}

enum : int { kVecX = 1, kVecPlanes = 2 };

// A thread block of BM word-line rows x 32 columns; each thread owns TM
// rows (ty + i * BM / TM) and one column pair.
template <int BM, int TM>
struct Tile {
  static constexpr int kRowThreads = BM / TM;
  static constexpr int kThreads = kRowThreads * kPairs;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kStage = BM * kXStride + 2 * kPlaneTile;  // floats
  static constexpr int kPark = 4 * TM;   // parked currents per IR block
  // bit masks of one IR block: x rows, then g [half][plane][column], then
  // each warp's "all values were 0 or 1"
  static constexpr int kGMasks = BM;
  static constexpr int kOk = BM + 4 * kTileN;
  static constexpr int kMasks = kOk + kWarps;
  static constexpr int kSmemBytes = 4 * 2 * (kStage + kMasks);
  static_assert(kRowThreads % 4 == 0, "a warp spans 4 row threads");
  static_assert(kThreads <= 1024, "at most 1024 threads a block");
  static_assert(kSmemBytes <= 232448, "the H100's opt-in shared memory");
};

// Copy IR block k (rows r0..r0+31) of the x tile and the four plane slices
// into one stage buffer; rows past B or R and columns past N are zeroed.
template <int BM, int TM>
__device__ __forceinline__ void stage_block(
    float* st, int k, int tid, int row0, int col0, int B, int R, int N,
    const float* xc, const float* const (&pl)[4], int vec) {
  using T = Tile<BM, TM>;
  const int r0 = k * kBlk;
  if (vec & kVecX) {                       // 8 16-byte copies per row
    for (int e = tid; e < BM * 8; e += T::kThreads) {
      const int rr = e >> 3, q = e & 7;
      const int b = row0 + rr, r = r0 + 4 * q;
      const bool ok = b < B && r < R;
      cp_async(st + rr * kXStride + 4 * q,
               ok ? xc + (long long)b * R + r : xc, 16, ok);
    }
  } else {
    for (int e = tid; e < BM * kBlk; e += T::kThreads) {
      const int rr = e >> 5, kk = e & 31;
      const int b = row0 + rr, r = r0 + kk;
      const bool ok = b < B && r < R;
      cp_async(st + rr * kXStride + kk,
               ok ? xc + (long long)b * R + r : xc, 4, ok);
    }
  }
#pragma unroll
  for (int plane = 0; plane < 4; ++plane) {  // e+, e-, g+, g-
    const float* src = pl[plane];
    float* dst = st + BM * kXStride + (plane >> 1) * kPlaneTile
                 + (plane & 1) * 2;
    if (vec & kVecPlanes) {                // one column pair per copy
      for (int e = tid; e < kBlk * kPairs; e += T::kThreads) {
        const int p = e & (kPairs - 1), kk = e >> 4;
        const int r = r0 + kk, n = col0 + 2 * p;
        const bool ok = r < R && n < N;
        cp_async(dst + (kk * kPairs + p) * 4,
                 ok ? src + (long long)r * N + n : src, 8, ok);
      }
    } else {
      for (int e = tid; e < kBlk * kTileN; e += T::kThreads) {
        const int nn = e & (kTileN - 1), kk = e >> 5;
        const int r = r0 + kk, n = col0 + nn;
        const bool ok = r < R && n < N;
        cp_async(dst + (kk * kPairs + (nn >> 1)) * 4 + (nn & 1),
                 ok ? src + (long long)r * N + n : src, 4, ok);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ bool is_bit(float v) {
  return v == 0.0f || v == 1.0f;
}

// The bit masks of a staged IR block, and whether every x and g value in
// it is 0 or 1: mk[rr] has bit kk set where x[row0 + rr, r0 + kk] != 0;
// mk[kGMasks + (h * 2 + s) * 32 + nn] has bit kk set where g+ (s = 0) or g-
// (s = 1) of column col0 + nn is nonzero at row r0 + kk, for the rows kk of
// half h (0-15 or 16-31); mk[kOk + warp] is the warp's verdict.  One ballot
// per x row; a g ballot reads two rows of four column pairs.  12 ballots
// per warp at 8 warps.
template <int BM, int TM>
__device__ __forceinline__ void build_masks(const float* st, unsigned* mk,
                                            int tid) {
  using T = Tile<BM, TM>;
  const int lane = tid & 31, warp = tid >> 5;
  bool ok = true;
  for (int rr = warp; rr < BM; rr += T::kWarps) {
    const float v = st[rr * kXStride + lane];
    ok = ok && is_bit(v);
    const unsigned m = __ballot_sync(0xffffffffu, v != 0.0f);
    if (lane == 0) mk[rr] = m;
  }
  const float* sg = st + BM * kXStride + kPlaneTile;
  const int idx = lane & 15;               // 4 pairs x {g+ g+ g- g-}
  for (int u = warp; u < 8; u += T::kWarps) {
    const int pq = u & 3, h = u >> 2;      // 4 column pairs, half of rows
    unsigned m = 0;
#pragma unroll
    for (int kk0 = 0; kk0 < 16; kk0 += 2) {
      const int kk = 16 * h + kk0 + (lane >> 4);
      const float v = sg[(kk * kPairs + 4 * pq) * 4 + idx];
      ok = ok && is_bit(v);
      const unsigned w = __ballot_sync(0xffffffffu, v != 0.0f);
      m |= ((w >> idx) & 1u) << kk0 | ((w >> (16 + idx)) & 1u) << (kk0 + 1);
    }
    if (lane < 16)
      mk[T::kGMasks + (h * 2 + ((idx >> 1) & 1)) * kTileN
         + 2 * (4 * pq + (idx >> 2)) + (idx & 1)] = m << (16 * h);
  }
  ok = __all_sync(0xffffffffu, ok);
  if (lane == 0) mk[T::kOk + warp] = ok;
}

// One IR block's products for the thread's TM rows x 2 columns, each one
// FFMA chain over the block's 32 rows in ascending order: with kCurrents
// the two block currents from +0 into ap/an, with kCounts the two counts
// continued in cp/cn.
template <int BM, int TM, bool kCurrents, bool kCounts>
__device__ __forceinline__ void block_products(
    const float* st, int ty, int tx, float (&ap)[TM][2], float (&an)[TM][2],
    float (&cp)[TM][2], float (&cn)[TM][2]) {
  using T = Tile<BM, TM>;
  const float* xr = st + ty * kXStride;
  const float4* sa = reinterpret_cast<const float4*>(st + BM * kXStride) + tx;
  const float4* sg = sa + kPlaneTile / 4;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) { ap[i][j] = 0.0f; an[i][j] = 0.0f; }
#pragma unroll
  for (int q = 0; q < kBlk / 4; ++q) {
    float xs[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(
          xr + i * T::kRowThreads * kXStride + 4 * q);
      xs[i][0] = v.x;
      xs[i][1] = v.y;
      xs[i][2] = v.z;
      xs[i][3] = v.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int kk = 4 * q + u;
      if (kCurrents) {
        const float4 a = sa[kk * kPairs];   // e+[n], e+[n+1], e-[n], e-[n+1]
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float xv = xs[i][u];
          ap[i][0] = fmaf(xv, a.x, ap[i][0]);
          ap[i][1] = fmaf(xv, a.y, ap[i][1]);
          an[i][0] = fmaf(xv, a.z, an[i][0]);
          an[i][1] = fmaf(xv, a.w, an[i][1]);
        }
      }
      if (kCounts) {
        const float4 g = sg[kk * kPairs];   // g+[n], g+[n+1], g-[n], g-[n+1]
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float xv = xs[i][u];
          cp[i][0] = fmaf(xv, g.x, cp[i][0]);
          cp[i][1] = fmaf(xv, g.y, cp[i][1]);
          cn[i][0] = fmaf(xv, g.z, cn[i][0]);
          cn[i][1] = fmaf(xv, g.w, cn[i][1]);
        }
      }
    }
  }
}

template <int NB, int BM, int TM>
__global__ void __launch_bounds__(Tile<BM, TM>::kThreads)
irc_mvm_chips_kernel(const float* __restrict__ x, const float* __restrict__ ep,
                     const float* __restrict__ en, const float* __restrict__ gp,
                     const float* __restrict__ gn,
                     const float* __restrict__ eps,
                     const float* __restrict__ rnd, float* __restrict__ out,
                     int B, int R, int N, int col_tiles,
                     long long x_chip_stride, long long g_chip_stride,
                     Params prm, int vec) {
  using T = Tile<BM, TM>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  unsigned* masks = reinterpret_cast<unsigned*>(smem + 2 * T::kStage);
  __align__(16) float park[NB * T::kPark];   // block currents (local)

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ty = (warp >> 1) * 4 + (lane >> 3);   // row thread
  const int tx = (warp & 1) * 8 + (lane & 7);     // column pair
  const int row0 = (blockIdx.x / col_tiles) * BM;
  const int col0 = (blockIdx.x % col_tiles) * kTileN;
  const int c = blockIdx.y;
  const int nb = (R + kBlk - 1) / kBlk;

  const float* xc = x + c * x_chip_stride;
  const long long plane_chip = (long long)c * R * N;
  const float* const pl[4] = {ep + plane_chip, en + plane_chip,
                              gp + c * g_chip_stride, gn + c * g_chip_stride};

  float cp[TM][2], cn[TM][2];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) { cp[i][j] = 0.0f; cn[i][j] = 0.0f; }

  // The counts of IR block k-1 are taken in iteration k, after the barrier
  // that makes block k-1's masks and verdicts visible: while every block so
  // far held only 0s and 1s (`exact`), as popcounts of the masks, which are
  // the FFMA chain's exact integers; otherwise as the FFMA chain itself,
  // over block k-1's stage buffer before the next copy overwrites it.
  bool exact = true;
  auto counts_of = [&](int kb, bool last) {
    const unsigned* mk = masks + (kb & 1) * T::kMasks;
    bool bits = exact;
#pragma unroll
    for (int w = 0; w < T::kWarps; ++w) bits = bits && mk[T::kOk + w];
    if (bits) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const unsigned xm = mk[ty + i * T::kRowThreads];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int nn = 2 * tx + j;
          const unsigned* gm = mk + T::kGMasks + nn;
          cp[i][j] = __fadd_rn(cp[i][j], (float)__popc(
              xm & (gm[0] | gm[2 * kTileN])));
          cn[i][j] = __fadd_rn(cn[i][j], (float)__popc(
              xm & (gm[kTileN] | gm[3 * kTileN])));
        }
      }
    } else {
      exact = false;
      float ap[TM][2], an[TM][2];
      block_products<BM, TM, false, true>(smem + (kb & 1) * T::kStage, ty,
                                          tx, ap, an, cp, cn);
      if (!last) __syncthreads();          // before the next copy lands
    }
  };

  stage_block<BM, TM>(smem, 0, tid, row0, col0, B, R, N, xc, pl, vec);
  for (int k = 0; k < nb; ++k) {
    const float* st = smem + (k & 1) * T::kStage;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();          // block k staged; every thread done with k-1
    if (k > 0) counts_of(k - 1, false);
    if (k + 1 < nb)
      stage_block<BM, TM>(smem + ((k + 1) & 1) * T::kStage, k + 1, tid, row0,
                          col0, B, R, N, xc, pl, vec);
    if (exact) build_masks<BM, TM>(st, masks + (k & 1) * T::kMasks, tid);
    float ap[TM][2], an[TM][2];
    block_products<BM, TM, true, false>(st, ty, tx, ap, an, cp, cn);
    float4* pk = reinterpret_cast<float4*>(park + k * T::kPark);
#pragma unroll
    for (int i = 0; i < TM; ++i)
      pk[i] = make_float4(ap[i][0], an[i][0], ap[i][1], an[i][1]);
  }
  __syncthreads();            // the last block's masks and verdicts
  counts_of(nb - 1, true);

  const bool ir = prm.flags & kIrDrop;
  const bool to_diff = prm.flags & kOutputDiff;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int b = row0 + ty + T::kRowThreads * i;
      const int n = col0 + 2 * tx + j;
      if (b >= B || n >= N) continue;
      // one plane's currents at a time: with both arrays live at once
      // ptxas spilled at some tiles (52 bytes at NB = 18, (32, 2))
      float I[NB];
      const float* pk = park + 4 * i + 2 * j;
#pragma unroll
      for (int k = 0; k < NB; ++k) I[k] = k < nb ? pk[k * T::kPark] : 0.0f;
      float i_pos = line_current<NB>(I, nb, prm.ir_alpha, ir);
#pragma unroll
      for (int k = 0; k < NB; ++k)
        I[k] = k < nb ? pk[k * T::kPark + 1] : 0.0f;
      float i_neg = line_current<NB>(I, nb, prm.ir_alpha, ir);
      float diff;
      if (prm.flags & kNonlinearity) {
        const float r_pos = nl_ratio(cp[i][j]);
        i_neg = __fmul_rn(i_neg, nl_ratio(cn[i][j]));
        if ((prm.flags & kRange) && !to_diff) {
          i_pos = __fmul_rn(i_pos, r_pos);
          diff = __fadd_rn(i_pos, -i_neg);
        } else {
          diff = __fmaf_rn(i_pos, r_pos, -i_neg);
        }
      } else {
        diff = __fadd_rn(i_pos, -i_neg);
      }
      const long long o = ((long long)c * B + b) * N + n;
      if (to_diff) {
        out[o] = diff;
        continue;
      }
      if (prm.flags & kSa) {
        const float pp = __fadd_rn(cp[i][j], cn[i][j]);
        float s = __fmaf_rn(__fmul_rn(prm.sa_c2, pp), pp,
                            __fmaf_rn(prm.sa_c1, pp, prm.sa_c0));
        s = __fmul_rn(0.5f, __fadd_rn(s, prm.sa_extra));
        diff = __fmaf_rn(s, eps[o], diff);
      }
      float res = diff > 0.0f ? 1.0f : 0.0f;
      if (prm.flags & kRange) {
        const bool fail = fminf(i_pos, i_neg) < prm.sense_low ||
                          fmaxf(i_pos, i_neg) > prm.sense_high;
        if (fail) res = rnd[o];
      }
      out[o] = res;
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// One launch's operands, as the C interface receives them.
struct Args {
  const float *x, *ep, *en, *gp, *gn, *eps, *rnd;
  float* out;
  int C, B, R, N;
  long long x_chip_stride, g_chip_stride;
  Params prm;
  cudaStream_t stream;
};

template <int NB, int BM, int TM>
cudaError_t launch(const Args& a) {
  using T = Tile<BM, TM>;
  auto kern = irc_mvm_chips_kernel<NB, BM, TM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int vec =
      (a.R % 4 == 0 && aligned(a.x, 16) ? kVecX : 0) |
      (a.N % 2 == 0 && aligned(a.ep, 8) && aligned(a.en, 8) &&
       aligned(a.gp, 8) && aligned(a.gn, 8) ? kVecPlanes : 0);
  const int col_tiles = (a.N + kTileN - 1) / kTileN;
  const long long blocks = (long long)((a.B + BM - 1) / BM) * col_tiles;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, a.C);
  kern<<<grid, T::kThreads, T::kSmemBytes, a.stream>>>(
      a.x, a.ep, a.en, a.gp, a.gn, a.eps, a.rnd, a.out, a.B, a.R, a.N,
      col_tiles, a.x_chip_stride, a.g_chip_stride, a.prm, vec);
  return cudaGetLastError();
}

// The candidate row tiles (BM, TM), the same list as
// kernels/irc_mvm.py::TILES; any other tile is refused.
template <int NB>
cudaError_t launch_tile(int bm, int tm, const Args& a) {
  if (bm == 16 && tm == 1) return launch<NB, 16, 1>(a);
  if (bm == 32 && tm == 1) return launch<NB, 32, 1>(a);
  if (bm == 32 && tm == 2) return launch<NB, 32, 2>(a);
  if (bm == 64 && tm == 2) return launch<NB, 64, 2>(a);
  if (bm == 64 && tm == 4) return launch<NB, 64, 4>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int irc_mvm_chips_launch(
    const void* x, const void* ep, const void* en, const void* gp,
    const void* gn, const void* eps, const void* rnd, void* out, int C,
    int B, int R, int N, long long x_chip_stride, long long g_chip_stride,
    float ir_alpha, float sense_low, float sense_high, float sa_c0,
    float sa_c1, float sa_c2, float sa_extra, int flags, int bm, int tm,
    void* stream) {
  if (C <= 0 || B <= 0 || R <= 0 || N <= 0 || C > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(x), static_cast<const float*>(ep),
               static_cast<const float*>(en), static_cast<const float*>(gp),
               static_cast<const float*>(gn), static_cast<const float*>(eps),
               static_cast<const float*>(rnd), static_cast<float*>(out),
               C, B, R, N, x_chip_stride, g_chip_stride,
               Params{ir_alpha, sense_low, sense_high, sa_c0, sa_c1, sa_c2,
                      sa_extra, flags},
               static_cast<cudaStream_t>(stream)};
  const int nb = (R + kBlk - 1) / kBlk;
  if (nb <= 18) return (int)launch_tile<18>(bm, tm, a);
  if (nb <= 32) return (int)launch_tile<32>(bm, tm, a);
  return (int)cudaErrorInvalidValue;   // more rows than one 1024-row macro
}
