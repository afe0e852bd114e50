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
//   * a block current is one chain of f32 fused multiply-adds
//     acc = fma(x[b,r], e[r,n], acc) over the 32 rows of its IR block in
//     ascending order, starting from +0 (rows past R are zeros and run
//     through the chain, as the plain version pads them); no tensor cores,
//     no split of a block across threads, no reassociation;
//   * a count is one such chain over all R rows in ascending order;
//   * the epilogue: two-level scans of 16 for the IR-drop suffix sums and
//     their prefix sums, a sequential weighted block sum, and a fused
//     multiply-add exactly where XLA contracts one (the IR factor, the Horner
//     steps, i+ * r+ - i- unless the sensing window reads i+ * r+, sigma,
//     diff + sigma * eps).  Every multiply and add there is an explicit
//     __fmul_rn/__fadd_rn/__fmaf_rn, so nvcc contracts nothing on its own.
//
// Word lines read as bit masks.  Where every x of an IR block is 0 or 1 and
// every e of it is finite, the chain above equals "acc = acc + e[r,n] over
// the rows r whose x is 1, in ascending order", one rounded add each:
//   * x = 1: fma(1, e, acc) rounds 1 * e + acc = e + acc once, which is
//     __fadd_rn(acc, e), signed zeros included (both follow IEEE addition);
//   * x = +0 or -0: fma(x, e, acc) rounds x * e + acc, where x * e is a zero
//     (e finite) of either sign.  acc + (±0) is acc for any acc other than
//     -0, and acc is never -0: it starts at +0, and a rounded sum is -0 only
//     when both addends are -0 (an exact zero sum of nonzero addends is +0
//     under round to nearest).  So the row leaves acc as it is;
//   * e = ±inf or NaN with x = 0 gives NaN in the chain and nothing in the
//     bit form, so a non-finite e sends the block to the chain itself.
// So the kernel builds one 32-bit mask per word-line row and IR block (bit r
// set where x != 0, by ballots) and, per row and plane row, adds e under a
// predicate taken from the mask.  Counts with x and g both in {0,1} are
// exact integers (< 2^24), which any order gives, so they are sums of
// popcount(x mask & g mask); a block whose x or g holds another value ends
// that for the tile, and its counts are recomputed in the epilogue as the
// chain over all R rows from device memory.  A block with x outside {0,1}
// or a non-finite e takes the FFMA chain over its staged floats.  Which way
// a block goes never changes a bit.
//
// What bounds it on the H100, at the detector's s0b1 shape (C=4,
// B=294,912, R=572, N=60): the block currents are 8.1e10 rounded adds (or
// FFMAs), 2.4 ms at the FP32 pipe's 67 TFLOP/s, against 1.06 ms of device
// memory traffic (3.55 GB, 2.7 GB of it x).  A tensor-core sum would reorder
// the chains, so this is the kernel's floor.  Each output holds 2 x 18
// block currents from its first IR block to the epilogue, 144 bytes, so an
// SM (256 KB of registers, 228 KB of shared memory) holds the currents of at
// most ~3,000 outputs: a row tile spans 32 word-line rows and 32 columns
// (or 64 and 16), not all 60.  The design:
//   * a thread block owns BM = 32 TM word-line rows and CT = 4 W columns of
//     one chip at a time; lane l of a compute warp owns rows l + 32 i
//     (i < TM), warp w columns 4w..4w+3, so every lane of a warp reads the
//     same plane values: two broadcast float4 reads (e+ and e-) per plane
//     row feed 8 TM predicated adds a lane.  The row tile (BM, TM) is a
//     launch argument, one of `launch_tile`'s (kernels/irc_mvm.py::TILES),
//     picked per problem by the port's autotuner (kernels/autotune.py);
//   * the roles are split by warp and joined by mbarriers, with no barrier
//     of the whole block per IR block: one warp stages each (tile, IR block)
//     step by TMA (the x rows, the e+ and e- slices, and per tile the SA
//     offsets and the range fallback bits) into a ring of 4 stages; TM warps
//     build the x masks and verdicts of a staged step, one more the e
//     verdicts; the compute warps add, park and finish.  The grid is
//     persistent (one block an SM), walking the tiles chip by chip, row tile
//     by row tile, column tile fastest, so x rows and planes are reused from
//     L2; operands that TMA cannot address (R or N not a multiple of 4, or
//     misaligned) are staged by the staging warp's cp.async copies instead;
//   * the block currents stay on chip, parked in shared memory as one
//     float4 per row, column pair and IR block, each lane its own words;
//   * the placement planes are read once per (chip, column tile) by each
//     compute warp for its own columns, into masks kept in shared memory,
//     since shared g is the same for every tile of a launch;
//   * the epilogue runs four line currents at once (a column pair's e+ and
//     e-) over the parked float4s, with every loop bound known at compile
//     time where R fills the 18 (or 32) IR blocks.
// Measured on the H100 (chip_smoke.py, phases 4 and `autotune`): 12.9-13.0
// ms at s0b1 and 11.5 ms at the layer chunk (C=4,096, B=256) at (32, 1),
// against 16.7 / 14.9 ms for the earlier design; its compute warps spend two
// thirds of their time in the add loop, which runs at about a third of the
// FP32 pipe's issue rate with or without the predicates and the broadcast
// reads (PERF.md), and a tenth in the epilogue.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::cp_async4;
using hopper::cp_async_mbar_arrive;
using hopper::mbar_arrive;
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::tma_load_3d;

constexpr int kBlk = 32;            // rows per IR-drop block

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

// Four independent line currents at once (their adds interleave): chain
// c's block k current is pk[k * stride].c (c = x, y, z, w; shared memory).
// FULL: nb == NB, so every bound is known at compile time.
template <int NB, bool FULL>
__device__ __forceinline__ float4 line_currents(const float4* pk, int stride,
                                                int nb_rt, float alpha,
                                                bool ir) {
  constexpr int C = 4;
  const int nb = FULL ? NB : nb_rt;
  auto at = [&](int k, float (&v)[C]) {
    const float4 q = pk[k * stride];
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  };
  float res[C];
  if (!ir) {
    at(0, res);
#pragma unroll
    for (int k = 1; k < NB; ++k)
      if (k < nb) {
        float v[C];
        at(k, v);
#pragma unroll
        for (int c = 0; c < C; ++c) res[c] = __fadd_rn(res[c], v[c]);
      }
    return make_float4(res[0], res[1], res[2], res[3]);
  }
  // suffix sums: the scan runs over q = nb - 1 - k, block nb - 1 first
  float S[NB][C];
  float local[C], carry[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    local[c] = 0.0f;
    carry[c] = 0.0f;
  }
#pragma unroll
  for (int k = NB - 1; k >= 0; --k) {
#pragma unroll
    for (int c = 0; c < C; ++c) S[k][c] = 0.0f;
    if (k < nb) {
      const int q = nb - 1 - k;
      float v[C];
      at(k, v);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (q % kScan == 0) {
          if (k + 1 < NB && q > 0) carry[c] = S[k + 1][c];
          local[c] = v[c];
        } else {
          local[c] = __fadd_rn(local[c], v[c]);
        }
        S[k][c] = (q < kScan) ? local[c] : __fadd_rn(local[c], carry[c]);
      }
    }
  }
  float prev[C], line[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    prev[c] = 0.0f;
    line[c] = 0.0f;
    local[c] = 0.0f;
    carry[c] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    if (k < nb) {
      float v[C];
      at(k, v);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (k % kScan == 0) {
          if (k > 0) carry[c] = prev[c];
          local[c] = S[k][c];
        } else {
          local[c] = __fadd_rn(local[c], S[k][c]);
        }
        prev[c] = (k < kScan) ? local[c] : __fadd_rn(local[c], carry[c]);
        const float cum = __fadd_rn(prev[c], -S[0][c]);
        const float f =
            fminf(fmaxf(__fmaf_rn(-alpha, cum, 1.0f), 0.0f), 1.0f);
        line[c] = (k == 0) ? __fmul_rn(v[c], f) : __fmaf_rn(v[c], f, line[c]);
      }
    }
  }
  return make_float4(line[0], line[1], line[2], line[3]);
}

__device__ __forceinline__ bool is_bit(float v) {
  return v == 0.0f || v == 1.0f;
}

// One row tile's layout: BM = 32 TM word-line rows x CT = TN W columns.
// Warps 0..W-1 compute (lane l: rows l + 32 i, i < TM; warp w: columns
// TN w..TN w+TN-1), warp W stages (TMA), warps W+1..W+TM build the x masks
// and their verdicts, warp W+TM+1 checks that e is finite.  Every IR
// block's currents are parked in shared memory, each lane its own words.
// Sizes in floats.
template <int NB, int TM>
struct Cfg {
  static constexpr int TN = 4;
  static constexpr int W = (NB <= 18 ? 8 : 4) / TM;
  static constexpr int BM = 32 * TM;
  static constexpr int CT = TN * W;
  static constexpr int kThreads = 32 * (W + 2 + TM);
  static constexpr int S = 4;                  // stages in the ring
  static constexpr int kX = BM * kBlk;         // staged x, [BM][32]
  static constexpr int kE = kBlk * CT;         // staged e+ (then e-), [32][CT]
  static constexpr int kStage = kX + 2 * kE;
  static constexpr int kSide = BM + 1 + TM;    // row masks, bad e columns,
                                               // each mask warp's x verdict
  static constexpr int kEpi = BM * CT;         // eps (then rnd) of a tile
  static constexpr int kV = 2 * TN * TM;       // currents a lane and IR block
  static constexpr int kGW = 2 * TN + 1;       // a warp's g masks + verdict
  static constexpr int kPark = NB * kV * 32 * W;
  static constexpr int kFloats = S * kStage + 2 * 2 * kEpi + S * kSide
                                 + W * NB * kGW + kPark;
  static constexpr int kSmemBytes = 4 * kFloats + 8 * (3 * S + 4) + 24;
  static_assert(kStage % 32 == 0 && kEpi % 32 == 0, "128-byte TMA boxes");
  static_assert(CT <= 32, "the finite-column verdict is one word");
  static_assert(kSmemBytes <= 232448, "the H100's opt-in shared memory");
};

struct Geo {
  int c, row0, col0, ct;
};

// tile -> (chip, row tile, column tile), column tile fastest
template <int BM, int CT>
__device__ __forceinline__ Geo geo_of(int t, int row_tiles, int col_tiles) {
  const int ct = t % col_tiles;
  const int r = t / col_tiles;
  return Geo{r / row_tiles, (r % row_tiles) * BM, ct * CT, ct};
}

// One step of a block's stream: IR block k of row tile `tile`, with the
// tile's geometry (worked out once a tile, not once a step).
struct Step {
  int tile, k;
  Geo g;
};

template <int BM, int CT>
__device__ __forceinline__ Step next_step(Step s, int nb, int stride,
                                          int row_tiles, int col_tiles) {
  if (s.k + 1 < nb) return Step{s.tile, s.k + 1, s.g};
  const int t = s.tile + stride;
  return Step{t, 0, geo_of<BM, CT>(t, row_tiles, col_tiles)};
}

struct Problem {
  const float *x, *ep, *en, *gp, *gn, *eps, *rnd;
  float* out;
  int B, R, N, nb, row_tiles, col_tiles, n_tiles, x_chips, tma;
  long long x_chip_stride, g_chip_stride;
};

struct Maps {
  CUtensorMap x, ep, en, eps, rnd;
};

// The staging warp's copies without TMA (R or N not a multiple of 4, or a
// misaligned operand): 4-byte cp.async by its 32 lanes, zero-filled past
// the edges, each lane arriving on `bar` once its copies land.
__device__ __forceinline__ void copy_box(float* dst, const float* base,
                                         int d0, int d1, int c0, int c1,
                                         int box0, int box1, int lane) {
  for (int e = lane; e < box0 * box1; e += 32) {
    const int i1 = e / box0, i0 = e % box0;
    const bool ok = c0 + i0 < d0 && c1 + i1 < d1;
    cp_async4(dst + e, ok ? base + (long long)(c1 + i1) * d0 + c0 + i0 : base,
              ok);
  }
}

// A warp's placement-plane masks of its own TN columns for every IR block
// of a (chip, column tile), read from device memory with lane = plane row:
// gc[kGW k + j] (g+ of column j), gc[kGW k + TN + j] (g-),
// gc[kGW k + 2 TN] the verdict that all of them are 0 or 1.
template <int TN>
__device__ __forceinline__ void build_gmasks(unsigned* gc, const float* gpc,
                                             const float* gnc, int n0,
                                             int lane, const Problem& p) {
  constexpr int kGW = 2 * TN + 1;
  for (int k = 0; k < p.nb; ++k) {
    const int r = k * kBlk + lane;
    float vp[TN], vn[TN];
    bool ok = true;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const bool in = r < p.R && n0 + j < p.N;
      const long long o = (long long)r * p.N + n0 + j;
      vp[j] = in ? gpc[o] : 0.0f;
      vn[j] = in ? gnc[o] : 0.0f;
      ok = ok && is_bit(vp[j]) && is_bit(vn[j]);
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const unsigned mp = __ballot_sync(0xffffffffu, vp[j] != 0.0f);
      const unsigned mn = __ballot_sync(0xffffffffu, vn[j] != 0.0f);
      if (lane == 0) {
        gc[kGW * k + j] = mp;
        gc[kGW * k + TN + j] = mn;
      }
    }
    ok = __all_sync(0xffffffffu, ok);
    if (lane == 0) gc[kGW * k + 2 * TN] = ok;
  }
  __syncwarp();
}

// Where t != 0, a row's currents s[o..o+7] += e+ values a and e- values b
// of its 4 columns, in column-pair order {a0, a1, b0, b1, a2, a3, b2, b3}:
// one predicate, eight rounded adds.
template <int V>
__device__ __forceinline__ void add_if(unsigned t, float (&s)[V], int o,
                                       float4 a, float4 b) {
  asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %8, 0;\n\t"
      "@p add.rn.f32 %0, %0, %9;\n\t@p add.rn.f32 %1, %1, %10;\n\t"
      "@p add.rn.f32 %2, %2, %11;\n\t@p add.rn.f32 %3, %3, %12;\n\t"
      "@p add.rn.f32 %4, %4, %13;\n\t@p add.rn.f32 %5, %5, %14;\n\t"
      "@p add.rn.f32 %6, %6, %15;\n\t@p add.rn.f32 %7, %7, %16;\n\t}"
      : "+f"(s[o]), "+f"(s[o + 1]), "+f"(s[o + 2]), "+f"(s[o + 3]),
        "+f"(s[o + 4]), "+f"(s[o + 5]), "+f"(s[o + 6]), "+f"(s[o + 7])
      : "r"(t), "f"(a.x), "f"(a.y), "f"(b.x), "f"(b.y), "f"(a.z), "f"(a.w),
        "f"(b.z), "f"(b.w));
}

// One IR block's currents of the lane's TM rows x 4 columns x 2 planes,
// from +0, on the bit path: sp/sn point at the warp's columns of plane row
// 0 of e+ and e- (each plane row one broadcast float4 read: every lane
// reads the same words), xm holds the rows' masks.  Row i's currents are
// acc[8 i ..], four a column pair: {e+ j, e+ j+1, e- j, e- j+1}.  Plane rows
// go in chunks of 4, the next chunk loaded while one is added.
template <int TM, int CT, int V>
__device__ __forceinline__ void currents_bits(float (&acc)[V],
                                              const float* sp,
                                              const float* sn,
                                              const unsigned (&xm)[TM]) {
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
  float4 a0[4], b0[4], a1[4], b1[4];
  auto load4 = [&](float4 (&a)[4], float4 (&b)[4], int kk) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a[u] = *reinterpret_cast<const float4*>(sp + (kk + u) * CT);
      b[u] = *reinterpret_cast<const float4*>(sn + (kk + u) * CT);
    }
  };
  auto add4 = [&](const float4 (&a)[4], const float4 (&b)[4], int kk) {
    unsigned m[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) m[i] = xm[i] >> kk;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < TM; ++i)
        add_if(m[i] & (1u << u), acc, 8 * i, a[u], b[u]);
  };
  load4(a0, b0, 0);
#pragma unroll 1
  for (int kk = 0; kk < kBlk; kk += 8) {
    load4(a1, b1, kk + 4);
    add4(a0, b0, kk);
    if (kk + 8 < kBlk) load4(a0, b0, kk + 8);
    add4(a1, b1, kk + 4);
  }
}

// The same block currents as the FFMA chain over the staged x floats (a
// block with x outside {0,1} or a non-finite e); xs points at the staged x
// tile, rows lane + 32 i.
template <int TM, int CT, int V>
__device__ __forceinline__ void currents_chain(float (&acc)[V],
                                               const float* sp,
                                               const float* sn,
                                               const float* xs, int lane) {
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
#pragma unroll 1
  for (int kk = 0; kk < kBlk; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(sp + kk * CT);
    const float4 b = *reinterpret_cast<const float4*>(sn + kk * CT);
    const float ev[8] = {a.x, a.y, b.x, b.y, a.z, a.w, b.z, b.w};
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float xv = xs[(lane + 32 * i) * kBlk + kk];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        acc[8 * i + q] = __fmaf_rn(xv, ev[q], acc[8 * i + q]);
    }
  }
}

template <int NB, int TM>
__global__ void __launch_bounds__(Cfg<NB, TM>::kThreads, 1)
irc_mvm_chips_kernel(const __grid_constant__ Maps maps, const Problem p,
                     const Params prm) {
  using K = Cfg<NB, TM>;
  constexpr int TN = K::TN, CT = K::CT, W = K::W, S = K::S;
  extern __shared__ __align__(128) float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);
  float* epi = stages + S * K::kStage;               // [2][eps, rnd]
  unsigned* side = reinterpret_cast<unsigned*>(epi + 4 * K::kEpi);
  unsigned* gcache_all = side + S * K::kSide;
  float* park = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(gcache_all + W * NB * K::kGW) + 15) &
      ~uintptr_t(15));
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(park + K::kPark) + 7) & ~uintptr_t(7));
  uint64_t* full = bars;            // a stage landed (TMA or copies)
  uint64_t* ready = bars + S;       // ... and its masks and verdicts built
  uint64_t* empty = bars + 2 * S;   // ... and every compute warp done with it
  uint64_t* efull = bars + 3 * S;   // a tile's eps and rnd landed [2]
  uint64_t* eempty = efull + 2;     // ... and every compute warp done [2]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nb = p.nb;
  const int stride = gridDim.x;
  if (tid == 0) {
    const uint32_t copiers = p.tma ? 1 : 32;
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], copiers);
      mbar_init(&ready[i], TM + 1);
      mbar_init(&empty[i], W);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&efull[i], copiers);
      mbar_init(&eempty[i], W);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  auto first = [&]() {
    const int t = blockIdx.x;
    return Step{t, 0, geo_of<K::BM, CT>(t, p.row_tiles, p.col_tiles)};
  };
  auto next = [&](Step st) {
    return next_step<K::BM, CT>(st, nb, stride, p.row_tiles, p.col_tiles);
  };

  if (warp == W) {
    // ---------------------------------------------------------- staging
    int q = 0;                        // tiles staged
    int s = 0;                        // steps staged
    for (Step st = first(); st.tile < p.n_tiles; st = next(st), ++s) {
      const Geo& g = st.g;
      const int xc = p.x_chips > 1 ? g.c : 0;
      if (st.k == 0) {                // the tile's eps and rnd
        const int eb = q & 1;
        if (q >= 2) mbar_wait(&eempty[eb], ((q >> 1) - 1) & 1);
        float* de = epi + 2 * eb * K::kEpi;
        if (p.tma) {
          if (lane == 0) {
            mbar_arrive_expect_tx(&efull[eb], 2 * 4 * K::kEpi);
            tma_load_3d(de, &maps.eps, &efull[eb], g.col0, g.row0, g.c);
            tma_load_3d(de + K::kEpi, &maps.rnd, &efull[eb], g.col0, g.row0,
                        g.c);
          }
        } else {
          const long long o = (long long)g.c * p.B * p.N;
          copy_box(de, p.eps + o, p.N, p.B, g.col0, g.row0, CT, K::BM, lane);
          copy_box(de + K::kEpi, p.rnd + o, p.N, p.B, g.col0, g.row0, CT,
                   K::BM, lane);
          cp_async_mbar_arrive(&efull[eb]);
        }
        ++q;
      }
      const int slot = s % S;
      if (s >= S) mbar_wait(&empty[slot], ((s / S) - 1) & 1);
      float* d = stages + slot * K::kStage;
      const int r0 = st.k * kBlk;
      if (p.tma) {
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[slot], 4 * (K::kX + 2 * K::kE));
          tma_load_3d(d, &maps.x, &full[slot], r0, g.row0, xc);
          tma_load_3d(d + K::kX, &maps.ep, &full[slot], g.col0, r0, g.c);
          tma_load_3d(d + K::kX + K::kE, &maps.en, &full[slot], g.col0, r0,
                      g.c);
        }
      } else {
        copy_box(d, p.x + xc * p.x_chip_stride, p.R, p.B, r0, g.row0, kBlk,
                 K::BM, lane);
        const long long o = (long long)g.c * p.R * p.N;
        copy_box(d + K::kX, p.ep + o, p.N, p.R, g.col0, r0, CT, kBlk, lane);
        copy_box(d + K::kX + K::kE, p.en + o, p.N, p.R, g.col0, r0, CT, kBlk,
                 lane);
        cp_async_mbar_arrive(&full[slot]);
      }
    }
    return;
  }

  if (warp > W) {
    // ------------------------- x masks and verdicts, or e finite verdicts
    const int hw = warp - W - 1;      // 0..TM-1: x rows 32 hw.., TM: e check
    int s = 0;
    for (Step st = first(); st.tile < p.n_tiles; st = next(st), ++s) {
      const int slot = s % S;
      mbar_wait(&full[slot], (s / S) & 1);
      const float* d = stages + slot * K::kStage;
      unsigned* sd = side + slot * K::kSide;
      if (hw < TM) {
        bool ok = true;
        unsigned mine = 0;            // lane r: the mask of row 32 hw + r
#pragma unroll 1
        for (int r8 = 0; r8 < 32; r8 += 8) {
          float v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            v[u] = d[(32 * hw + r8 + u) * kBlk + lane];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            ok = ok && is_bit(v[u]);
            const unsigned m = __ballot_sync(0xffffffffu, v[u] != 0.0f);
            if (lane == r8 + u) mine = m;
          }
        }
        sd[32 * hw + lane] = mine;
        ok = __all_sync(0xffffffffu, ok);
        if (lane == 0) sd[K::BM + 1 + hw] = ok;
      } else {
        // lane = a quad of 4 columns in plane rows lane / Q + (32 / Q) t:
        // the magnitudes of e+ and e- summed per column (an overflow only
        // sends the block to the chain); bit j of sd[BM] set where column j
        // of e+ or e- holds a non-finite value
        constexpr int Q = CT / 4;
        const float* de = d + K::kX;
        const int quad = lane % Q;
        float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int t = 0; t < Q; ++t) {
          const int kk = lane / Q + (32 / Q) * t;
          const float4 a =
              *reinterpret_cast<const float4*>(de + kk * CT + 4 * quad);
          const float4 b = *reinterpret_cast<const float4*>(
              de + K::kE + kk * CT + 4 * quad);
          sum[0] += fabsf(a.x) + fabsf(b.x);
          sum[1] += fabsf(a.y) + fabsf(b.y);
          sum[2] += fabsf(a.z) + fabsf(b.z);
          sum[3] += fabsf(a.w) + fabsf(b.w);
        }
        unsigned period = 0;          // the lanes of one quad
#pragma unroll
        for (int l = 0; l < 32; l += Q) period |= 1u << l;
        unsigned badcol = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const unsigned bad =
              __ballot_sync(0xffffffffu, !(sum[c] <= 3.4028235e38f));
#pragma unroll
          for (int qq = 0; qq < Q; ++qq)
            if (bad & (period << qq)) badcol |= 1u << (4 * qq + c);
        }
        if (lane == 0) sd[K::BM] = badcol;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&ready[slot]);
    }
    return;
  }

  // ------------------------------------------------------------ compute
  unsigned* gcache = gcache_all + warp * NB * K::kGW;
  // this lane's parked currents: float4 [k][row, column pair][lane]
  float4* park4 = reinterpret_cast<float4*>(park) + tid;
  constexpr int kLanes = 32 * W;
  const bool ir = prm.flags & kIrDrop;
  const bool to_diff = prm.flags & kOutputDiff;
  int gc_c = -1, gc_ct = -1;          // the (chip, column tile) of gcache
  int s = 0, q = 0;
  for (Step st = first(); st.tile < p.n_tiles; ++q) {
    const Geo g = st.g;
    const int n0 = g.col0 + TN * warp;
    const int gkey = p.g_chip_stride ? g.c : 0;
    if (gkey != gc_c || g.ct != gc_ct) {
      build_gmasks<TN>(gcache, p.gp + gkey * p.g_chip_stride,
                       p.gn + gkey * p.g_chip_stride, n0, lane, p);
      gc_c = gkey;
      gc_ct = g.ct;
    }
    // counts: g+ in the low 16 bits, g- in the high 16, while `exact`
    unsigned cnt[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) cnt[i][j] = 0u;
    bool exact = true;

#pragma unroll 1
    for (int k = 0; k < nb; ++k, ++s, st = next(st)) {
      const int slot = s % S;
      mbar_wait(&ready[slot], (s / S) & 1);
      const float* d = stages + slot * K::kStage;
      const unsigned* sd = side + slot * K::kSide;
      unsigned xm[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) xm[i] = sd[lane + 32 * i];
      bool xbits = true;
#pragma unroll
      for (int mw = 0; mw < TM; ++mw) xbits = xbits && sd[K::BM + 1 + mw];
      const unsigned colbad = sd[K::BM] >> (TN * warp);
      const bool efin = (colbad & ((1u << TN) - 1u)) == 0u;
      const unsigned* gk = gcache + K::kGW * k;
      if (exact) {
        if (xbits && gk[2 * TN]) {
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const unsigned mp = gk[j], mn = gk[TN + j];
#pragma unroll
            for (int i = 0; i < TM; ++i)
              cnt[i][j] += __popc(xm[i] & mp) + (__popc(xm[i] & mn) << 16);
          }
        } else {
          exact = false;
        }
      }
      const float* sp = d + K::kX + TN * warp;
      const float* sn = sp + K::kE;
      float acc[K::kV];
      if (xbits && efin)
        currents_bits<TM, CT>(acc, sp, sn, xm);
      else
        currents_chain<TM, CT>(acc, sp, sn, d, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      float4* pk = park4 + k * (K::kV / 4) * kLanes;
#pragma unroll
      for (int v = 0; v < K::kV / 4; ++v)
        pk[v * kLanes] = make_float4(acc[4 * v], acc[4 * v + 1],
                                     acc[4 * v + 2], acc[4 * v + 3]);
    }

    // epilogue: the lane's outputs, a row at a time, its TN columns and
    // both planes as independent chains over the parked currents
    const int eb = q & 1;
    mbar_wait(&efull[eb], (q >> 1) & 1);
    const float* de = epi + 2 * eb * K::kEpi;
    const long long xcs = (p.x_chips > 1 ? g.c : 0) * p.x_chip_stride;
    const long long gcs = gkey * p.g_chip_stride;
    const int pstride = (K::kV / 4) * kLanes;
#pragma unroll 1
    for (int i = 0; i < TM; ++i) {
      const int rr = lane + 32 * i;
      const int b = g.row0 + rr;
      unsigned ci[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        ci[j] = 0u;
#pragma unroll
        for (int i2 = 0; i2 < TM; ++i2)
          if (i2 == i) ci[j] = cnt[i2][j];
      }
#pragma unroll
      for (int jp = 0; jp < TN; jp += 2) {
        // the e+ and e- currents of columns jp, jp + 1: four chains
        const float4* pj = park4 + (TN / 2 * i + jp / 2) * kLanes;
        const float4 l4 =
            nb == NB ? line_currents<NB, true>(pj, pstride, nb, prm.ir_alpha,
                                               ir)
                     : line_currents<NB, false>(pj, pstride, nb,
                                                prm.ir_alpha, ir);
        const float lc[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = jp + jj;
          const int n = n0 + j;
          if (b >= p.B || n >= p.N) continue;
          const float eps_v = de[rr * CT + TN * warp + j];
          const float rnd_v = de[K::kEpi + rr * CT + TN * warp + j];
          float cp, cn;
          if (exact) {
            cp = (float)(ci[j] & 0xffffu);
            cn = (float)(ci[j] >> 16);
          } else {                    // the chain over all R rows
            const float* xr = p.x + xcs + (long long)b * p.R;
            cp = 0.0f;
            cn = 0.0f;
            for (int r = 0; r < p.R; ++r) {
              const float xv = xr[r];
              const long long og = gcs + (long long)r * p.N + n;
              cp = __fmaf_rn(xv, p.gp[og], cp);
              cn = __fmaf_rn(xv, p.gn[og], cn);
            }
          }
          float i_pos = lc[jj], i_neg = lc[2 + jj];
          float diff;
          if (prm.flags & kNonlinearity) {
            const float r_pos = nl_ratio(cp);
            i_neg = __fmul_rn(i_neg, nl_ratio(cn));
            if ((prm.flags & kRange) && !to_diff) {
              i_pos = __fmul_rn(i_pos, r_pos);
              diff = __fadd_rn(i_pos, -i_neg);
            } else {
              diff = __fmaf_rn(i_pos, r_pos, -i_neg);
            }
          } else {
            diff = __fadd_rn(i_pos, -i_neg);
          }
          const long long oi = ((long long)g.c * p.B + b) * p.N + n;
          if (to_diff) {
            p.out[oi] = diff;
            continue;
          }
          if (prm.flags & kSa) {
            const float pp = __fadd_rn(cp, cn);
            float sg = __fmaf_rn(__fmul_rn(prm.sa_c2, pp), pp,
                                 __fmaf_rn(prm.sa_c1, pp, prm.sa_c0));
            sg = __fmul_rn(0.5f, __fadd_rn(sg, prm.sa_extra));
            diff = __fmaf_rn(sg, eps_v, diff);
          }
          float res = diff > 0.0f ? 1.0f : 0.0f;
          if (prm.flags & kRange) {
            const bool fail = fminf(i_pos, i_neg) < prm.sense_low ||
                              fmaxf(i_pos, i_neg) > prm.sense_high;
            if (fail) res = rnd_v;
          }
          p.out[oi] = res;
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&eempty[eb]);
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// A tensor map over a contiguous float32 array [d2][d1][d0] (d0 innermost)
// whose boxes are [1][box1][box0], unswizzled (the kernel's shared-memory
// tiles are row-major); elements outside the array read as zero.
cudaError_t encode_3d(CUtensorMap* map, const float* base, uint64_t d0,
                      uint64_t d1, uint64_t d2, uint32_t box0,
                      uint32_t box1) {
  return hopper::encode_tiled_3d(map, base, d0, d1, d2, box0, box1,
                                 CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                                 /*swizzle=*/false);
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

template <int NB, int TM>
cudaError_t launch(const Args& a) {
  using K = Cfg<NB, TM>;
  auto kern = irc_mvm_chips_kernel<NB, TM>;
  // the persistent grid's size, once per device
  static int dev_seen = -1, grid_max = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != dev_seen) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, K::kSmemBytes);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, K::kThreads, K::kSmemBytes);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    grid_max = sms * per_sm;
    dev_seen = dev;
  }
  const int x_chips = a.x_chip_stride ? a.C : 1;
  Problem p{a.x, a.ep, a.en, a.gp, a.gn, a.eps, a.rnd, a.out, a.B, a.R, a.N,
            (a.R + kBlk - 1) / kBlk, (a.B + K::BM - 1) / K::BM,
            (a.N + K::CT - 1) / K::CT, 0, x_chips, 0, a.x_chip_stride,
            a.g_chip_stride};
  const long long tiles = (long long)a.C * p.row_tiles * p.col_tiles;
  if (tiles > 2147483647LL - grid_max) return cudaErrorInvalidValue;
  p.n_tiles = (int)tiles;
  // TMA needs 16-byte aligned operands and row strides
  p.tma = a.R % 4 == 0 && a.N % 4 == 0 && aligned(a.x, 16) &&
          aligned(a.ep, 16) && aligned(a.en, 16) && aligned(a.eps, 16) &&
          aligned(a.rnd, 16);
  Maps maps;
  if (p.tma) {
    err = encode_3d(&maps.x, a.x, a.R, a.B, x_chips, kBlk, K::BM);
    if (err == cudaSuccess)
      err = encode_3d(&maps.ep, a.ep, a.N, a.R, a.C, K::CT, kBlk);
    if (err == cudaSuccess)
      err = encode_3d(&maps.en, a.en, a.N, a.R, a.C, K::CT, kBlk);
    if (err == cudaSuccess)
      err = encode_3d(&maps.eps, a.eps, a.N, a.B, a.C, K::CT, K::BM);
    if (err == cudaSuccess)
      err = encode_3d(&maps.rnd, a.rnd, a.N, a.B, a.C, K::CT, K::BM);
    if (err != cudaSuccess) return err;
  }
  const int grid = p.n_tiles < grid_max ? p.n_tiles : grid_max;
  kern<<<grid, K::kThreads, K::kSmemBytes, a.stream>>>(maps, p, a.prm);
  return cudaGetLastError();
}

// The row tiles (BM, TM), the same list as kernels/irc_mvm.py::TILES; any
// other tile is refused.
template <int NB>
cudaError_t launch_tile(int bm, int tm, const Args& a) {
  if (bm == 32 && tm == 1) return launch<NB, 1>(a);
  if (bm == 64 && tm == 2) return launch<NB, 2>(a);
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
  if (C <= 0 || B <= 0 || R <= 0 || N <= 0)
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
