// Causal flash attention (online softmax) for NVIDIA Hopper (sm_90a), in
// two legs, float32 and bfloat16 inputs, both on the tensor cores with
// wgmma (hopper.cuh) at the reference's float32 precision.  Plain C
// interface, loaded with ctypes by
// repro_torch/kernels/flash_attention_cuda.py.
//
// Both replace the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py; body `_flash_kernel`).  Its plain
// PyTorch version is repro_torch/kernels/ref.py::flash_attention_ref.
//
// What it computes, per head h and query row i < Sq:
//   s[j]  = (q[h,i,:] . k[h,j,:]) * scale     for key j < Sk, j <= i
//   out   = sum_j softmax(s)[j] * v[h,j,:]
// with keys j > i (the future) and j >= Sk (past the ragged end) masked
// out, as the plain version masks them; the output is in q's dtype.
// Layouts: q [H,Sq,hd], k/v [H,Sk,hd], out [H,Sq,hd], contiguous, all f32
// or all bf16.  Ragged Sq and Sk are masked here; the caller pads nothing.
// The reference computes in f32 throughout (scores, max, denominator, the
// softmax weights p and the accumulator), and so do both legs.
//
// The work: 2*H*hd multiply-adds for QK^T and as many for PV per causal
// (query, key) pair, 1.37e11 operations each at chameleon-34b's 64 heads
// x 4096 x 128, against 0.27 (bf16) or 0.54 GB (f32) of traffic: both legs
// are bound by operations.  The product of two bf16 values is exact in
// f32, and an f32 value splits exactly into three bf16 parts, so each leg
// runs its products as a few bf16 tensor-core passes into f32
// accumulators; neither rounds an operand as TF32 would.
//
// Both legs share one skeleton:
//   * one block per (head, tile of 128 query rows), heaviest causal tiles
//     first; two consumer warpgroups of 64 query rows each (wgmma's M)
//     and a producer warpgroup that gives them its registers (setmaxnreg:
//     the 384 threads launch with 168 registers each, ptxas's cap, and the
//     producer's 144 go to the consumers, 240 a consumer thread, 24 a
//     producer thread);
//   * loads by TMA from tiled tensor maps (3-d, so rows past Sq or Sk of
//     a head read as zeros, never the next head's), encoded per call on
//     the host: Q once, K and V tile by tile into rings with full and
//     empty mbarriers.  Rows are swizzled to their bytes (32, 64 or 128);
//     hd = 128 is two 64-column panels;
//   * S = Q K^T by wgmma, K from shared memory; scale, mask (only on tiles
//     at the causal or ragged edge), row max (quad shuffles), alpha and
//     p = exp(s - m) in registers, exp as 2^x on the MUFU (`ex2`); no P
//     tile touches shared memory: the accumulator's fragment of 16 keys is
//     the A fragment of register-A wgmma m64n{hd}k16, which runs once per
//     bf16 part of p, B = V MN-major (transpose bit);
//   * each warpgroup issues tile j's QK^T and tile j-1's P V together and
//     runs tile j's softmax while they are on the tensor cores; O is
//     rescaled by tile j's alpha once P V has landed;
//   * out = O / max(l, 1e-20), rows past Sq masked.
//   The caller's bq and bk are checked but pick nothing in either leg.
//
// The bf16 leg (bf16 != 0): QK^T on bf16 inputs is one bf16 pass; p needs
// f32's 24 bits, so it splits into three bf16 parts rounded to nearest
// (p = hi + mid + lo, `split3_rn`) and P V is three passes into one f32
// accumulator (one pass would round p to bf16, sdpa's choice).  Its bound
// is 1 + 3 bf16 passes at 989 TFLOP/s (0.556 ms at chameleon-34b's shape)
// beside exp on the MUFU (~0.13 ms) and the bytes (0.08 ms).  Key tiles of
// 64 rows through a 3-stage ring of K and V (in trials a 2-stage ring ran
// slower, a 4-stage one no faster); Q from shared memory.  The S
// accumulator (32 f32 a thread),
// the three bf16 parts of the previous tile's P (48 registers) and the
// hd = 128 output accumulator (64) fit in 240 registers without spilling.
// The output is rounded once to bf16.
//
// The f32 leg (bf16 == 0), bf16x6: q, k, v and p each split exactly into
// three bf16 parts by truncation (hopper.cuh's `split3`; the plain version
// is ref.py::bf16x3_split_masked).  Of the nine products of two split
// operands a = a0 + a1 + a2 and b = b0 + b1 + b2 it keeps six, a0 b0,
// a0 b1, a1 b0, a0 b2, a2 b0 and a1 b1, and drops a1 b2, a2 b1 and a2 b2,
// each under 2^-22 of |a b|: 6 passes for QK^T and 6 for P V, a bound of
// 12 bf16 passes (1.668 ms at chameleon-34b's shape, against 4.104 ms for
// both products on the FFMA pipes).  Each product's passes go smallest
// term first, so a tensor-core accumulator that truncates its adds meets
// the small terms while it is small.
//   * the parts of k and v come from a pre-pass (`split_kernel`, one
//     launch for both) into scratch that the wrapper allocates,
//     [3][H][Sk][hd] bf16 each (0.40 GB at chameleon-34b's shape); the
//     main kernel TMA-loads them as the bf16 leg loads its inputs, the
//     part index folded into the tensor map's head axis;
//   * q takes no shared memory: each consumer thread loads its A fragments
//     of q (f32) once and splits them in registers, 96 at hd = 128, and
//     QK^T is register-A wgmma m64n32k16, 6 terms x hd/16 k-steps into S
//     (16 f32 a thread), K from shared memory.  In trials q's parts as
//     wgmma's A from shared memory ran 3-8% slower, and q split by the
//     pre-pass and TMA-loaded 3-9% slower;
//   * key tiles of 32 rows: S, p's parts (24 registers), q's parts and O
//     (64) fit the consumers' 240 registers, where 64-key tiles (S 32, p
//     48) would not.  K and V in separate 2-slot rings (4 x 24 KiB at hd =
//     128): a K slot frees once its QK^T has landed and a V slot once its
//     P V has, so every load has a whole iteration to land;
//   * P V accumulates into O on the tensor cores through every key tile,
//     O rescaled by alpha in f32 between tiles.  With truncating adds that
//     accumulator drifts with depth: 8.3e-6 at chameleon-34b's shape, 0.18
//     of the tolerance (atol 2e-5, rtol 1e-4).  A fresh accumulator per
//     tile, added to O rounded to nearest, held 1.8e-6 in trials but took
//     64 more registers a thread, past setmaxnreg's 240, and ptxas spilled
//     (144 bytes; 208 at 232, 272 at 224), for no time gained.
//   So two launches per call, the split and the attention.  A trial that
//   split k and v inside the kernel instead (the producer warpgroup
//   loading f32 rows, splitting them and storing the swizzled parts, no
//   scratch) ran 10-20% slower than the pre-pass and the kernel together.
// Later work: a persistent grid (each block's first QK^T and last PV are
// not overlapped); for the f32 leg, a split inside the kernel that keeps
// more loads in flight than that trial did.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// ------------------------------------------------------ shared by the legs

constexpr int kBQ = 128;          // query rows per block
constexpr int kConsumers = 256;   // two warpgroups of 64 query rows each
constexpr float kLog2e = 1.4426950408889634f;

// Tiles as TMA writes them: panels of at most 64 columns (128 bytes a row)
// with the swizzle of the panel's row bytes, so hd = 128 is two panels.
template <int HD>
struct Panels {
  static constexpr int kCols = HD < 64 ? HD : 64;
  static constexpr int kRowBytes = 2 * kCols;        // 32, 64 or 128
  static constexpr int kCount = HD / kCols;
};

// 2^x on the special-function unit (MUFU.EX2, an f32 result within 2
// ulp); results below 2^-126 flush to zero, weights of at most 2^-126
// against the row's largest, 1.  exp2f, which keeps them, spends three
// more instructions on each weight.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Masks one tile of BK keys' scores (keys from k0; only when `kMasked`:
// the tile holds keys past Sk or past one of its rows), updates the
// running max m (of the scaled scores, in log2 units) and this thread's
// share l of the row sums, and leaves p = exp(s * scale - max) =
// 2^(s * scale_log2 - m) in sc and the rescale factor of the earlier tiles
// in alpha.  Element i of the accumulator is row row0 + 8 * ((i / 2) % 2),
// key k0 + 8 * (i / 4) + 2 * t + i % 2; the four threads of a quad share a
// row.
template <int BK, bool kMasked>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0,
                                             int Sk, int row0, int t,
                                             float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i / 2) % 2;
    float x = sc[i];
    if (kMasked) {
      const int kj = k0 + 8 * (i / 4) + 2 * t + i % 2;
      if (kj >= Sk || kj > row0 + 8 * r) x = -INFINITY;
    }
    sc[i] = x;
    mx[r] = fmaxf(mx[r], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    alpha[r] = m_new == -INFINITY ? 1.0f : ex2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i / 2) % 2;
    sc[i] = ex2(fmaf(sc[i], scale_log2, -m[r]));
    l[r] += sc[i];
  }
}

// the row sums over each quad: l becomes the whole row's denominator
__device__ __forceinline__ void quad_sum(float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
}

// ------------------------------------------------------------ the bf16 leg

namespace bf16_leg {

constexpr int kBK = 64;           // key rows per tile
constexpr int kStages = 3;        // K/V tiles in flight
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup

// Shared-memory layout of one head dim: Q, then the ring of K and V tiles.
template <int HD>
struct Geometry : Panels<HD> {
  static constexpr int kQPanel = kBQ * Panels<HD>::kRowBytes;   // bytes
  static constexpr int kQBytes = Panels<HD>::kCount * kQPanel;
  static constexpr int kKPanel = kBK * Panels<HD>::kRowBytes;
  static constexpr int kTileBytes = Panels<HD>::kCount * kKPanel;
  static constexpr int kStageBytes = 2 * kTileBytes;    // K then V
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages);
  // + 1024 to align the tiles to the 128-byte swizzle's 1024-byte atom
  static constexpr int kSmem = 1024 + kQBytes + kStages * kStageBytes +
                               kBarBytes;
};

// Two f32 values as bf16x2, the first in the low half (the lower column
// of an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// p = hi + mid + lo, each a bf16 rounded to nearest: hi carries p's top 8
// significant bits, mid the next 8, lo the last 8, exactly for p >= 2^-110
// (below, lo rounds at bf16's smallest subnormal step, an error of at most
// 2^-134 on a weight that small against the row's largest, 1);
// kernels/ref.py::bf16x3_split is the plain version.
__device__ __forceinline__ void split3_rn(float a, float b, uint32_t& hi,
                                          uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const float ra = a - hf.x, rb = b - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const float2 mf = __bfloat1622float2(m);
  hi = pack_bf16(h);
  mid = pack_bf16(m);
  lo = pack_bf16(__floats2bfloat162_rn(ra - mf.x, rb - mf.y));
}

// S = Q K^T for one warpgroup's 64 rows and one key tile: Q and K both
// K-major, each k-step's 32 bytes inside a swizzled row of a panel.
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[kBK / 2],
                                         const uint8_t* q_w,
                                         const uint8_t* kt) {
  using G = Geometry<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int p = kk * 16 / G::kCols;
    const int off = (kk * 16 % G::kCols) * 2;
    wgmma_ss<kBK>(
        sc, make_desc(q_w + p * G::kQPanel + off, 16, 8 * G::kRowBytes,
                      G::kRowBytes),
        make_desc(kt + p * G::kKPanel + off, 16, 8 * G::kRowBytes,
                  G::kRowBytes),
        kk > 0);
  }
}

// O += P V, three passes per k-step on p's bf16 parts.  V is MN-major:
// its k-steps 16 rows apart, its panels (hd = 128) one leading offset
// apart.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&pp)[kBK / 16][3][4],
                                         const uint8_t* vt) {
  using G = Geometry<HD>;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t dv = make_desc(vt + kk * 16 * G::kRowBytes, G::kKPanel,
                                  8 * G::kRowBytes, G::kRowBytes);
#pragma unroll
    for (int part = 0; part < 3; ++part) wgmma_rs_tb<HD>(o, pp[kk][part], dv);
  }
}

// The accumulator's fragment of keys 16 kk .. 16 kk + 15 is the A
// fragment of k-step kk: registers {8 kk + 2 e, 8 kk + 2 e + 1}, e < 4.
__device__ __forceinline__ void split_tile(const float (&sc)[kBK / 2],
                                           uint32_t (&pp)[kBK / 16][3][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split3_rn(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1], pp[kk][0][e],
                pp[kk][1][e], pp[kk][2][e]);
}

// One block per (head, tile of kBQ query rows), heaviest causal tiles
// first.  Warpgroup 2 issues the TMA loads: Q once, then K and V tile by
// tile into a ring of kStages stages; warpgroups 0 and 1 each own 64 query
// rows.  Per key tile a warpgroup computes S = Q K^T with wgmma from shared
// memory (f32 accumulator), scales and masks it and updates the online
// softmax in registers, forming p = exp(s - m) in f32.  Then O += P V with
// wgmma, A = P from registers split into three bf16 parts p = hi + mid +
// lo issued into the one f32 accumulator, so P V is the product of f32 p,
// as in the plain version.  B = V from shared memory.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            __nv_bfloat16* __restrict__ out, int Sq, int Sk,
                            float scale_log2) {
  using G = Geometry<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* s_q = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* s_kv = s_q + G::kQBytes;   // stage s: K, then V
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      s_kv + kStages * G::kStageBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBQ;
  const int h = blockIdx.y;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);   // lane 0 of each warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer: keys past the block's last query row lie wholly in
    // its future, and TMA fills rows past Sq or Sk with zeros.  It gives
    // its registers to the consumers (24 x 128 + 240 x 256 <= 65,536).
    setmaxnreg_dec<24>();
    if (tid == kConsumers) {
      const int n_kt = (min(Sk, q0 + kBQ) + kBK - 1) / kBK;
      mbar_arrive_expect_tx(q_full, G::kQBytes);
      for (int p = 0; p < G::kCount; ++p)
        tma_load_3d(s_q + p * G::kQPanel, &tq, q_full, p * G::kCols, q0, h);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], G::kStageBytes);
        uint8_t* kt = s_kv + s * G::kStageBytes;
        for (int p = 0; p < G::kCount; ++p) {
          tma_load_3d(kt + p * G::kKPanel, &tk, &full[s], p * G::kCols,
                      j * kBK, h);
          tma_load_3d(kt + G::kTileBytes + p * G::kKPanel, &tv, &full[s],
                      p * G::kCols, j * kBK, h);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int t = lane % 4;
  const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;   // and row0 + 8
  const int wg_first = q0 + wg * 64;
  const int n_kt = (min(Sk, wg_first + 64) + kBK - 1) / kBK;
  const uint8_t* q_w = s_q + wg * 64 * G::kRowBytes;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};   // this thread's share of the row sums
  float sc[kBK / 2];           // S, then p, of the newest tile
  float alpha[2];
  uint32_t pp[kBK / 16][3][4];  // the previous tile's p, split

  // the mask is needed where a tile holds keys past Sk or past a row
  auto softmax = [&](int k0) {
    if (k0 + kBK > Sk || k0 + kBK - 1 > wg_first)
      softmax_tile<kBK, true>(sc, m, l, alpha, k0, Sk, row0, t, scale_log2);
    else
      softmax_tile<kBK, false>(sc, m, l, alpha, k0, Sk, row0, t,
                               scale_log2);
  };
  // Tile j's QK^T and tile j-1's P V are issued together; tile j's
  // softmax runs while P V is on the tensor cores, and O is rescaled by
  // tile j's alpha once P V has landed.
  mbar_wait(q_full, 0);
  mbar_wait(&full[0], 0);
  fence_regs(sc);
  wgmma_fence();
  issue_qk<HD>(sc, q_w, s_kv);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(0);
  for (int j = 1; j < n_kt; ++j) {
    const int s = j % kStages;
    const int s_prev = (j - 1) % kStages;
    split_tile(sc, pp);
    mbar_wait(&full[s], (j / kStages) & 1);
    fence_regs(o);
    wgmma_fence();
    issue_qk<HD>(sc, q_w, s_kv + s * G::kStageBytes);
    wgmma_commit();
    issue_pv<HD>(o, pp, s_kv + s_prev * G::kStageBytes + G::kTileBytes);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);
    softmax(j * kBK);
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(&empty[s_prev]);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i / 2) % 2];
  }
  split_tile(sc, pp);
  fence_regs(o);
  wgmma_fence();
  issue_pv<HD>(o, pp,
               s_kv + (n_kt - 1) % kStages * G::kStageBytes + G::kTileBytes);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);

  // out = O / max(l, 1e-20), rounded once to bf16; rows past Sq unwritten
  quad_sum(l);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= Sq) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-20f);
    __nv_bfloat16* orow = out + ((long long)h * Sq + qi) * HD + 2 * t;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
          __floats2bfloat162_rn(o[4 * c + 2 * r] * inv,
                                o[4 * c + 2 * r + 1] * inv);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int H, int Sq, int Sk, float scale, cudaStream_t stream) {
  using G = Geometry<HD>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = encode_tiled_3d(&tq, q, HD, Sq, H, G::kCols, kBQ);
  if (err == cudaSuccess)
    err = encode_tiled_3d(&tk, k, HD, Sk, H, G::kCols, kBK);
  if (err == cudaSuccess)
    err = encode_tiled_3d(&tv, v, HD, Sk, H, G::kCols, kBK);
  if (err != cudaSuccess) return err;
  auto kern = flash_attention_bf16_kernel<HD>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H);
  kern<<<grid, kThreads, G::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Sk, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace bf16_leg

// ------------------------------------------------------------- the f32 leg

namespace f32_leg {

constexpr int kBK = 32;           // key rows per tile
constexpr int kStages = 2;        // slots of the K ring and of the V ring
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup

// Shared-memory layout of one head dim: the ring of K tiles, the ring of
// V tiles (each tile its three parts), the barriers.
template <int HD>
struct Geometry : Panels<HD> {
  static constexpr int kKPanel = kBK * Panels<HD>::kRowBytes;   // bytes
  static constexpr int kPart = Panels<HD>::kCount * kKPanel;  // of a tile
  static constexpr int kTile = 3 * kPart;
  static constexpr int kBarBytes = 8 * 4 * kStages;
  // + 1024 to align the tiles to the 128-byte swizzle's 1024-byte atom
  static constexpr int kSmem = 1024 + 2 * kStages * kTile + kBarBytes;
};

// The six kept terms a_i b_j of two split operands, smallest first (a2 b0,
// a0 b2, a1 b1, a1 b0, a0 b1, a0 b0): the part i of the left operand (q or
// p) and j of the right one (k or v), term t in nibble t.
__device__ __forceinline__ constexpr int term_left(int term) {
  return (0x001102 >> (4 * term)) & 0xF;
}
__device__ __forceinline__ constexpr int term_right(int term) {
  return (0x010120 >> (4 * term)) & 0xF;
}

// k and v -> their bf16 parts, [3][H][Sk][hd] each, k's then v's:
// blockIdx.y picks the tensor, each thread splits float4s.
__global__ void __launch_bounds__(256)
split_kernel(const float4* __restrict__ k, const float4* __restrict__ v,
             uint2* __restrict__ parts, long long n4) {
  const float4* src = blockIdx.y == 0 ? k : v;
  uint2* dst = parts + blockIdx.y * 3 * n4;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n4;
       i += 256LL * gridDim.x) {
    const float4 x = src[i];
    uint2 hi, mid, lo;
    split3(x.x, x.y, hi.x, mid.x, lo.x);
    split3(x.z, x.w, hi.y, mid.y, lo.y);
    dst[i] = hi;
    dst[n4 + i] = mid;
    dst[2 * n4 + i] = lo;
  }
}

// S = Q K^T for one warpgroup's 64 rows and one key tile, the six terms
// of the parts: A = q's parts from registers, B = K from shared memory,
// K-major, each k-step's 32 bytes inside a swizzled row of a panel.
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[kBK / 2],
                                         const uint32_t (&qa)[3][HD / 16][4],
                                         const uint8_t* kt) {
  using G = Geometry<HD>;
#pragma unroll
  for (int term = 0; term < 6; ++term)
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int c = kk * 16 / G::kCols;
      const int off = (kk * 16 % G::kCols) * 2;
      wgmma_rs<kBK>(sc, qa[term_left(term)][kk],
                    make_desc(kt + term_right(term) * G::kPart +
                                  c * G::kKPanel + off,
                              16, 8 * G::kRowBytes, G::kRowBytes),
                    term > 0 || kk > 0);
    }
}

// q's three parts as register-A fragments of the warpgroup's 64 rows
// from q_w (head h's row q0 + 64 wg, row stride HD), split in registers;
// rows at or past `valid` as zeros.  For k-step kk, register e holds row
// lane / 4 + 8 (e % 2) of the warp's 16, columns 16 kk + 2 t + 8 (e / 2)
// and the next.
template <int HD>
__device__ __forceinline__ void load_q(uint32_t (&qa)[3][HD / 16][4],
                                       const float* q_w, int valid, int warp,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = warp * 16 + lane / 4 + 8 * (e % 2);
      const int col = 16 * kk + 2 * (lane % 4) + 8 * (e / 2);
      const float2 x =
          r < valid ? *reinterpret_cast<const float2*>(q_w + r * HD + col)
                    : make_float2(0.0f, 0.0f);
      split3(x.x, x.y, qa[0][kk][e], qa[1][kk][e], qa[2][kk][e]);
    }
}

// O += P V for one key tile, the six terms of p's parts (registers) and
// V's (shared memory, MN-major: k-steps 16 rows apart, panels one leading
// offset apart).
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&pp)[kBK / 16][3][4],
                                         const uint8_t* vt) {
  using G = Geometry<HD>;
#pragma unroll
  for (int term = 0; term < 6; ++term)
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs_tb<HD>(o, pp[kk][term_left(term)],
                      make_desc(vt + term_right(term) * G::kPart +
                                    kk * 16 * G::kRowBytes,
                                G::kKPanel, 8 * G::kRowBytes, G::kRowBytes));
}

// p's parts by truncation: the accumulator's fragment of keys 16 kk ..
// 16 kk + 15 is the A fragment of k-step kk, registers {8 kk + 2 e,
// 8 kk + 2 e + 1}, e < 4.
__device__ __forceinline__ void split_tile(const float (&sc)[kBK / 2],
                                           uint32_t (&pp)[kBK / 16][3][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split3(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1], pp[kk][0][e],
             pp[kk][1][e], pp[kk][2][e]);
}

// TMA loads of one K or V tile's three parts (key rows from k0 of head h)
// into `dst`, counted on `bar`; part i of head h is row i * H + h of the
// tensor map's outer axis.
template <int HD>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int k0, int h,
                                          int H) {
  using G = Geometry<HD>;
  mbar_arrive_expect_tx(bar, G::kTile);
  for (int part = 0; part < 3; ++part)
    for (int c = 0; c < G::kCount; ++c)
      tma_load_3d(dst + part * G::kPart + c * G::kKPanel, map, bar,
                  c * G::kCols, k0, part * H + h);
}

// One block per (head, tile of kBQ query rows), heaviest causal tiles
// first; warpgroup 2 loads, warpgroups 0 and 1 each own 64 query rows (the
// skeleton in the file's header).  Per key tile: S = Q K^T in 6 passes
// from shared memory, the online softmax in registers, p split into three
// bf16 parts, then P V in 6 register-A passes.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           float* __restrict__ out, int H, int Sq, int Sk,
                           float scale_log2) {
  using G = Geometry<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* s_k = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* s_v = s_k + kStages * G::kTile;
  uint64_t* k_full = reinterpret_cast<uint64_t*>(s_v + kStages * G::kTile);
  uint64_t* k_empty = k_full + kStages;
  uint64_t* v_full = k_empty + kStages;
  uint64_t* v_empty = v_full + kStages;

  const int tid = threadIdx.x;
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBQ;
  const int h = blockIdx.y;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], kConsumers / 32);   // lane 0 of each warp
      mbar_init(&v_empty[s], kConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer, as in the bf16 leg: the K ring and the V ring each
    // wait for their own slot to be released by both warpgroups
    setmaxnreg_dec<24>();
    if (tid == kConsumers) {
      const int n_kt = (min(Sk, q0 + kBQ) + kBK - 1) / kBK;
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&k_empty[s], ((j / kStages) - 1) & 1);
        load_tile<HD>(s_k + s * G::kTile, &tk, &k_full[s], j * kBK, h, H);
        if (j >= kStages) mbar_wait(&v_empty[s], ((j / kStages) - 1) & 1);
        load_tile<HD>(s_v + s * G::kTile, &tv, &v_full[s], j * kBK, h, H);
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int t = lane % 4;
  const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;   // and row0 + 8
  const int wg_first = q0 + wg * 64;
  const int n_kt = (min(Sk, wg_first + 64) + kBK - 1) / kBK;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};   // this thread's share of the row sums
  float sc[kBK / 2];           // S, then p, of the newest tile
  float alpha[2];
  uint32_t pp[kBK / 16][3][4];  // the previous tile's p, split

  auto softmax = [&](int k0) {
    if (k0 + kBK > Sk || k0 + kBK - 1 > wg_first)
      softmax_tile<kBK, true>(sc, m, l, alpha, k0, Sk, row0, t, scale_log2);
    else
      softmax_tile<kBK, false>(sc, m, l, alpha, k0, Sk, row0, t,
                               scale_log2);
  };

  // Tile j's QK^T and tile j-1's P V are issued together; tile j's
  // softmax runs while P V is on the tensor cores, and O is rescaled by
  // tile j's alpha once P V has landed.
  uint32_t qa[3][HD / 16][4];   // q's parts, register-A fragments
  load_q<HD>(qa, q + ((long long)h * Sq + wg_first) * HD, Sq - wg_first,
             warp, lane);
  mbar_wait(&k_full[0], 0);
  fence_regs(sc);
  wgmma_fence();
  issue_qk<HD>(sc, qa, s_k);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  if (lane == 0) mbar_arrive(&k_empty[0]);
  softmax(0);
  for (int j = 1; j < n_kt; ++j) {
    const int sk = j % kStages;
    const int sv = (j - 1) % kStages;
    split_tile(sc, pp);
    mbar_wait(&k_full[sk], (j / kStages) & 1);
    mbar_wait(&v_full[sv], ((j - 1) / kStages) & 1);
    fence_regs(o);
    wgmma_fence();
    issue_qk<HD>(sc, qa, s_k + sk * G::kTile);
    wgmma_commit();
    issue_pv<HD>(o, pp, s_v + sv * G::kTile);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(&k_empty[sk]);
    softmax(j * kBK);
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(&v_empty[sv]);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i / 2) % 2];
  }
  // the last tile's P V; its V slot is released too, since the other
  // warpgroup may have up to two key tiles more for the producer to load
  const int sv = (n_kt - 1) % kStages;
  split_tile(sc, pp);
  mbar_wait(&v_full[sv], ((n_kt - 1) / kStages) & 1);
  fence_regs(o);
  wgmma_fence();
  issue_pv<HD>(o, pp, s_v + sv * G::kTile);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  if (lane == 0) mbar_arrive(&v_empty[sv]);

  // out = O / max(l, 1e-20); rows past Sq unwritten
  quad_sum(l);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= Sq) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-20f);
    float* orow = out + ((long long)h * Sq + qi) * HD + 2 * t;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      *reinterpret_cast<float2*>(orow + 8 * c) =
          make_float2(o[4 * c + 2 * r] * inv, o[4 * c + 2 * r + 1] * inv);
  }
}

cudaError_t split(const void* k, const void* v, void* parts, int H, int Sk,
                  int hd, cudaStream_t stream) {
  const long long n4 = (long long)H * Sk * hd / 4;
  const long long blocks = (n4 + 255) / 256;
  dim3 grid((unsigned)(blocks < 132 * 8 ? blocks : 132 * 8), 2);
  split_kernel<<<grid, 256, 0, stream>>>(
      static_cast<const float4*>(k), static_cast<const float4*>(v),
      static_cast<uint2*>(parts), n4);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const void* q, const void* parts, void* out, int H,
                   int Sq, int Sk, float scale, cudaStream_t stream) {
  using G = Geometry<HD>;
  const __nv_bfloat16* pk = static_cast<const __nv_bfloat16*>(parts);
  const __nv_bfloat16* pv = pk + 3LL * H * Sk * HD;
  CUtensorMap tk, tv;
  cudaError_t err = encode_tiled_3d(&tk, pk, HD, Sk, 3 * H, G::kCols, kBK);
  if (err == cudaSuccess)
    err = encode_tiled_3d(&tv, pv, HD, Sk, 3 * H, G::kCols, kBK);
  if (err != cudaSuccess) return err;
  auto kern = flash_attention_f32_kernel<HD>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H);
  kern<<<grid, kThreads, G::kSmem, stream>>>(
      static_cast<const float*>(q), tk, tv, static_cast<float*>(out), H, Sq,
      Sk, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace f32_leg

}  // namespace

// The parts of float32 k and v into `parts` (bf16, 6 * H * Sk * hd
// elements): the f32 leg's pre-pass, launched alone.
extern "C" int flash_attention_split(const void* k, const void* v,
                                     void* parts, int H, int Sk, int hd,
                                     void* stream) {
  if (H <= 0 || Sk <= 0 || hd % 4 != 0 || parts == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)f32_leg::split(k, v, parts, H, Sk, hd,
                             static_cast<cudaStream_t>(stream));
}

// One call of the op: bf16 q, k, v in one launch; float32 in two, the
// split of k and v into `parts` (as `flash_attention_split`), then the
// attention.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* parts,
                                      int H, int Sq, int Sk, int hd, int bq,
                                      int bk, int bf16, float scale,
                                      void* stream) {
  if (H <= 0 || Sq <= 0 || Sk <= 0 || H > 65535 ||
      (bq != 32 && bq != 64) || (bk != 32 && bk != 64))
    return (int)cudaErrorInvalidValue;
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    switch (hd) {
      case 16: return (int)bf16_leg::launch<16>(q, k, v, out, H, Sq, Sk,
                                                scale, st);
      case 32: return (int)bf16_leg::launch<32>(q, k, v, out, H, Sq, Sk,
                                                scale, st);
      case 64: return (int)bf16_leg::launch<64>(q, k, v, out, H, Sq, Sk,
                                                scale, st);
      default: return (int)bf16_leg::launch<128>(q, k, v, out, H, Sq, Sk,
                                                 scale, st);
    }
  }
  int err = flash_attention_split(k, v, parts, H, Sk, hd, stream);
  if (err != 0) return err;
  switch (hd) {
    case 16: return (int)f32_leg::launch<16>(q, parts, out, H, Sq, Sk, scale,
                                             st);
    case 32: return (int)f32_leg::launch<32>(q, parts, out, H, Sq, Sk, scale,
                                             st);
    case 64: return (int)f32_leg::launch<64>(q, parts, out, H, Sq, Sk, scale,
                                             st);
    default: return (int)f32_leg::launch<128>(q, parts, out, H, Sq, Sk,
                                              scale, st);
  }
}
