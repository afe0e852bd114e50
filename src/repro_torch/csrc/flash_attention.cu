// Causal flash attention (online softmax) for NVIDIA Hopper (sm_90a), in
// two legs: float32 inputs on the FFMA pipes, bfloat16 inputs on the
// tensor cores.  Plain C interface, loaded with ctypes by
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
// are bound by operations.
//
// The f32 leg (bf16 == 0) keeps true float32 products, so it runs on the
// FFMA pipes (67 TFLOP/s; 4.1 ms at that shape):
//   * one thread block per (head, tile of BQ query rows), heaviest tiles
//     first; 256 threads as a 16 x 16 grid, thread (ty, tx) owns query
//     rows ty + 16*a (a < BQ/16): their running max and denominator in
//     registers, their output columns tx + 16*c (c < HD/16) in registers;
//   * it walks the keys in tiles of BK, stopping at the first tile that
//     lies wholly in the future of the query tile (causal skip).  Per
//     tile: K into shared memory (rows padded by one float, so the column
//     walk is free of bank conflicts), the BQ x BK scores (each thread
//     BQ/16 x BK/16 of them, key columns tx + 16*b), the row max by warp
//     shuffles over the 16 threads of a row, p = exp(s - m) into shared
//     memory, then V into the same buffer as K and acc += p V.
//   BQ and BK are the caller's bq and bk (32 or 64).
//
// The bf16 leg (bf16 != 0) runs both products on the tensor cores with
// wgmma (hopper.cuh), at f32 precision:
//   * QK^T on bf16 inputs: each product of two bf16 values is exact in
//     f32, so one bf16 pass with an f32 accumulator gives the f32 scores;
//   * PV: p = exp(s - m) needs f32's 24 bits.  It splits exactly into
//     three bf16 values, p = hi + mid + lo, each of whose products with a
//     bf16 v is exact in f32, so three bf16 passes into one f32
//     accumulator give P V at the reference's precision.  One pass would
//     round p to bf16 (sdpa's choice); two would keep 16 of its 24 bits.
//   So its bound is 1 + 3 bf16 passes at 989 TFLOP/s (0.556 ms at
//   chameleon-34b's shape), beside exp on the MUFU (~0.13 ms) and the
//   bytes (0.08 ms).  Its design:
//   * one block per (head, tile of 128 query rows), heaviest causal tiles
//     first; two consumer warpgroups of 64 query rows each (wgmma's M)
//     and a producer warpgroup that gives them its registers
//     (setmaxnreg: 240 a consumer thread, 24 a producer thread);
//   * key tiles of 64 rows: the S accumulator (32 f32 a thread), the
//     three bf16 parts of the previous tile's P (48 registers) and the
//     hd = 128 output accumulator (64) fit in 240 registers without
//     spilling, and a 64-row warpgroup skips whole 64-key tiles at the
//     causal edge;
//   * loads by TMA from tiled tensor maps (3-d, so rows past Sq or Sk of
//     a head read as zeros, never the next head's), encoded per call on
//     the host: Q once, K and V into a 3-stage ring with full and empty
//     mbarriers (in trials a 2-stage ring ran slower, a 4-stage one no
//     faster).  Rows are swizzled to their bytes (32, 64 or 128); hd = 128
//     is two 64-column panels;
//   * S = Q K^T by wgmma m64n64k16 from shared memory (hd/16 k-steps);
//     scale, mask (only on tiles at the causal or ragged edge), row max
//     (quad shuffles), alpha and p in registers; no P tile touches shared
//     memory: the accumulator's fragment of 16 keys is the A fragment of
//     register-A wgmma m64n{hd}k16, which runs three times per k-step on
//     p's parts, B = V MN-major (transpose bit);
//   * each warpgroup issues tile j's QK^T and tile j-1's three PV passes
//     together and runs tile j's softmax while they are on the tensor
//     cores; O is rescaled by tile j's alpha once PV has landed;
//   * out = O / max(l, 1e-20), rounded once to bf16, rows past Sq masked.
//   The caller's bq and bk are checked but pick nothing here.
// Later work: a persistent grid (each block's first QK^T and last PV are
// not overlapped), the f32 leg on split bf16 products (bf16x6 or bf16x9)
// on the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ------------------------------------------------------------ the f32 leg

constexpr int kThreads = 256;   // 16 x 16
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }

template <int HD, int BQ, int BK, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, float scale) {
  constexpr int RA = BQ / 16;    // query rows per thread
  constexpr int CB = BK / 16;    // score columns per thread
  constexpr int CD = HD / 16;    // output columns per thread
  constexpr int KS = HD + 1;     // padded row stride of the K/V tile
  extern __shared__ float smem[];
  float* s_q = smem;                    // [BQ][HD]
  float* s_kv = s_q + BQ * HD;          // [BK][KS]
  float* s_p = s_kv + BK * KS;          // [BQ][BK + 1]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int qt = n_qt - 1 - blockIdx.x;      // heaviest query tiles first
  const int q0 = qt * BQ;
  const int h = blockIdx.y;
  const T* qh = q + (long long)h * Sq * HD;
  const T* kh = k + (long long)h * Sk * HD;
  const T* vh = v + (long long)h * Sk * HD;

  for (int e = tid; e < BQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    s_q[e] = (q0 + r < Sq) ? load_f(qh + (long long)(q0 + r) * HD + d)
                           : 0.0f;
  }

  float m[RA], l[RA], acc[RA][CD];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    m[a] = kMasked;
    l[a] = 0.0f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[a][c] = 0.0f;
  }

  // keys beyond the query tile's last row lie wholly in the future
  const int k_end = min(Sk, q0 + BQ);
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();              // the previous tile's V is consumed
    for (int e = tid; e < BK * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      s_kv[r * KS + d] = (k0 + r < Sk)
                             ? load_f(kh + (long long)(k0 + r) * HD + d)
                             : 0.0f;
    }
    __syncthreads();
    float s[RA][CB];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int b = 0; b < CB; ++b) s[a][b] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[RA], kv[CB];
#pragma unroll
      for (int a = 0; a < RA; ++a) qv[a] = s_q[(ty + 16 * a) * HD + d];
#pragma unroll
      for (int b = 0; b < CB; ++b) kv[b] = s_kv[(tx + 16 * b) * KS + d];
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int b = 0; b < CB; ++b) s[a][b] = fmaf(qv[a], kv[b], s[a][b]);
    }
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const int qi = q0 + ty + 16 * a;
      float mx = kMasked;
#pragma unroll
      for (int b = 0; b < CB; ++b) {
        const int kj = k0 + tx + 16 * b;
        const bool keep = kj < Sk && kj <= qi;
        s[a][b] = keep ? s[a][b] * scale : kMasked;
        mx = fmaxf(mx, s[a][b]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      const float alpha = expf(m[a] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int b = 0; b < CB; ++b) {
        const float p = (s[a][b] == kMasked) ? 0.0f : expf(s[a][b] - m_new);
        rs += p;
        s_p[(ty + 16 * a) * (BK + 1) + tx + 16 * b] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[a] = l[a] * alpha + rs;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();              // scores done with K; p written
    for (int e = tid; e < BK * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      s_kv[r * KS + d] = (k0 + r < Sk)
                             ? load_f(vh + (long long)(k0 + r) * HD + d)
                             : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[RA], vv[CD];
#pragma unroll
      for (int a = 0; a < RA; ++a) pv[a] = s_p[(ty + 16 * a) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = s_kv[j * KS + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[a][c] = fmaf(pv[a], vv[c], acc[a][c]);
    }
  }

  T* oh = out + (long long)h * Sq * HD;
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int qi = q0 + ty + 16 * a;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[a], 1e-20f);
#pragma unroll
    for (int c = 0; c < CD; ++c)
      store_f(oh + (long long)qi * HD + tx + 16 * c, acc[a][c] / den);
  }
}

template <int HD, int BQ, int BK, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int H, int Sq, int Sk, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * HD + BK * (HD + 1) + BQ * (BK + 1));
  auto kern = flash_attention_kernel<HD, BQ, BK, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, scale);
  return cudaGetLastError();
}

template <int BQ, int BK, typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v,
                        void* out, int H, int Sq, int Sk, int hd, float scale,
                        cudaStream_t st) {
  switch (hd) {
    case 16: return launch<16, BQ, BK, T>(q, k, v, out, H, Sq, Sk, scale, st);
    case 32: return launch<32, BQ, BK, T>(q, k, v, out, H, Sq, Sk, scale, st);
    case 64: return launch<64, BQ, BK, T>(q, k, v, out, H, Sq, Sk, scale, st);
    case 128:
      return launch<128, BQ, BK, T>(q, k, v, out, H, Sq, Sk, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_tiles(const void* q, const void* k, const void* v,
                           void* out, int H, int Sq, int Sk, int hd, int bq,
                           int bk, float scale, cudaStream_t st) {
  if (bq == 64 && bk == 64)
    return dispatch_hd<64, 64, T>(q, k, v, out, H, Sq, Sk, hd, scale, st);
  if (bq == 64 && bk == 32)
    return dispatch_hd<64, 32, T>(q, k, v, out, H, Sq, Sk, hd, scale, st);
  if (bq == 32 && bk == 64)
    return dispatch_hd<32, 64, T>(q, k, v, out, H, Sq, Sk, hd, scale, st);
  if (bq == 32 && bk == 32)
    return dispatch_hd<32, 32, T>(q, k, v, out, H, Sq, Sk, hd, scale, st);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------ the bf16 leg

namespace bf16_leg {

using namespace hopper;

constexpr int kBQ = 128;          // query rows per block
constexpr int kBK = 64;           // key rows per tile
constexpr int kStages = 3;        // K/V tiles in flight
constexpr int kConsumers = 256;   // two warpgroups of 64 query rows each
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout of one head dim.  Every tile is stored as TMA
// writes it: panels of at most 64 columns (128 bytes a row) with the
// swizzle of the panel's row bytes, so hd = 128 is two panels.
template <int HD>
struct Geometry {
  static constexpr int kPanelCols = HD < 64 ? HD : 64;
  static constexpr int kRowBytes = 2 * kPanelCols;      // 32, 64 or 128
  static constexpr int kPanels = HD / kPanelCols;
  static constexpr int kQPanel = kBQ * kRowBytes;       // bytes
  static constexpr int kQBytes = kPanels * kQPanel;
  static constexpr int kKPanel = kBK * kRowBytes;
  static constexpr int kTileBytes = kPanels * kKPanel;  // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;    // K then V
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages);
  // + 1024 to align the tiles to the 128-byte swizzle's 1024-byte atom
  static constexpr int kSmem = 1024 + kQBytes + kStages * kStageBytes +
                               kBarBytes;
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
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi,
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
    const int p = kk * 16 / G::kPanelCols;
    const int off = (kk * 16 % G::kPanelCols) * 2;
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
      split3(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1], pp[kk][0][e],
             pp[kk][1][e], pp[kk][2][e]);
}

// Masks one tile's scores (keys from k0; only when `kMasked`: the tile
// holds keys past Sk or past one of its rows), updates the running max m
// (of the scaled scores, in log2 units) and this thread's share l of the row
// sums, and leaves p = exp(s * scale - max) = 2^(s * scale_log2 - m) in
// sc and the rescale factor of the earlier tiles in alpha.  Element i of
// the accumulator is row row0 + 8 * ((i / 2) % 2), key k0 + 8 * (i / 4) +
// 2 * t + i % 2; the four threads of a quad share a row.
template <bool kMasked>
__device__ __forceinline__ void softmax_tile(float (&sc)[kBK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0,
                                             int Sk, int row0, int t,
                                             float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
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
  for (int i = 0; i < kBK / 2; ++i) {
    const int r = (i / 2) % 2;
    sc[i] = ex2(fmaf(sc[i], scale_log2, -m[r]));
    l[r] += sc[i];
  }
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
      for (int p = 0; p < G::kPanels; ++p)
        tma_load_3d(s_q + p * G::kQPanel, &tq, q_full, p * G::kPanelCols, q0,
                    h);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], G::kStageBytes);
        uint8_t* kt = s_kv + s * G::kStageBytes;
        for (int p = 0; p < G::kPanels; ++p) {
          tma_load_3d(kt + p * G::kKPanel, &tk, &full[s], p * G::kPanelCols,
                      j * kBK, h);
          tma_load_3d(kt + G::kTileBytes + p * G::kKPanel, &tv, &full[s],
                      p * G::kPanelCols, j * kBK, h);
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
      softmax_tile<true>(sc, m, l, alpha, k0, Sk, row0, t, scale_log2);
    else
      softmax_tile<false>(sc, m, l, alpha, k0, Sk, row0, t, scale_log2);
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
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
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
  cudaError_t err =
      encode_tiled_3d(&tq, q, HD, Sq, H, G::kPanelCols, kBQ);
  if (err == cudaSuccess)
    err = encode_tiled_3d(&tk, k, HD, Sk, H, G::kPanelCols, kBK);
  if (err == cudaSuccess)
    err = encode_tiled_3d(&tv, v, HD, Sk, H, G::kPanelCols, kBK);
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

cudaError_t dispatch_hd(const void* q, const void* k, const void* v,
                        void* out, int H, int Sq, int Sk, int hd, float scale,
                        cudaStream_t st) {
  switch (hd) {
    case 16: return launch<16>(q, k, v, out, H, Sq, Sk, scale, st);
    case 32: return launch<32>(q, k, v, out, H, Sq, Sk, scale, st);
    case 64: return launch<64>(q, k, v, out, H, Sq, Sk, scale, st);
    case 128: return launch<128>(q, k, v, out, H, Sq, Sk, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bf16_leg

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int H, int Sq,
                                      int Sk, int hd, int bq, int bk,
                                      int bf16, float scale, void* stream) {
  if (H <= 0 || Sq <= 0 || Sk <= 0 || H > 65535)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if ((bq != 32 && bq != 64) || (bk != 32 && bk != 64))
      return (int)cudaErrorInvalidValue;
    return (int)bf16_leg::dispatch_hd(q, k, v, out, H, Sq, Sk, hd, scale,
                                      st);
  }
  return (int)dispatch_tiles<float>(q, k, v, out, H, Sq, Sk, hd, bq, bk,
                                    scale, st);
}
