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
//                   i = sum_k I[k] * clip(1 - alpha * cum[k], 0, 1)
//   nonlinearity    i *= ratio(p)  (piecewise quartic, clamped to [0, 320])
//   output "diff"   i+ - i-
//   output binary   (i+ - i- + sigma(p+ + p-) * eps) > 0, replaced by rnd
//                   where min(i±) < sense_low or max(i±) > sense_high.
//
// Layouts: x is [B,R] shared by every chip or [C,B,R] per chip; e± are
// [C,R,N]; g± are [R,N] shared or [C,R,N]; eps/rnd/out are [C,B,N].  A shared
// operand is passed with chip stride 0, so one code path serves all four.
// Ragged edges (R not a multiple of 32, N not of 64, B not of the row tile)
// are masked here; the caller pads nothing.
//
// What bounds it on the H100: four products of x against the planes, each
// 2*C*B*R*N floating-point operations, against reading x once (4*C*B*R
// bytes for per-chip x).  The two block-current products need true f32
// (IEEE FFMA, not TF32); the two counts have {0,1} operands, which tensor
// cores sum exactly.  At the detector's s0b1 shape (C=4, B=294,912, R=572,
// N=60) that is 162 GFLOP at the 67 TFLOP/s FFMA peak (2.42 ms) plus
// 162 GFLOP at the 495 TFLOP/s TF32 peak (0.33 ms), against 1.06 ms of
// memory traffic (3.55 GB, 2.7 GB of it x), so the FFMA rate bounds it.
// This first design computes all four products on the FFMA pipes:
//   * a thread block owns one chip, a tile of BM = 4*TM word-line rows and
//     64 columns; 256 threads, thread (ty, tx) owns column tx and rows
//     ty + 4*i, i < TM;
//   * it walks R in 32-row IR blocks, staging the x tile and the four
//     32x64 plane slices (32 KB) in shared memory, so each plane value read
//     from shared memory feeds TM rows and each x value (a warp broadcast)
//     feeds four products;
//   * each thread keeps its rows' NB block currents per plane in registers
//     (the IR-drop weights need every block before any is weighted) and runs
//     the epilogue in registers, writing one f32 per output.
// The counts are exact in any order ({0,1} products, sums < 2^24).  The
// epilogue rounds each multiply and add separately (__fmul_rn/__fadd_rn), as
// the plain version's separate tensor ops do.  Faster designs (tensor cores
// for the {0,1} counts, TMA, a persistent grid, all groups of a layer in one
// launch, periphery noise drawn in the epilogue) are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlk = 32;       // rows per IR-drop block
constexpr int kCols = 64;      // output columns per thread block
constexpr int kRowLanes = 4;   // 256 threads = 64 columns x 4 row lanes

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
  for (int i = 1; i < 5; ++i) acc = __fadd_rn(__fmul_rn(acc, p), c[i]);
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

// IR-drop weighted sum of NB block currents (zero beyond the real blocks,
// which leaves every real block's factor unchanged).
template <int NB>
__device__ __forceinline__ float line_current(const float (&I)[NB],
                                              float alpha, bool ir) {
  if (!ir) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < NB; ++k) s = __fadd_rn(s, I[k]);
    return s;
  }
  float S[NB];
  S[NB - 1] = I[NB - 1];
#pragma unroll
  for (int k = NB - 2; k >= 0; --k) S[k] = __fadd_rn(S[k + 1], I[k]);
  float run = 0.0f, line = 0.0f;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    run = __fadd_rn(run, S[k]);
    float cum = __fadd_rn(run, -S[0]);
    float f = __fadd_rn(1.0f, -__fmul_rn(alpha, cum));
    f = fminf(fmaxf(f, 0.0f), 1.0f);
    line = __fadd_rn(line, __fmul_rn(I[k], f));
  }
  return line;
}

template <int NB, int TM>
__global__ void __launch_bounds__(kCols * kRowLanes)
irc_mvm_chips_kernel(const float* __restrict__ x, const float* __restrict__ ep,
                     const float* __restrict__ en, const float* __restrict__ gp,
                     const float* __restrict__ gn,
                     const float* __restrict__ eps,
                     const float* __restrict__ rnd, float* __restrict__ out,
                     int B, int R, int N, long long x_chip_stride,
                     long long g_chip_stride, Params prm) {
  constexpr int BM = kRowLanes * TM;
  __shared__ float s_x[BM][kBlk];
  __shared__ float s_ep[kBlk][kCols];
  __shared__ float s_en[kBlk][kCols];
  __shared__ float s_gp[kBlk][kCols];
  __shared__ float s_gn[kBlk][kCols];

  const int tid = threadIdx.x;
  const int tx = tid % kCols;
  const int ty = tid / kCols;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * kCols;
  const int c = blockIdx.z;
  const int nb = (R + kBlk - 1) / kBlk;

  const float* xc = x + c * x_chip_stride;
  const long long plane_chip = (long long)c * R * N;
  const float* epc = ep + plane_chip;
  const float* enc = en + plane_chip;
  const float* gpc = gp + c * g_chip_stride;
  const float* gnc = gn + c * g_chip_stride;

  float Ip[TM][NB], In[TM][NB], cp[TM], cn[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    cp[i] = 0.0f;
    cn[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      Ip[i][k] = 0.0f;
      In[i][k] = 0.0f;
    }
  }

#pragma unroll
  for (int k = 0; k < NB; ++k) {
    if (k < nb) {                       // uniform across the thread block
      const int r0 = k * kBlk;
      __syncthreads();
      for (int e = tid; e < BM * kBlk; e += kCols * kRowLanes) {
        int rr = e / kBlk, kk = e % kBlk;
        int b = row0 + rr, r = r0 + kk;
        s_x[rr][kk] = (b < B && r < R) ? xc[(long long)b * R + r] : 0.0f;
      }
      for (int e = tid; e < kBlk * kCols; e += kCols * kRowLanes) {
        int kk = e / kCols, nn = e % kCols;
        int r = r0 + kk, n = col0 + nn;
        bool in = (r < R && n < N);
        long long off = (long long)r * N + n;
        s_ep[kk][nn] = in ? epc[off] : 0.0f;
        s_en[kk][nn] = in ? enc[off] : 0.0f;
        s_gp[kk][nn] = in ? gpc[off] : 0.0f;
        s_gn[kk][nn] = in ? gnc[off] : 0.0f;
      }
      __syncthreads();
      float ap[TM], an[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) { ap[i] = 0.0f; an[i] = 0.0f; }
#pragma unroll 8
      for (int kk = 0; kk < kBlk; ++kk) {
        const float vp = s_ep[kk][tx], vn = s_en[kk][tx];
        const float up = s_gp[kk][tx], un = s_gn[kk][tx];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float xv = s_x[ty + kRowLanes * i][kk];
          ap[i] = fmaf(xv, vp, ap[i]);
          an[i] = fmaf(xv, vn, an[i]);
          cp[i] = fmaf(xv, up, cp[i]);
          cn[i] = fmaf(xv, un, cn[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) { Ip[i][k] = ap[i]; In[i][k] = an[i]; }
    }
  }

  const int n = col0 + tx;
  const bool ir = prm.flags & kIrDrop;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int b = row0 + ty + kRowLanes * i;
    if (b >= B || n >= N) continue;
    float i_pos = line_current<NB>(Ip[i], prm.ir_alpha, ir);
    float i_neg = line_current<NB>(In[i], prm.ir_alpha, ir);
    if (prm.flags & kNonlinearity) {
      i_pos = __fmul_rn(i_pos, nl_ratio(cp[i]));
      i_neg = __fmul_rn(i_neg, nl_ratio(cn[i]));
    }
    float diff = __fadd_rn(i_pos, -i_neg);
    const long long o = ((long long)c * B + b) * N + n;
    if (prm.flags & kOutputDiff) {
      out[o] = diff;
      continue;
    }
    if (prm.flags & kSa) {
      const float pp = __fadd_rn(cp[i], cn[i]);
      float s = __fadd_rn(prm.sa_c0, __fmul_rn(prm.sa_c1, pp));
      s = __fadd_rn(s, __fmul_rn(__fmul_rn(prm.sa_c2, pp), pp));
      s = __fmul_rn(0.5f, __fadd_rn(s, prm.sa_extra));
      diff = __fadd_rn(diff, __fmul_rn(s, eps[o]));
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

template <int NB, int TM>
cudaError_t launch(const float* x, const float* ep, const float* en,
                   const float* gp, const float* gn, const float* eps,
                   const float* rnd, float* out, int C, int B, int R, int N,
                   long long x_chip_stride, long long g_chip_stride,
                   Params prm, cudaStream_t stream) {
  constexpr int BM = kRowLanes * TM;
  dim3 grid((B + BM - 1) / BM, (N + kCols - 1) / kCols, C);
  irc_mvm_chips_kernel<NB, TM><<<grid, kCols * kRowLanes, 0, stream>>>(
      x, ep, en, gp, gn, eps, rnd, out, B, R, N, x_chip_stride,
      g_chip_stride, prm);
  return cudaGetLastError();
}

}  // namespace

extern "C" int irc_mvm_chips_launch(
    const void* x, const void* ep, const void* en, const void* gp,
    const void* gn, const void* eps, const void* rnd, void* out, int C,
    int B, int R, int N, long long x_chip_stride, long long g_chip_stride,
    float ir_alpha, float sense_low, float sense_high, float sa_c0,
    float sa_c1, float sa_c2, float sa_extra, int flags, void* stream) {
  if (C <= 0 || B <= 0 || R <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  if (C > 65535 || (long long)B > 4LL * 2147483647LL)
    return (int)cudaErrorInvalidValue;
  Params prm{ir_alpha, sense_low, sense_high, sa_c0, sa_c1, sa_c2, sa_extra,
             flags};
  const int nb = (R + kBlk - 1) / kBlk;
  auto st = static_cast<cudaStream_t>(stream);
  auto fx = static_cast<const float*>(x);
  auto fep = static_cast<const float*>(ep);
  auto fen = static_cast<const float*>(en);
  auto fgp = static_cast<const float*>(gp);
  auto fgn = static_cast<const float*>(gn);
  auto feps = static_cast<const float*>(eps);
  auto frnd = static_cast<const float*>(rnd);
  auto fout = static_cast<float*>(out);
  if (nb <= 18)
    return (int)launch<18, 2>(fx, fep, fen, fgp, fgn, feps, frnd, fout, C, B,
                              R, N, x_chip_stride, g_chip_stride, prm, st);
  if (nb <= 32)
    return (int)launch<32, 1>(fx, fep, fen, fgp, fgn, feps, frnd, fout, C, B,
                              R, N, x_chip_stride, g_chip_stride, prm, st);
  return (int)cudaErrorInvalidValue;   // more rows than one 1024-row macro
}
