// Causal flash attention (online softmax) for NVIDIA Hopper (sm_90a).
// Plain C interface, loaded with ctypes by
// repro_torch/kernels/flash_attention_cuda.py.
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py; body `_flash_kernel`).  Its plain
// PyTorch version is repro_torch/kernels/ref.py::flash_attention_ref.
//
// What it computes, per head h and query row i < Sq:
//   s[j]  = (q[h,i,:] . k[h,j,:]) * scale     for key j < Sk, j <= i
//   out   = sum_j softmax(s)[j] * v[h,j,:]
// with keys j > i (the future) and j >= Sk (past the ragged end) masked
// out, as the plain version masks them; the output is in q's dtype.
//
// Layouts: q [H,Sq,hd], k/v [H,Sk,hd], out [H,Sq,hd], contiguous, all f32
// or all bf16 (bf16 widened on load).  Arithmetic is f32 throughout on the
// FFMA pipes: no TF32 and no tensor cores, so the products are those of
// true float32, as the plain version's.
//
// What bounds it on the H100: 4*H*hd*(causal pairs) floating-point
// operations (QK^T and PV), about 2*H*S^2*hd for Sq = Sk = S, against
// reading q, k, v and writing out once; at chameleon-34b's 64 heads x
// 4096 x 128 that is 2.75e11 operations (4.1 ms at the 67 TFLOP/s FFMA
// peak) against 0.54 GB of f32 traffic (0.16 ms), so the FFMA rate bounds
// it.  This first design:
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
//     memory, then V into the same buffer as K and acc += p V;
//   * ragged Sq and Sk are masked here; the caller pads nothing.
// Faster designs (wgmma on bf16 tiles, TMA, K and V double-buffered, a
// persistent grid) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int H, int Sq,
                                      int Sk, int hd, int bq, int bk,
                                      int bf16, float scale, void* stream) {
  if (H <= 0 || Sq <= 0 || Sk <= 0 || H > 65535)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)dispatch_tiles<__nv_bfloat16>(q, k, v, out, H, Sq, Sk, hd,
                                              bq, bk, scale, st);
  return (int)dispatch_tiles<float>(q, k, v, out, H, Sq, Sk, hd, bq, bk,
                                    scale, st);
}
