// Dense ternary matmul for NVIDIA Hopper (sm_90a): out[B,N] = x[B,K] @ w[K,N]
// with int8 weights in {-1,0,+1} and float32 accumulation, on the tensor
// cores.  Plain C interface, loaded with ctypes by
// repro_torch/kernels/ternary_matmul.py, which also plans each launch
// (`plan`: load path, split over K, grid).
//
// Replaces the TPU kernel `ternary_matmul_pallas`
// (src/repro/kernels/ternary_matmul.py; body `_ternary_matmul_kernel`), the
// Pallas form of the ideal digital reference `ideal_ternary_matmul`.  Its
// plain PyTorch version is repro_torch/kernels/ref.py::ternary_matmul_ref.
//
// Precision.  A weight is exact in bf16 (so is any int8), and the product
// of two bf16 values is exact in f32.  A bf16 x therefore needs one bf16
// tensor-core pass.  A float32 x splits exactly into three bf16 parts,
// x = hi + mid + lo (`split3` in hopper.cuh; the plain version is
// kernels/ref.py::bf16x3_split_masked): three passes, each product exact,
// give the f32 product; none of them rounds x, as TF32 would.  With {0,1}
// x every product and partial sum is an integer below 2^24, exact in f32
// in any order, so the result is bit-identical to any other f32 product.
//
// What bounds it on the H100: 3 bf16 passes of 2*B*K*N operations (1 for
// bf16 x) at 989 TFLOP/s, against reading x once, the int8 weights once
// and writing the f32 output once at 3.35 TB/s.  At the layer path's
// 256x540x60 and the detector's s0 product (294,912x540x60) the bytes
// bound it (0.211 ms at s0: 0.708 GB); at 256x2048x512 the passes do.
//
// The design:
//   * a block owns tiles of 128 output rows x 64 columns; two consumer
//     warpgroups of 64 rows (wgmma's M) and a producer warpgroup;
//   * x streams through a ring of 4 stages, 64 deep in K each, with full
//     and empty mbarriers.  Where x's base and row stride are 16-byte
//     aligned the producer issues TMA loads from a tensor map (boxes of
//     128 rows x 128 bytes, 128-byte swizzle; rows past B and columns past
//     K read as zeros); otherwise its 128 threads copy with 4-byte
//     cp.async into the same swizzled layout (bf16 rows that are not
//     4-byte aligned: 2-byte loads), so one consumer body serves both;
//   * the weights of the block's 64 columns and K range are widened to
//     bf16 into shared memory by the consumers, MN-major with the 128-byte
//     swizzle, and stay there while the block walks its row tiles
//     (a persistent grid, one block per SM; a K range too deep for the
//     room is loaded in chunks, again for each tile);
//   * per stage a consumer thread loads its A fragments of four k16 steps
//     (f32 pairs, conflict-free under the swizzle), releases the stage,
//     splits each value in registers and issues 4 x 3 register-A wgmmas
//     (m64n64k16, B = the widened weights, transpose bit) into a stage
//     accumulator, which is then added into a register accumulator with
//     round-to-nearest f32 adds; so no f32 sum runs through more than one
//     stage's 12 tensor-core additions.  Where none of a thread's values
//     in a stage has a bit in its low 16 (a {0,1} x), mid = lo = 0 and the
//     thread skips the split; where that holds for a whole warpgroup, it
//     skips the mid and lo passes too (4 wgmmas a stage);
//   * few tiles (small B): the K range splits over the blocks of a
//     thread-block cluster (up to 8, each range a multiple of 64 deep; one
//     tile per cluster).  Each block parks its partial tile in its ring
//     once both consumer warpgroups are done with it; one bulk copy a
//     peer sends block q the rows of q's share, rows q*ceil(128/S)..,
//     into q's shared memory, counted in bytes on an mbarrier there;
//     block q then sums its share over the slots in rank order 0, 1, ...,
//     S-1 and writes it: deterministic, one launch, no atomics.  Two
//     cluster barriers bracket the copies: every block has started before
//     any copies into it, and none exits before all copies have landed;
//   * ragged B, K and N are masked here; the caller pads nothing.  N is
//     padded to 64 with zero weight columns that are never written.
// Non-finite x: hi carries an Inf or NaN alone (mid = lo = 0), so Inf * 1
// gives Inf and Inf * 0 gives NaN, as in the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;          // output rows per tile
constexpr int kBN = 64;           // output columns per tile, wgmma's N
constexpr int kBK = 64;           // depth of x per ring stage
constexpr int kStages = 4;        // x stages in flight
constexpr int kConsumers = 256;   // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kRedStride = kBN + 8;         // floats per partial-tile row
constexpr int kMaxSplit = 8;      // the portable cluster size
// S slots of ceil(128 / S) partial rows each: at most 128 + 7 rows
constexpr int kRedBytes = (kBM + kMaxSplit) * kRedStride * 4;
constexpr int kBarBytes = 8 * (2 * kStages + 1);
constexpr int kSmemMax = 232448;  // a block's shared memory on the H100

// how x reaches the ring (kernels/ternary_matmul.py::PATHS)
enum Path { kPathTma = 0, kPathCpAsync = 1, kPathLoad = 2 };

template <bool kBf16>
struct Geometry {
  static constexpr int kElem = kBf16 ? 2 : 4;
  static constexpr int kPanelCols = 128 / kElem;     // one swizzled row
  static constexpr int kPanels = kBK / kPanelCols;   // 2 (f32) or 1
  static constexpr int kPanelBytes = kBM * 128;
  static constexpr int kStageBytes = kPanels * kPanelBytes;
  static constexpr int kParts = kBf16 ? 1 : 3;       // bf16 passes
};

int smem_bytes(bool bf16, int kw, int split) {
  const int stage = kBM * kBK * (bf16 ? 2 : 4);
  return 1024 + kStages * stage + kw * kBN * 2 +
         (split > 1 ? kRedBytes : 0) + kBarBytes;
}

struct Params {
  const void* x;
  const int8_t* w;
  float* out;
  int B, K, N;
  int path;
  int split;     // blocks per cluster, each a K range of k_slice
  int k_slice;   // a multiple of kBK
  int kw;        // weight rows resident at once, a multiple of kBK
  int tiles_m;   // row tiles; item i is row tile i % tiles_m of column
  int n_items;   // tile i / tiles_m
};

// byte offset of byte `b` of row `row` in a tile of 128-byte rows written
// with the 128-byte swizzle (16-byte chunks XORed with row % 8), as TMA
// writes it and as wgmma reads it
__device__ __forceinline__ uint32_t swz(int row, int b) {
  return row * 128 + ((((b >> 4) ^ row) & 7) << 4) + (b & 15);
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Whether `pred` holds for any thread of warpgroup `wg`: a barrier of its
// 128 threads (id 2 or 3) that ORs the predicate, its result then made
// warp-uniform by a warp reduction, so that ptxas sees a branch on it as
// uniform (a branch on the barrier's own result around wgmmas makes it
// serialize every wgmma of the kernel).
template <int kId>
__device__ __forceinline__ uint32_t bar_or(uint32_t v) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 p, %1, 0;\n"
      "bar.red.or.pred q, %2, 128, p;\nselp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(r)
      : "r"(v), "n"(kId)
      : "memory");
  return r;
}

__device__ __forceinline__ bool warpgroup_any(bool pred, int wg) {
  const uint32_t r = wg == 0 ? bar_or<2>(pred) : bar_or<3>(pred);
  return __reduce_or_sync(0xffffffffu, r) != 0u;
}

// The producer's copy of one stage without TMA: 128 threads, rows row0..
// and columns k0.. of x into the swizzled layout, zeros past B and K.
template <bool kBf16>
__device__ __forceinline__ void copy_stage(uint8_t* stage, const Params& p,
                                           int row0, int k0, int ptid,
                                           uint64_t* full) {
  using G = Geometry<kBf16>;
  if constexpr (!kBf16) {
    const float* x = static_cast<const float*>(p.x);
#pragma unroll 8
    for (int i = 0; i < kBM * kBK / 128; ++i) {
      const int e = ptid + 128 * i;
      const int row = e / kBK, col = e % kBK;
      const long long r = (long long)row0 + row;
      const int k = k0 + col;
      const bool ok = r < p.B && k < p.K;
      cp_async4(stage + (col / G::kPanelCols) * G::kPanelBytes +
                    swz(row, (col % G::kPanelCols) * 4),
                ok ? x + r * p.K + k : x, ok);
    }
    cp_async_mbar_arrive(full);
  } else {
    const uint16_t* x = static_cast<const uint16_t*>(p.x);
    if (p.path == kPathCpAsync) {   // pairs: K even, rows 4-byte aligned
#pragma unroll 8
      for (int i = 0; i < kBM * kBK / 256; ++i) {
        const int e = ptid + 128 * i;
        const int row = e / (kBK / 2), col = 2 * (e % (kBK / 2));
        const long long r = (long long)row0 + row;
        const int k = k0 + col;
        const bool ok = r < p.B && k < p.K;
        cp_async4(stage + swz(row, col * 2), ok ? x + r * p.K + k : x, ok);
      }
      cp_async_mbar_arrive(full);
    } else {
#pragma unroll 8
      for (int i = 0; i < kBM * kBK / 128; ++i) {
        const int e = ptid + 128 * i;
        const int row = e / kBK, col = e % kBK;
        const long long r = (long long)row0 + row;
        const int k = k0 + col;
        *reinterpret_cast<uint16_t*>(stage + swz(row, col * 2)) =
            (r < p.B && k < p.K) ? x[r * p.K + k] : uint16_t(0);
      }
      mbar_arrive(full);
    }
  }
}

__device__ __forceinline__ uint32_t bf16_bits(int8_t v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn((float)v));
}

// Weight rows kbase.. (`rows`, a multiple of 64) of columns j*64..
// widened to bf16 into `ws`, [rows][64] with the 128-byte swizzle; zeros
// past K and N.  All consumer threads, between two consumer barriers, in
// rounds of 8 groups of 4 weights a thread, all loaded before any is
// stored (one 32-bit load a group where rows of w are 4-byte aligned); the
// fence hands the generic writes to wgmma's async proxy.
__device__ __forceinline__ void load_w(uint8_t* ws, const Params& p, int j,
                                       int kbase, int rows, int ctid) {
  constexpr int kGroups = kBN / 4;   // groups of 4 weights in a row
  constexpr int kRound = 8;
  consumer_sync();
  const bool words =
      p.N % 4 == 0 && reinterpret_cast<uintptr_t>(p.w) % 4 == 0;
  for (int u0 = ctid; u0 < rows * kGroups; u0 += kRound * kConsumers) {
    uint32_t raw[kRound];
#pragma unroll
    for (int q = 0; q < kRound; ++q) {
      const int u = u0 + q * kConsumers;
      const int k = kbase + u / kGroups, n = j * kBN + 4 * (u % kGroups);
      const int8_t* src = p.w + (long long)k * p.N + n;
      raw[q] = 0;
      if (u < rows * kGroups && k < p.K && n < p.N) {
        if (words) {
          raw[q] = __ldg(reinterpret_cast<const uint32_t*>(src));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n + e < p.N)
              raw[q] |= uint32_t(uint8_t(__ldg(src + e))) << (8 * e);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRound; ++q) {
      const int u = u0 + q * kConsumers;
      if (u >= rows * kGroups) break;
      uint32_t h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        h[e] = bf16_bits((int8_t)(raw[q] >> (8 * e)));
      *reinterpret_cast<uint2*>(ws + swz(u / kGroups, 8 * (u % kGroups))) =
          make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
    }
  }
  fence_proxy_async();
  consumer_sync();
}

// One launch: cluster c of the grid walks items c, c + clusters, ...; its
// block of rank r covers K from r * k_slice.  Threads 0..255 consume (rows
// 64 * warpgroup..), threads 256..383 produce.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
ternary_matmul_kernel(const __grid_constant__ CUtensorMap tx, const Params p) {
  using G = Geometry<kBf16>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ws = ring + kStages * G::kStageBytes;
  float* red = reinterpret_cast<float*>(ws + p.kw * kBN * 2);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(red) + (p.split > 1 ? kRedBytes : 0));
  uint64_t* empty = full + kStages;
  uint64_t* red_full = empty + kStages;   // partial rows from the cluster

  const int tid = threadIdx.x;
  const int rank = p.split > 1 ? (int)cluster_ctarank() : 0;
  const int cluster = blockIdx.x / p.split;
  const int n_clusters = gridDim.x / p.split;
  const int k_begin = rank * p.k_slice;
  const int k_len = min(p.k_slice, p.K - k_begin);
  const int n_st = (k_len + kBK - 1) / kBK;
  // split K: block `rank` sums rows rank * share.. of the tile
  const int share = (kBM + p.split - 1) / p.split;
  const int mine = min(share, kBM - rank * share);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], p.path == kPathTma ? 1 : 128);
      mbar_init(&empty[s], kConsumers / 32);   // lane 0 of each warp
    }
    mbar_init(red_full, 1);
    mbar_fence_init();
    if (p.split > 1)
      mbar_arrive_expect_tx(red_full, (p.split - 1) * mine * kRedStride * 4);
  }
  __syncthreads();
  // The cluster's blocks copy into each other's shared memory only after
  // all have started and set red_full: arrive now, wait before the first
  // copy.
  if (p.split > 1) cluster_arrive();

  if (tid >= kConsumers) {
    // The producer.  TMA: one thread issues; cp.async: all 128 copy.
    const int ptid = tid - kConsumers;
    const bool loads = p.path != kPathTma || ptid == 0;
    if (p.path == kPathTma && ptid == 0) prefetch_tensormap(&tx);
    if (!loads && p.split == 1) return;
    uint32_t it = 0;
    for (int item = cluster; loads && item < p.n_items; item += n_clusters) {
      const int row0 = (item % p.tiles_m) * kBM;
      for (int st = 0; st < n_st; ++st, ++it) {
        const int s = it % kStages;
        const int k0 = k_begin + st * kBK;
        if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
        uint8_t* stage = ring + s * G::kStageBytes;
        if (p.path == kPathTma) {
          // panels wholly past K are not loaded; the consumers do not read
          // them
          const int panels =
              min(G::kPanels, (p.K - k0 + G::kPanelCols - 1) / G::kPanelCols);
          mbar_arrive_expect_tx(&full[s], panels * G::kPanelBytes);
          for (int q = 0; q < panels; ++q)
            tma_load_3d(stage + q * G::kPanelBytes, &tx, &full[s],
                        k0 + q * G::kPanelCols, row0, 0);
        } else {
          copy_stage<kBf16>(stage, p, row0, k0, ptid, &full[s]);
        }
      }
    }
    if (p.split > 1) {   // the two cluster barriers of the epilogue
      cluster_wait();
      cluster_arrive_relaxed();
      cluster_wait();
    }
    return;
  }

  const int warp = tid / 32;          // 0..7: rows 16 * warp..
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int frow = warp * 16 + g;     // fragment rows frow and frow + 8
  const int n_chunks = (n_st * kBK + p.kw - 1) / p.kw;

  float acc[kBN / 2], d[kBN / 2];
  int w_key = -1;                     // (column tile, chunk) held in ws
  uint32_t it = 0;
  for (int item = cluster; item < p.n_items; item += n_clusters) {
    const int j = item / p.tiles_m;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.0f;
    for (int st = 0; st < n_st; ++st, ++it) {
      const int kst = st * kBK;       // from k_begin
      const int chunk = kst / p.kw;
      const int ro = kst - chunk * p.kw;   // the stage's first row in ws
      if (j * n_chunks + chunk != w_key) {
        w_key = j * n_chunks + chunk;
        load_w(ws, p, j, k_begin + chunk * p.kw,
               min(p.kw, n_st * kBK - chunk * p.kw), tid);
      }
      // k16 steps wholly past K read zeros (their panel was not loaded)
      const int nkk = min(kBK / 16, (p.K - k_begin - kst + 15) / 16);
      const int s = it % kStages;
      const uint8_t* stage = ring + s * G::kStageBytes;
      mbar_wait(&full[s], (it / kStages) & 1);

      // A fragment of k16 step kk: {row frow, frow + 8} x {cols 2t, 2t +
      // 1, 2t + 8, 2t + 9} of its 16 columns, e = 0..3 as wgmma orders it.
      // bf16 x is loaded as the fragment.  f32 x is loaded, the stage
      // released, and each value split in three; where none of a thread's
      // values has a bit in its low 16 (each is a bf16, as {0,1} x is),
      // mid = lo = 0 and the thread skips the split, and where that holds
      // for the whole warpgroup the mid and lo passes are skipped too.
      uint32_t a[kBK / 16][G::kParts][4];
      [[maybe_unused]] float2 v[kBK / 16][4];
      [[maybe_unused]] uint32_t low = 0;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = frow + 8 * (e & 1);
          if constexpr (kBf16) {
            const int b = 32 * kk + 16 * (e >> 1) + 4 * t;
            a[kk][0][e] = kk < nkk ? *reinterpret_cast<const uint32_t*>(
                                         stage + swz(row, b))
                                   : 0u;
          } else {
            const int b = 64 * (kk & 1) + 32 * (e >> 1) + 8 * t;
            v[kk][e] = kk < nkk ? *reinterpret_cast<const float2*>(
                                      stage + (kk >> 1) * G::kPanelBytes +
                                      swz(row, b))
                                : make_float2(0.0f, 0.0f);
            low |= (__float_as_uint(v[kk][e].x) |
                    __float_as_uint(v[kk][e].y)) & 0xFFFFu;
          }
        }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);

      const uint8_t* wrow = ws + ro * 128;
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) d[i] = 0.0f;
      fence_regs(d);
      if constexpr (!kBf16) {
        if (low != 0) {
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              split3(v[kk][e].x, v[kk][e].y, a[kk][0][e], a[kk][1][e],
                     a[kk][2][e]);
        } else {
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              a[kk][0][e] = __byte_perm(__float_as_uint(v[kk][e].x),
                                        __float_as_uint(v[kk][e].y), 0x7632);
              a[kk][1][e] = a[kk][2][e] = 0u;
            }
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs_tb<kBN>(d, a[kk][0], make_desc(wrow + kk * 16 * 128,
                                                p.kw * 128, 8 * 128, 128));
      // the mid and lo passes, unless the whole warpgroup's are zero
      if constexpr (!kBf16) {
        if (warpgroup_any(low != 0, warp / 4)) {
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
            for (int part = 1; part < G::kParts; ++part)
              wgmma_rs_tb<kBN>(d, a[kk][part],
                               make_desc(wrow + kk * 16 * 128, p.kw * 128,
                                         8 * 128, 128));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(d);
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[i] += d[i];
    }

    // Element i of the accumulator: row frow + 8 * ((i / 2) % 2), column
    // 8 * (i / 4) + 2t + i % 2 of the tile.
    const long long row0 = (long long)(item % p.tiles_m) * kBM;
    if (p.split == 1) {
      const bool pairs = p.N % 2 == 0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long row = row0 + frow + 8 * r;
        if (row >= p.B) continue;
        float* orow = p.out + row * p.N;
#pragma unroll
        for (int c = 0; c < kBN / 8; ++c) {
          const int n = j * kBN + 8 * c + 2 * t;
          const float v0 = acc[4 * c + 2 * r], v1 = acc[4 * c + 2 * r + 1];
          if (pairs && n + 1 < p.N) {
            *reinterpret_cast<float2*>(orow + n) = make_float2(v0, v1);
          } else {
            if (n < p.N) orow[n] = v0;
            if (n + 1 < p.N) orow[n + 1] = v1;
          }
        }
      }
    } else {
      // Split K (one tile per cluster).  The partial tile goes to the ring
      // as [128][kRedStride]; the rows of block q's share go by one bulk
      // copy to slot `rank` of q's `red` ([split][share][kRedStride]),
      // counted in bytes on q's red_full.  The ring is idle only once both
      // warpgroups have read their last stage: a warpgroup syncs only its
      // own threads and may be a stage ahead of the other, whose fragments
      // its partial rows would overwrite.
      float* part = reinterpret_cast<float*>(ring);
      consumer_sync();
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < kBN / 8; ++c)
          *reinterpret_cast<float2*>(part + (frow + 8 * r) * kRedStride +
                                     8 * c + 2 * t) =
              make_float2(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
      fence_proxy_async();
      consumer_sync();
      cluster_wait();   // every block has started and set its red_full
      if (tid == 0)
        for (int q = 0; q < p.split; ++q)
          if (q != rank)
            bulk_copy_to_cluster(
                cluster_map(red + rank * share * kRedStride, q),
                part + q * share * kRedStride,
                min(share, kBM - q * share) * kRedStride * 4,
                cluster_map(red_full, q));
      mbar_wait(red_full, 0);
      // the copies into this block have landed, so have read their
      // sources; no block exits before all have (no data to publish: a
      // relaxed arrival)
      cluster_arrive_relaxed();
      // the sum over the slots in rank order 0, 1, ..., split - 1
      const bool quads =
          p.N % 4 == 0 && reinterpret_cast<uintptr_t>(p.out) % 16 == 0;
      for (int u = tid; u < mine * (kBN / 8); u += kConsumers) {
        const int lrow = u / (kBN / 8), c8 = 8 * (u % (kBN / 8));
        float sum[8];
        for (int q = 0; q < p.split; ++q) {
          const float* src = (q == rank ? part : red) +
                             (q * share + lrow) * kRedStride + c8;
          const float4 v0 = *reinterpret_cast<const float4*>(src);
          const float4 v1 = *reinterpret_cast<const float4*>(src + 4);
          const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
          for (int e = 0; e < 8; ++e) sum[e] = q == 0 ? v[e] : sum[e] + v[e];
        }
        const long long grow = row0 + rank * share + lrow;
        const int n = j * kBN + c8;
        if (grow >= p.B || n >= p.N) continue;
        float* out = p.out + grow * p.N + n;
        if (quads && n + 8 <= p.N) {
          *reinterpret_cast<float4*>(out) =
              make_float4(sum[0], sum[1], sum[2], sum[3]);
          *reinterpret_cast<float4*>(out + 4) =
              make_float4(sum[4], sum[5], sum[6], sum[7]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (n + e < p.N) out[e] = sum[e];
        }
      }
      cluster_wait();
    }
  }
}

template <bool kBf16>
cudaError_t launch(const Params& p, int clusters, cudaStream_t stream) {
  using G = Geometry<kBf16>;
  CUtensorMap tx;
  memset(&tx, 0, sizeof(tx));
  cudaError_t err = cudaSuccess;
  if (p.path == kPathTma)
    err = encode_tiled_3d(
        &tx, p.x, p.K, p.B, 1, G::kPanelCols, kBM,
        kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
              : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
        G::kElem);
  if (err != cudaSuccess) return err;
  auto kern = ternary_matmul_kernel<kBf16>;
  const int smem = smem_bytes(kBf16, p.kw, p.split);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * p.split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, tx, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// How many clusters of `split` blocks, with kw resident weight rows, the
// card holds at once (cudaOccupancyMaxActiveClusters), into *n.  Returns a
// CUDA error.
extern "C" int ternary_matmul_max_clusters(int x_bf16, int split, int kw,
                                           int* n) {
  if (split < 1 || split > kMaxSplit || kw < kBK) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(x_bf16, kw, split);
  auto kern = x_bf16 ? ternary_matmul_kernel<true> : ternary_matmul_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(n, kern, &cfg);
}

// One launch as `plan` in kernels/ternary_matmul.py laid it out; returns
// cudaErrorInvalidValue, launching nothing, for a plan this kernel cannot
// run.
extern "C" int ternary_matmul_launch(const void* x, const void* w, void* out,
                                     int B, int K, int N, int x_bf16,
                                     int path, int split, int k_slice, int kw,
                                     int clusters, void* stream) {
  const int elem = x_bf16 ? 2 : 4;
  const uintptr_t base = reinterpret_cast<uintptr_t>(x);
  const int tiles_m = (B + kBM - 1) / kBM, tiles_n = (N + kBN - 1) / kBN;
  const long long items = (long long)tiles_m * tiles_n;
  const bool plan_ok =
      B > 0 && K > 0 && N > 0 && split >= 1 && split <= kMaxSplit &&
      k_slice > 0 && k_slice % kBK == 0 &&
      (long long)k_slice * (split - 1) < K &&
      (long long)k_slice * split >= K && kw >= kBK && kw % kBK == 0 &&
      kw <= k_slice && clusters >= 1 && clusters <= items &&
      (split == 1 || clusters == items) &&
      (long long)clusters * split <= 0x7FFFFFFF &&
      smem_bytes(x_bf16, kw, split) <= kSmemMax;
  const bool path_ok =
      (path == kPathTma && base % 16 == 0 && ((long long)K * elem) % 16 == 0)
      || (path == kPathCpAsync && base % 4 == 0 && (!x_bf16 || K % 2 == 0))
      || (path == kPathLoad && x_bf16);
  if (!plan_ok || !path_ok || items > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  Params p{x, static_cast<const int8_t*>(w), static_cast<float*>(out),
           B, K, N, path, split, k_slice, kw, tiles_m, (int)items};
  auto st = static_cast<cudaStream_t>(stream);
  return (int)(x_bf16 ? launch<true>(p, clusters, st)
                      : launch<false>(p, clusters, st));
}
