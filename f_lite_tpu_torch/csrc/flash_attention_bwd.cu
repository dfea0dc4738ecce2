// Flash-attention backward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernels `_dq_kernel` and `_dkv_kernel` (f_lite_tpu/ops/
// pallas/flash_attention.py, launched by `_flash_backward`). For q, dO
// (B,H,Lq,D), k, v (B,H,Lk,D), the forward's row log-sum-exp lse (B,H,Lq)
// and D = rowsum(dO * O) (B,H,Lq), both fp32 and computed outside (FA2):
//   P  = exp(scale * Q K^T - lse), 0 at keys j >= kv_lens[b]
//   dP = dO V^T,  dS = P * (dP - D)
//   dq = scale * dS K          (dq kernel: one block per 64-row q tile,
//                               key tiles up to kv_len only)
//   dv = P^T dO, dk = scale * dS^T Q
//                              (dkv kernel: one block per 64-row key tile,
//                               every q tile; tiles at or past kv_len
//                               write zeros and load nothing)
// As in the TPU kernels, P is rounded to dO's dtype before P^T dO and dS to
// q's dtype before the dq and dk products; sums are fp32.
//
// Masking never multiplies an overflowed exponent: P is selected to 0 at
// masked keys (and at q rows past Lq) before any product, so keys at or past
// kv_len get dk = dv = 0 exactly and a kv_len == 0 batch row (lse
// kLseEmpty) gets dq = 0, visiting no key tile.
//
// bf16 design: 8 warps per block. Warp w owns the 16-row m-tile (w & 3) of
// the block's 64 rows and half (w >> 2) of the other side: while computing
// S and dP it takes 32 of the streamed tile's 64 columns (two warps share
// an m-tile), and while accumulating it takes D/2 of the output columns.
// P and dS go through shared memory (bf16) between the two phases. All
// products are mma.sync m16n8k16 bf16 -> fp32, operands from shared memory
// through ldmatrix; the block holds its own 64 rows of Q and dO (dq) or K
// and V (dkv) and streams the other side's tiles with cp.async. The
// accumulators are 16 x D/2 per warp: 64 fp32 registers a thread for dq,
// 128 for dk + dv at D = 256.
//
// fp32 design (the parity type): plain FMA on CUDA cores, 128 threads, 16
// rows per block, tiles of 32 streamed rows, S / dP / dS in shared memory.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): dq needs 3
// products (6*B*H*Lq*Lk*D flops over the real keys), dkv 4 (8*...); at the
// training shapes self-attention is operation-bound and cross-attention
// over short text byte-bound. This simple mma.sync design recomputes S and
// dP in both kernels (7 products where a fused design needs 5) and does not
// overlap loads with products; wgmma, TMA and a fused dq are later work.
//
// Entry points return cudaGetLastError() after the launch (0 on success).
// dtype: 0 = fp32, 1 = bf16. kv_lens may be null (every key is real).

#include <math.h>
#include <stdint.h>

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

using bf16 = __nv_bfloat16;

constexpr int kBwdThreads = 256;  // 8 warps
constexpr int kTile = 64;         // block rows, and rows of a streamed tile
constexpr int kPStride = kTile + 8;  // row stride of the P / dS buffers

// c (16 rows x 32 cols) = A[a_row0 .. +16, :] * B[b_row0 .. +32, :]^T over
// D, both row-major (rows, D) in shared memory with stride D + 8.
template <int D>
__device__ __forceinline__ void warp_abt(float (&c)[4][4], const bf16* sA,
                                         int a_row0, const bf16* sB,
                                         int b_row0, int lane) {
  constexpr int kStride = D + 8;
  const int mi = lane >> 3;
  const int mr = lane & 7;
#pragma unroll
  for (int j = 0; j < 4; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a0, a1, a2, a3;
    ldsm_x4(smem_u32(sA + (a_row0 + (lane & 15)) * kStride + kk * 16 +
                     (lane >> 4) * 8),
            a0, a1, a2, a3);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4(smem_u32(sB + (b_row0 + nj * 16 + mr + (mi >> 1) * 8) * kStride +
                       kk * 16 + (mi & 1) * 8),
              b0, b1, b2, b3);
      mma_bf16(c[2 * nj], a0, a1, a2, a3, b0, b1);
      mma_bf16(c[2 * nj + 1], a0, a1, a2, a3, b2, b3);
    }
  }
}

// acc (16 rows x N cols) += P[p_row0 .. +16, 0 .. 64) * B[0 .. 64, b_col0 ..
// + N): P row-major with stride kPStride, B row-major with stride D + 8.
template <int D, int N>
__device__ __forceinline__ void warp_acc_pb(float (&acc)[N / 8][4],
                                            const bf16* sP, int p_row0,
                                            const bf16* sB, int b_col0,
                                            int lane) {
  constexpr int kStride = D + 8;
  const int mi = lane >> 3;
  const int mr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    uint32_t a0, a1, a2, a3;
    ldsm_x4(smem_u32(sP + (p_row0 + (lane & 15)) * kPStride + kk * 16 +
                     (lane >> 4) * 8),
            a0, a1, a2, a3);
#pragma unroll
    for (int nj = 0; nj < N / 16; ++nj) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_trans(smem_u32(sB + (kk * 16 + mr + (mi & 1) * 8) * kStride +
                             b_col0 + nj * 16 + (mi >> 1) * 8),
                    b0, b1, b2, b3);
      mma_bf16(acc[2 * nj], a0, a1, a2, a3, b0, b1);
      mma_bf16(acc[2 * nj + 1], a0, a1, a2, a3, b2, b3);
    }
  }
}

// Store a 16 x 32 fp32 fragment (rows row0 + g, + 8; cols col0 + ...) to a
// bf16 buffer with stride kPStride.
__device__ __forceinline__ void store_frag(bf16* sP, const float (&c)[4][4],
                                           int row0, int col0, int lane) {
  const int g = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = col0 + j * 8 + tig * 2;
    *reinterpret_cast<__nv_bfloat162*>(sP + (row0 + g) * kPStride + col) =
        __floats2bfloat162_rn(c[j][0], c[j][1]);
    *reinterpret_cast<__nv_bfloat162*>(sP + (row0 + g + 8) * kPStride + col) =
        __floats2bfloat162_rn(c[j][2], c[j][3]);
  }
}

// Write a warp's 16 x N accumulator (rows row0 + g, + 8; cols col0 + ...)
// times `mul` to a (rows, D) bf16 matrix; rows at or past `limit` skipped.
template <int D, int N>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[N / 8][4],
                                           int row0, int col0, int limit,
                                           float mul, int lane) {
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int row = row0 + g;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = col0 + j * 8 + tig * 2;
    if (row < limit) {
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row) * D +
                                         col) =
          __floats2bfloat162_rn(acc[j][0] * mul, acc[j][1] * mul);
    }
    if (row + 8 < limit) {
      *reinterpret_cast<__nv_bfloat162*>(
          out + static_cast<size_t>(row + 8) * D + col) =
          __floats2bfloat162_rn(acc[j][2] * mul, acc[j][3] * mul);
    }
  }
}

template <int D>
constexpr size_t dq_bf16_smem_bytes() {
  return (4 * kTile * (D + 8) + kTile * kPStride) * sizeof(bf16);
}

template <int D>
constexpr size_t dkv_bf16_smem_bytes() {
  return (4 * kTile * (D + 8) + 2 * kTile * kPStride) * sizeof(bf16) +
         2 * kTile * sizeof(float);
}

// ---------------------------------------------------------------------------
// bf16 dq kernel
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const int* __restrict__ kv_lens,
                             bf16* __restrict__ dq, int H, int Lq, int Lk,
                             float scale) {
  constexpr int kStride = D + 8;
  constexpr int kHalfD = D / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sDO = sQ + kTile * kStride;
  bf16* sK = sDO + kTile * kStride;
  bf16* sV = sK + kTile * kStride;
  bf16* sDS = sV + kTile * kStride;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int mt = warp & 3;    // 16-row m-tile of the block's q rows
  const int half = warp >> 2;  // which 32 keys of a tile / D/2 of dq

  const size_t bh = static_cast<size_t>(b) * H + h;
  const bf16* qg = q + bh * Lq * D;
  const bf16* dog = dout + bh * Lq * D;
  const bf16* kg = k + bh * Lk * D;
  const bf16* vg = v + bh * Lk * D;

  int kv_len = kv_lens != nullptr ? kv_lens[b] : Lk;
  kv_len = max(0, min(kv_len, Lk));
  const int n_tiles = (kv_len + kTile - 1) / kTile;

  load_tile<D, kTile, kBwdThreads>(sQ, qg, q0, Lq, tid);
  load_tile<D, kTile, kBwdThreads>(sDO, dog, q0, Lq, tid);
  cp_async_commit();

  // rows q0 + mt*16 + g and + 8: lse (log2 domain) and D; 0 past Lq, where
  // Q and dO are zero-filled, so dS is 0 there
  const int row0 = q0 + mt * 16 + g;
  float lse2[2], dval[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    lse2[r] = row < Lq ? lse[bh * Lq + row] * kLog2e : 0.f;
    dval[r] = row < Lq ? delta[bh * Lq + row] : 0.f;
  }
  const float scale_log2 = scale * kLog2e;

  float acc[kHalfD / 8][4];
#pragma unroll
  for (int j = 0; j < kHalfD / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    load_tile<D, kTile, kBwdThreads>(sK, kg, k0, Lk, tid);
    load_tile<D, kTile, kBwdThreads>(sV, vg, k0, Lk, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[4][4], dp[4][4];
    warp_abt<D>(s, sQ, mt * 16, sK, half * 32, lane);
    warp_abt<D>(dp, sDO, mt * 16, sV, half * 32, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + half * 32 + j * 8 + tig * 2 + (e & 1);
        const float p =
            col < kv_len ? exp2f(s[j][e] * scale_log2 - lse2[e >> 1]) : 0.f;
        s[j][e] = p * (dp[j][e] - dval[e >> 1]);
      }
    }
    store_frag(sDS, s, mt * 16, half * 32, lane);
    __syncthreads();

    warp_acc_pb<D, kHalfD>(acc, sDS, mt * 16, sK, half * kHalfD, lane);
    __syncthreads();  // sK, sV and sDS are rewritten by the next tile
  }
  cp_async_wait<0>();  // when kv_len == 0 nothing waited for the Q copy

  store_rows<D, kHalfD>(dq + bh * Lq * D, acc, q0 + mt * 16,
                        half * kHalfD, Lq, scale, lane);
}

// ---------------------------------------------------------------------------
// bf16 dkv kernel
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const int* __restrict__ kv_lens,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              int H, int Lq, int Lk, float scale) {
  constexpr int kStride = D + 8;
  constexpr int kHalfD = D / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kTile * kStride;
  bf16* sQ = sV + kTile * kStride;
  bf16* sDO = sQ + kTile * kStride;
  bf16* sP = sDO + kTile * kStride;
  bf16* sDS = sP + kTile * kPStride;
  float* sLse = reinterpret_cast<float*>(sDS + kTile * kPStride);
  float* sDelta = sLse + kTile;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int mt = warp & 3;    // 16-row m-tile of the block's keys
  const int half = warp >> 2;  // which 32 q rows of a tile / D/2 of dk, dv

  const size_t bh = static_cast<size_t>(b) * H + h;
  const bf16* qg = q + bh * Lq * D;
  const bf16* dog = dout + bh * Lq * D;
  const bf16* kg = k + bh * Lk * D;
  const bf16* vg = v + bh * Lk * D;

  int kv_len = kv_lens != nullptr ? kv_lens[b] : Lk;
  kv_len = max(0, min(kv_len, Lk));
  const float scale_log2 = scale * kLog2e;
  const int key0 = k0 + mt * 16 + g;  // this thread's keys: key0 and + 8

  float acc_dk[kHalfD / 8][4], acc_dv[kHalfD / 8][4];
#pragma unroll
  for (int j = 0; j < kHalfD / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;
  }

  if (k0 < kv_len) {  // block-uniform: a tile past kv_len only writes zeros
    load_tile<D, kTile, kBwdThreads>(sK, kg, k0, Lk, tid);
    load_tile<D, kTile, kBwdThreads>(sV, vg, k0, Lk, tid);
    cp_async_commit();
    for (int q0 = 0; q0 < Lq; q0 += kTile) {
      load_tile<D, kTile, kBwdThreads>(sQ, qg, q0, Lq, tid);
      load_tile<D, kTile, kBwdThreads>(sDO, dog, q0, Lq, tid);
      cp_async_commit();
      if (tid < kTile) {
        const int row = q0 + tid;
        sLse[tid] = row < Lq ? lse[bh * Lq + row] * kLog2e : 0.f;
        sDelta[tid] = row < Lq ? delta[bh * Lq + row] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      // S^T and dP^T for keys of m-tile mt and q columns half*32 .. + 32
      float s[4][4], dp[4][4];
      warp_abt<D>(s, sK, mt * 16, sQ, half * 32, lane);
      warp_abt<D>(dp, sV, mt * 16, sDO, half * 32, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + (e >> 1) * 8;
          const int qc = half * 32 + j * 8 + tig * 2 + (e & 1);
          const bool ok = key < kv_len && q0 + qc < Lq;
          const float p = ok ? exp2f(s[j][e] * scale_log2 - sLse[qc]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - sDelta[qc]);
        }
      }
      store_frag(sP, s, mt * 16, half * 32, lane);
      store_frag(sDS, dp, mt * 16, half * 32, lane);
      __syncthreads();

      warp_acc_pb<D, kHalfD>(acc_dv, sP, mt * 16, sDO, half * kHalfD, lane);
      warp_acc_pb<D, kHalfD>(acc_dk, sDS, mt * 16, sQ, half * kHalfD, lane);
      __syncthreads();  // sQ, sDO, sP, sDS are rewritten by the next tile
    }
  }

  store_rows<D, kHalfD>(dk + bh * Lk * D, acc_dk, k0 + mt * 16,
                        half * kHalfD, Lk, scale, lane);
  store_rows<D, kHalfD>(dv + bh * Lk * D, acc_dv, k0 + mt * 16,
                        half * kHalfD, Lk, 1.f, lane);
}

// ---------------------------------------------------------------------------
// fp32 FMA instances (parity type)
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 128;
constexpr int kF32Rows = 16;    // block rows (q rows for dq, keys for dkv)
constexpr int kF32Cols = 32;    // rows of a streamed tile
constexpr int kF32SS = kF32Cols + 1;

template <int D>
constexpr size_t dq_f32_smem_bytes() {
  return (2 * kF32Rows * D + 2 * kF32Cols * (D + 1) + kF32Rows * kF32SS +
          2 * kF32Rows) *
         sizeof(float);
}

template <int D>
constexpr size_t dkv_f32_smem_bytes() {
  return (2 * kF32Rows * D + 2 * kF32Cols * (D + 1) + 2 * kF32Rows * kF32SS +
          2 * kF32Cols) *
         sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const int* __restrict__ kv_lens,
                            float* __restrict__ dq, int H, int Lq, int Lk,
                            float scale) {
  constexpr int kKS = D + 1;
  constexpr int kPer = kF32Rows * D / kF32Threads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sDO = sQ + kF32Rows * D;
  float* sK = sDO + kF32Rows * D;
  float* sV = sK + kF32Cols * kKS;
  float* sDS = sV + kF32Cols * kKS;
  float* sLse = sDS + kF32Rows * kF32SS;
  float* sDelta = sLse + kF32Rows;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kF32Rows;
  const int tid = threadIdx.x;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const float* qg = q + bh * Lq * D;
  const float* dog = dout + bh * Lq * D;
  const float* kg = k + bh * Lk * D;
  const float* vg = v + bh * Lk * D;

  int kv_len = kv_lens != nullptr ? kv_lens[b] : Lk;
  kv_len = max(0, min(kv_len, Lk));
  const int n_tiles = (kv_len + kF32Cols - 1) / kF32Cols;

  for (int i = tid; i < kF32Rows * D; i += kF32Threads) {
    const bool valid = q0 + i / D < Lq;
    const size_t off = static_cast<size_t>(q0) * D + i;
    sQ[i] = valid ? qg[off] : 0.f;
    sDO[i] = valid ? dog[off] : 0.f;
  }
  if (tid < kF32Rows) {
    const bool valid = q0 + tid < Lq;
    sLse[tid] = valid ? lse[bh * Lq + q0 + tid] : 0.f;
    sDelta[tid] = valid ? delta[bh * Lq + q0 + tid] : 0.f;
  }
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kF32Cols;
    __syncthreads();  // previous tile consumed (and the Q load done)
    for (int i = tid; i < kF32Cols * D; i += kF32Threads) {
      const int r = i / D;
      const int d = i % D;
      const bool valid = k0 + r < Lk;
      const size_t off = static_cast<size_t>(k0 + r) * D + d;
      sK[r * kKS + d] = valid ? kg[off] : 0.f;
      sV[r * kKS + d] = valid ? vg[off] : 0.f;
    }
    __syncthreads();

    for (int e = tid; e < kF32Rows * kF32Cols; e += kF32Threads) {
      const int r = e / kF32Cols;
      const int j = e % kF32Cols;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        s = fmaf(sQ[r * D + d], sK[j * kKS + d], s);
        dp = fmaf(sDO[r * D + d], sV[j * kKS + d], dp);
      }
      const float p = k0 + j < kv_len ? expf(s * scale - sLse[r]) : 0.f;
      sDS[r * kF32SS + j] = p * (dp - sDelta[r]);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kF32Threads;
      const int r = e / D;
      const int d = e % D;
      float a = acc[i];
      for (int j = 0; j < kF32Cols; ++j)
        a = fmaf(sDS[r * kF32SS + j], sK[j * kKS + d], a);
      acc[i] = a;
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kF32Threads;
    const int r = e / D;
    const int d = e % D;
    if (q0 + r < Lq) dq[bh * Lq * D + static_cast<size_t>(q0 + r) * D + d] =
        acc[i] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const int* __restrict__ kv_lens,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int H, int Lq, int Lk, float scale) {
  constexpr int kQS = D + 1;
  constexpr int kPer = kF32Rows * D / kF32Threads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + kF32Rows * D;
  float* sQ = sV + kF32Rows * D;
  float* sDO = sQ + kF32Cols * kQS;
  float* sP = sDO + kF32Cols * kQS;
  float* sDS = sP + kF32Rows * kF32SS;
  float* sLse = sDS + kF32Rows * kF32SS;
  float* sDelta = sLse + kF32Cols;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int k0 = blockIdx.x * kF32Rows;
  const int tid = threadIdx.x;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const float* qg = q + bh * Lq * D;
  const float* dog = dout + bh * Lq * D;
  const float* kg = k + bh * Lk * D;
  const float* vg = v + bh * Lk * D;

  int kv_len = kv_lens != nullptr ? kv_lens[b] : Lk;
  kv_len = max(0, min(kv_len, Lk));

  float acc_dk[kPer], acc_dv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  if (k0 < kv_len) {  // block-uniform: a tile past kv_len only writes zeros
    for (int i = tid; i < kF32Rows * D; i += kF32Threads) {
      const bool valid = k0 + i / D < Lk;
      const size_t off = static_cast<size_t>(k0) * D + i;
      sK[i] = valid ? kg[off] : 0.f;
      sV[i] = valid ? vg[off] : 0.f;
    }
    for (int q0 = 0; q0 < Lq; q0 += kF32Cols) {
      __syncthreads();  // previous tile consumed
      for (int i = tid; i < kF32Cols * D; i += kF32Threads) {
        const int r = i / D;
        const int d = i % D;
        const bool valid = q0 + r < Lq;
        const size_t off = static_cast<size_t>(q0 + r) * D + d;
        sQ[r * kQS + d] = valid ? qg[off] : 0.f;
        sDO[r * kQS + d] = valid ? dog[off] : 0.f;
      }
      if (tid < kF32Cols) {
        const bool valid = q0 + tid < Lq;
        sLse[tid] = valid ? lse[bh * Lq + q0 + tid] : 0.f;
        sDelta[tid] = valid ? delta[bh * Lq + q0 + tid] : 0.f;
      }
      __syncthreads();

      for (int e = tid; e < kF32Rows * kF32Cols; e += kF32Threads) {
        const int r = e / kF32Cols;  // key
        const int j = e % kF32Cols;  // q row
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          s = fmaf(sK[r * D + d], sQ[j * kQS + d], s);
          dp = fmaf(sV[r * D + d], sDO[j * kQS + d], dp);
        }
        const bool ok = k0 + r < kv_len && q0 + j < Lq;
        const float p = ok ? expf(s * scale - sLse[j]) : 0.f;
        sP[r * kF32SS + j] = p;
        sDS[r * kF32SS + j] = p * (dp - sDelta[j]);
      }
      __syncthreads();

#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = tid + i * kF32Threads;
        const int r = e / D;
        const int d = e % D;
        float a_dv = acc_dv[i], a_dk = acc_dk[i];
        for (int j = 0; j < kF32Cols; ++j) {
          a_dv = fmaf(sP[r * kF32SS + j], sDO[j * kQS + d], a_dv);
          a_dk = fmaf(sDS[r * kF32SS + j], sQ[j * kQS + d], a_dk);
        }
        acc_dv[i] = a_dv;
        acc_dk[i] = a_dk;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kF32Threads;
    const int r = e / D;
    const int d = e % D;
    if (k0 + r < Lk) {
      const size_t off = bh * Lk * D + static_cast<size_t>(k0 + r) * D + d;
      dk[off] = acc_dk[i] * scale;
      dv[off] = acc_dv[i];
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  const int* kv_lens;
  int B, H, Lq, Lk;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dq_bf16(const BwdArgs& a, void* dq) {
  constexpr size_t smem = dq_bf16_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_bwd_dq_bf16_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + kTile - 1) / kTile, a.H, a.B);
  flash_bwd_dq_bf16_kernel<D><<<grid, kBwdThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, a.kv_lens, static_cast<bf16*>(dq), a.H, a.Lq, a.Lk, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_bf16(const BwdArgs& a, void* dk, void* dv) {
  constexpr size_t smem = dkv_bf16_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_bwd_dkv_bf16_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lk + kTile - 1) / kTile, a.H, a.B);
  flash_bwd_dkv_bf16_kernel<D><<<grid, kBwdThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, a.kv_lens, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      a.H, a.Lq, a.Lk, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_f32(const BwdArgs& a, void* dq) {
  constexpr size_t smem = dq_f32_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_bwd_dq_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + kF32Rows - 1) / kF32Rows, a.H, a.B);
  flash_bwd_dq_f32_kernel<D><<<grid, kF32Threads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, a.kv_lens, static_cast<float*>(dq), a.H, a.Lq, a.Lk,
      a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const BwdArgs& a, void* dk, void* dv) {
  constexpr size_t smem = dkv_f32_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_bwd_dkv_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lk + kF32Rows - 1) / kF32Rows, a.H, a.B);
  flash_bwd_dkv_f32_kernel<D><<<grid, kF32Threads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, a.kv_lens, static_cast<float*>(dk),
      static_cast<float*>(dv), a.H, a.Lq, a.Lk, a.scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      const int* kv_lens, void* dq, int B,
                                      int H, int Lq, int Lk, int D,
                                      float scale, int dtype, void* stream) {
  const BwdArgs a{q,  k,  v,  dout, lse,   delta,
                  kv_lens, B, H, Lq, Lk, scale,
                  static_cast<cudaStream_t>(stream)};
  if (dtype == 1 && D == 64) return launch_dq_bf16<64>(a, dq);
  if (dtype == 1 && D == 256) return launch_dq_bf16<256>(a, dq);
  if (dtype == 0 && D == 64) return launch_dq_f32<64>(a, dq);
  if (dtype == 0 && D == 256) return launch_dq_f32<256>(a, dq);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* delta,
                                       const int* kv_lens, void* dk, void* dv,
                                       int B, int H, int Lq, int Lk, int D,
                                       float scale, int dtype, void* stream) {
  const BwdArgs a{q,  k,  v,  dout, lse,   delta,
                  kv_lens, B, H, Lq, Lk, scale,
                  static_cast<cudaStream_t>(stream)};
  if (dtype == 1 && D == 64) return launch_dkv_bf16<64>(a, dk, dv);
  if (dtype == 1 && D == 256) return launch_dkv_bf16<256>(a, dk, dv);
  if (dtype == 0 && D == 64) return launch_dkv_f32<64>(a, dk, dv);
  if (dtype == 0 && D == 256) return launch_dkv_f32<256>(a, dk, dv);
  return static_cast<int>(cudaErrorInvalidValue);
}
