// Flash-attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel `_fa_fwd_kernel` (f_lite_tpu/ops/pallas/
// flash_attention.py:92, pallas_call :243). Computes, for q (B,H,Lq,D) and
// k, v (B,H,Lk,D), all contiguous:
//   O = softmax(scale * Q K^T, keys j >= kv_lens[b] masked) V
// with fp32 online-softmax statistics (exp2 of log2-scaled logits), P
// rounded to bf16 before P V, an unnormalised fp32 accumulator divided by
// the row sum once at the end, and zero rows where kv_len == 0. When `lse`
// is not null (the training path) it also writes the fp32 row log-sum-exp
// lse = m + log(l) of the scaled logits, (B,H,Lq), that the backward
// kernels (flash_attention_bwd.cu) recompute P from; a row that saw no key
// gets kLseEmpty, as `_fa_fwd_kernel(save_lse=True)` stores.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): self-attention
// at the serving shapes is operation-bound (4*B*H*Lq*Lk*D flops: 0.350 ms
// at B=2 H=10 L=4112 D=256, 0.85 ms at L=6416); cross-attention over 128
// padded text keys is byte-bound (q and o dominate).
//
// Two instances:
// - bf16 (serving and training): warp-specialised, for the tensor cores'
//   full rate, which only wgmma reaches: the mainloop of
//   flash_fwd_mainloop.cuh (a producer warpgroup issuing TMA loads through
//   a two-stage mbarrier ring, two consumer warpgroups of 64 query rows on
//   wgmma) with this kernel's softmax policy (`ServePolicy`): logits scaled
//   by scale * log2(e) and exp2, keys >= kv_len masked to -inf on the last
//   visited tile only (every earlier tile is full), the running max from
//   -inf. The epilogue divides by l, stores bf16 O for rows < Lq (zero rows
//   where l = 0) and lse when asked.
// - fp32 (parity): plain FMA on CUDA cores, 16 query rows per block.
//
// Entry point: flash_attention_fwd(...) returns cudaGetLastError() after
// the launch (0 on success), or one of the kErr* codes of
// flash_fwd_mainloop.cuh without launching. dtype: 0 = fp32, 1 = bf16.
// kv_lens may be null (every key is real); lse may be null (no lse
// output). bf16 q, k, v must be 16-byte aligned (TMA).

#include <math.h>
#include <stdint.h>

#include "flash_attention_common.cuh"
#include "flash_fwd_mainloop.cuh"
#include "hopper.cuh"

// Keys per K/V tile: 80 at D = 256 (Q 64 KB + two stages of K and V 160
// KB); 32 at D = 64 (two blocks an SM; a tile no wider than the fixture's
// 32 text keys, whose one-tile blocks are latency-bound). The tile trial
// (f_lite_tpu_torch/tools/forward_tiles.py) builds other values; the
// package's library always uses these.
#ifndef FLASH_FWD_BK_D256
#define FLASH_FWD_BK_D256 80
#endif
#ifndef FLASH_FWD_BK_D64
#define FLASH_FWD_BK_D64 32
#endif

namespace {

using namespace flash;
using namespace flash_fwd;
using namespace hopper;

constexpr int kThreads = 128;  // fp32 instance: 4 warps

// ---------------------------------------------------------------------------
// bf16 instance: the shared TMA + wgmma mainloop with the serving policy
// ---------------------------------------------------------------------------

template <int D>
constexpr int kBK = D == 256 ? FLASH_FWD_BK_D256 : FLASH_FWD_BK_D64;

// _fa_fwd_kernel's softmax in the log2 domain: exp2 of logits scaled by
// scale * log2(e), -inf for masked keys and the running max's start, zero
// rows where no key was seen, lse = m * ln 2 + log(l) when lse is not null.
struct ServePolicy {
  float scale_log2;
  float* lse;

  static constexpr float kMaxStart = -INFINITY;
  static constexpr float kMasked = -INFINITY;
  static constexpr bool kSelectMaskedP = false;

  __device__ __forceinline__ bool mask_tile(bool last, bool) const {
    return last;
  }
  __device__ __forceinline__ float scale(float s) const {
    return s * scale_log2;
  }
  __device__ __forceinline__ float alpha(float m_prev, float m_new) const {
    return exp2f(m_prev - m_new);
  }
  __device__ __forceinline__ float p(float s, float m) const {
    return exp2f(s - m);
  }
  // a row that saw no key (kv_len == 0) is zero
  __device__ __forceinline__ float inv_l(float l) const {
    return l > 0.f ? 1.f / l : 0.f;
  }
  __device__ __forceinline__ void store_stats(int bh, int Lq, int row,
                                              int tig, const float (&m)[2],
                                              const float (&l)[2]) const {
    if (lse != nullptr && tig == 0) {
      // m is in the log2 domain of the scaled logits
      float* lg = lse + static_cast<size_t>(bh) * Lq;
      if (row < Lq) lg[row] = l[0] > 0.f ? m[0] * kLn2 + logf(l[0]) : kLseEmpty;
      if (row + 8 < Lq)
        lg[row + 8] = l[1] > 0.f ? m[1] * kLn2 + logf(l[1]) : kLseEmpty;
    }
  }
};

template <int D>
__global__ void __launch_bounds__(kWgThreadsAll, Tiles<D, kBK<D>>::kMinBlocks)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const int* __restrict__ kv_lens,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int H, int Lq, int Lk,
                          float scale_log2) {
  int kv_len = kv_lens != nullptr ? kv_lens[blockIdx.z] : Lk;
  kv_len = max(0, min(kv_len, Lk));
  mainloop<D, kBK<D>>(&q_map, &k_map, &v_map, o, H, Lq, kv_len,
                      ServePolicy{scale_log2, lse});
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v,
                const int* kv_lens, void* o, float* lse, int B, int H, int Lq,
                int Lk, float scale, cudaStream_t stream) {
  using T = Tiles<D, kBK<D>>;
  static const int registers =
      check_registers<D, kBK<D>>(flash_fwd_bf16_kernel<D>);
  CUtensorMap q_map, k_map, v_map;
  int code = encode_maps<D, kBK<D>>(&q_map, &k_map, &v_map, q, k, v, B, H,
                                     Lq, Lk);
  if (code == 0) code = registers;
  if (code != 0) return code;
  cudaError_t err = allow_smem(flash_fwd_bf16_kernel<D>, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  flash_fwd_bf16_kernel<D><<<grid, kWgThreadsAll, T::kSmem, stream>>>(
      q_map, k_map, v_map, kv_lens, static_cast<__nv_bfloat16*>(o), lse, H,
      Lq, Lk, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fp32 FMA instance (parity type)
// ---------------------------------------------------------------------------

constexpr int kF32BQ = 16;  // query rows per block
constexpr int kF32BK = 32;  // keys per tile (one per lane in the S pass)

template <int D>
constexpr size_t f32_smem_floats() {
  return kF32BQ * D                 // Q
         + kF32BK * (D + 1)         // K, padded: lanes read different rows
         + kF32BK * D               // V
         + kF32BQ * (kF32BK + 1)    // S / P
         + 3 * kF32BQ;              // running max, running sum, rescale
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int* __restrict__ kv_lens,
                         float* __restrict__ o, float* __restrict__ lse,
                         int H, int Lq, int Lk, float scale) {
  constexpr int kKS = D + 1;
  constexpr int kSS = kF32BK + 1;
  constexpr int kPer = kF32BQ * D / kThreads;  // accumulators per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + kF32BQ * D;
  float* sV = sK + kF32BK * kKS;
  float* sS = sV + kF32BK * D;
  float* sM = sS + kF32BQ * kSS;
  float* sL = sM + kF32BQ;
  float* sA = sL + kF32BQ;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kF32BQ;
  const int tid = threadIdx.x;

  const size_t bh = static_cast<size_t>(b) * H + h;
  const float* qg = q + bh * Lq * D;
  const float* kg = k + bh * Lk * D;
  const float* vg = v + bh * Lk * D;
  float* og = o + bh * Lq * D;

  int kv_len = kv_lens != nullptr ? kv_lens[b] : Lk;
  kv_len = max(0, min(kv_len, Lk));
  const int n_tiles = (kv_len + kF32BK - 1) / kF32BK;

  for (int i = tid; i < kF32BQ * D; i += kThreads) {
    const int r = i / D;
    sQ[i] = q0 + r < Lq ? qg[static_cast<size_t>(q0) * D + i] : 0.f;
  }
  if (tid < kF32BQ) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kF32BK;
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < kF32BK * D; i += kThreads) {
      const int r = i / D;
      const int d = i % D;
      const bool valid = k0 + r < Lk;
      const size_t off = static_cast<size_t>(k0 + r) * D + d;
      sK[r * kKS + d] = valid ? kg[off] : 0.f;
      sV[i] = valid ? vg[off] : 0.f;
    }
    __syncthreads();

    for (int e = tid; e < kF32BQ * kF32BK; e += kThreads) {
      const int r = e / kF32BK;
      const int j = e % kF32BK;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(sQ[r * D + d], sK[j * kKS + d], dot);
      sS[r * kSS + j] = k0 + j < kv_len ? dot * scale : -INFINITY;
    }
    __syncthreads();

    if (tid < kF32BQ) {
      const int r = tid;
      float mx = -INFINITY;
      for (int j = 0; j < kF32BK; ++j) mx = fmaxf(mx, sS[r * kSS + j]);
      const float m_new = fmaxf(sM[r], mx);  // finite: key k0 is real
      const float alpha = expf(sM[r] - m_new);
      float sum = 0.f;
      for (int j = 0; j < kF32BK; ++j) {
        const float p = expf(sS[r * kSS + j] - m_new);
        sS[r * kSS + j] = p;
        sum += p;
      }
      sL[r] = sL[r] * alpha + sum;
      sM[r] = m_new;
      sA[r] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / D;
      const int d = e % D;
      float a = acc[i] * sA[r];
      for (int j = 0; j < kF32BK; ++j) a = fmaf(sS[r * kSS + j], sV[j * D + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();  // sL written by the softmax threads
  if (lse != nullptr && tid < kF32BQ && q0 + tid < Lq) {
    const float l = sL[tid];
    lse[bh * Lq + q0 + tid] = l > 0.f ? sM[tid] + logf(l) : kLseEmpty;
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / D;
    const int d = e % D;
    if (q0 + r < Lq) {
      const float l = sL[r];
      og[static_cast<size_t>(q0 + r) * D + d] = l > 0.f ? acc[i] / l : 0.f;
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v,
                       const int* kv_lens, void* o, float* lse, int B, int H,
                       int Lq, int Lk, float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_floats<D>() * sizeof(float);
  cudaError_t err = allow_smem(flash_fwd_f32_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + kF32BQ - 1) / kF32BQ, H, B);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), kv_lens, static_cast<float*>(o), lse, H,
      Lq, Lk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const int* kv_lens,
                                   void* o, float* lse, int B, int H, int Lq,
                                   int Lk, int D, float scale, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64)
    return launch_bf16<64>(q, k, v, kv_lens, o, lse, B, H, Lq, Lk, scale, st);
  if (dtype == 1 && D == 256)
    return launch_bf16<256>(q, k, v, kv_lens, o, lse, B, H, Lq, Lk, scale,
                            st);
  if (dtype == 0 && D == 64)
    return launch_f32<64>(q, k, v, kv_lens, o, lse, B, H, Lq, Lk, scale, st);
  if (dtype == 0 && D == 256)
    return launch_f32<256>(q, k, v, kv_lens, o, lse, B, H, Lq, Lk, scale,
                           st);
  return static_cast<int>(cudaErrorInvalidValue);
}
