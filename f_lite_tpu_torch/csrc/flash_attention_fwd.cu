// Flash-attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel `_fa_fwd_kernel` (f_lite_tpu/ops/pallas/
// flash_attention.py). Computes, for q (B,H,Lq,D) and k, v (B,H,Lk,D), all
// contiguous:
//   O = softmax(scale * Q K^T, keys j >= kv_lens[b] masked) V
// with fp32 online-softmax statistics, an unnormalised fp32 accumulator
// divided by the row sum once at the end, and zero rows where kv_len == 0.
//
// Two instances:
// - bf16 (serving): tensor cores through mma.sync.m16n8k16 bf16 -> fp32.
//   A block of 4 warps owns 64 query rows (16 per warp) and walks the key
//   tiles of 64 rows up to kv_len; tiles past kv_len are never loaded.
//   Q, K and V tiles live in shared memory (rows padded by 16 bytes so that
//   ldmatrix is free of bank conflicts), loaded with cp.async; the V load
//   of a tile overlaps the Q K^T product and softmax of that tile. P stays
//   in registers and is fed straight back as the A operand of P V.
// - fp32 (parity): plain FMA on CUDA cores, 16 query rows per block.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the serving
// shapes are operation-bound for self-attention (4*B*H*Lq*Lk*D flops,
// 0.35 ms at B=2 H=10 L=4112 D=256) and byte-bound for cross-attention over
// short text (q and o dominate). This simple mma.sync design reaches a
// fraction of the wgmma peak; warp specialisation, TMA and wgmma are later
// work.
//
// Entry point: flash_attention_fwd(...) returns cudaGetLastError() after
// the launch (0 on success). dtype: 0 = fp32, 1 = bf16. kv_lens may be
// null (every key is real).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps

// ---------------------------------------------------------------------------
// bf16 tensor-core instance
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;  // query rows per block (16 per warp)
constexpr int kBK = 64;  // keys per tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes == 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + ROWS) of a (rows, D) bf16 matrix into shared
// memory with row stride D + 8; rows at or past `limit` are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int limit, int tid) {
  constexpr int kChunks = D / 8;
  constexpr int kStride = D + 8;
#pragma unroll
  for (int i = tid; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool valid = row0 + r < limit;
    const __nv_bfloat16* g =
        src + static_cast<size_t>(valid ? row0 + r : 0) * D + c * 8;
    cp_async16(smem_u32(dst + r * kStride + c * 8), g, valid ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const int* __restrict__ kv_lens,
                          __nv_bfloat16* __restrict__ o, int H, int Lq,
                          int Lk, float scale_log2) {
  constexpr int kStride = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBQ * kStride;
  __nv_bfloat16* sV = sK + kBK * kStride;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row group
  const int tig = lane & 3;  // thread in group
  const int mi = lane >> 3;  // ldmatrix: which 8x8 matrix this lane addresses
  const int mr = lane & 7;   // ldmatrix: row within that matrix

  const size_t bh = static_cast<size_t>(b) * H + h;
  const __nv_bfloat16* qg = q + bh * Lq * D;
  const __nv_bfloat16* kg = k + bh * Lk * D;
  const __nv_bfloat16* vg = v + bh * Lk * D;
  __nv_bfloat16* og = o + bh * Lq * D;

  int kv_len = kv_lens != nullptr ? kv_lens[b] : Lk;
  kv_len = max(0, min(kv_len, Lk));
  const int n_tiles = (kv_len + kBK - 1) / kBK;

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  // running max (log2 domain, scaled) and sum for rows g and g + 8
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  load_tile<D, kBQ>(sQ, qg, q0, Lq, tid);
  cp_async_commit();

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    load_tile<D, kBK>(sK, kg, k0, Lk, tid);
    cp_async_commit();
    load_tile<D, kBK>(sV, vg, k0, Lk, tid);
    cp_async_commit();
    cp_async_wait<1>();  // Q and K have landed; V may still be in flight
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a0, a1, a2, a3;
      ldsm_x4(smem_u32(sQ + (warp * 16 + (lane & 15)) * kStride + kk * 16 +
                       (lane >> 4) * 8),
              a0, a1, a2, a3);
#pragma unroll
      for (int nj = 0; nj < kBK / 16; ++nj) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(sK + (nj * 16 + mr + (mi >> 1) * 8) * kStride +
                         kk * 16 + (mi & 1) * 8),
                b0, b1, b2, b3);
        mma_bf16(s[2 * nj], a0, a1, a2, a3, b0, b1);
        mma_bf16(s[2 * nj + 1], a0, a1, a2, a3, b2, b3);
      }
    }

    // online softmax in fp32 (exp2 of log2-scaled logits)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + tig * 2 + (e & 1);
        const float x = col < kv_len ? s[j][e] * scale_log2 : -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // key k0 < kv_len is in every visited tile, so the new max is finite
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m_run[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_run[r] = l_run[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    cp_async_wait<0>();  // V has landed
    __syncthreads();

    // acc += P V, with P taken from the S fragments as the A operand
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nj = 0; nj < D / 16; ++nj) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(smem_u32(sV + (kk * 16 + mr + (mi & 1) * 8) * kStride +
                               nj * 16 + (mi >> 1) * 8),
                      b0, b1, b2, b3);
        mma_bf16(acc[2 * nj], a0, a1, a2, a3, b0, b1);
        mma_bf16(acc[2 * nj + 1], a0, a1, a2, a3, b2, b3);
      }
    }
    __syncthreads();  // every warp is done with sK and sV
  }
  cp_async_wait<0>();  // when kv_len == 0 no tile waited for the Q copy

  // one division per row; a row that saw no key (kv_len == 0) is zero
  const float inv0 = l_run[0] > 0.f ? 1.f / l_run[0] : 0.f;
  const float inv1 = l_run[1] > 0.f ? 1.f / l_run[1] : 0.f;
  const int row = q0 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + tig * 2;
    if (row < Lq) {
      *reinterpret_cast<__nv_bfloat162*>(og + static_cast<size_t>(row) * D +
                                         col) =
          __floats2bfloat162_rn(acc[j][0] * inv0, acc[j][1] * inv0);
    }
    if (row + 8 < Lq) {
      *reinterpret_cast<__nv_bfloat162*>(
          og + static_cast<size_t>(row + 8) * D + col) =
          __floats2bfloat162_rn(acc[j][2] * inv1, acc[j][3] * inv1);
    }
  }
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
                         float* __restrict__ o, int H, int Lq, int Lk,
                         float scale) {
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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const int* kv_lens, void* o, int B, int H, int Lq,
                        int Lk, float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kBQ + 2 * kBK) * (D + 8) *
                      sizeof(__nv_bfloat16);
  cudaError_t err = allow_smem(flash_fwd_bf16_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  flash_fwd_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), kv_lens,
      static_cast<__nv_bfloat16*>(o), H, Lq, Lk,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const int* kv_lens, void* o, int B, int H, int Lq,
                       int Lk, float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_floats<D>() * sizeof(float);
  cudaError_t err = allow_smem(flash_fwd_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kF32BQ - 1) / kF32BQ, H, B);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), kv_lens, static_cast<float*>(o), H, Lq,
      Lk, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const int* kv_lens,
                                   void* o, int B, int H, int Lq, int Lk,
                                   int D, float scale, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64)
    return launch_bf16<64>(q, k, v, kv_lens, o, B, H, Lq, Lk, scale, st);
  if (dtype == 1 && D == 256)
    return launch_bf16<256>(q, k, v, kv_lens, o, B, H, Lq, Lk, scale, st);
  if (dtype == 0 && D == 64)
    return launch_f32<64>(q, k, v, kv_lens, o, B, H, Lq, Lk, scale, st);
  if (dtype == 0 && D == 256)
    return launch_f32<256>(q, k, v, kv_lens, o, B, H, Lq, Lk, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
