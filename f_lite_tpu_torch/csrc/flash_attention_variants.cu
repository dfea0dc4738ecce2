// Forward flash-attention variants for Hopper (sm_90a): the perf lab's
// kernel, bound to Python with ctypes.
//
// Replaces the TPU kernel `_kernel` of tools/flash_variants.py (launcher
// `flash_fwd`): the online-softmax forward over every key (no kv_lens), for
// q (B,H,Lq,D) and k, v (B,H,Lk,D), bf16, contiguous, with four
// compile-time choices and compile-time block sizes, so that the lab can
// time each against the others:
//   PRESCALE   q arrives scaled by `scale` (the wrapper rounds q * scale to
//              bf16 outside the kernel); otherwise S is scaled in fp32 here;
//   EXP2       q arrives scaled by scale * log2(e) and every exp is exp2
//              (EXP2 implies PRESCALE);
//   CONDMASK   the key mask runs only on the tile that straddles Lk, a
//              branch uniform across the block; otherwise it runs on every
//              tile whenever Lk % BK != 0. The result is the same;
//   ALPHA_BF16 the rescale factor alpha = exp(m_prev - m_next) takes its
//              argument rounded to bf16 and is rounded to bf16 itself.
// The source's rounding points are kept: the exp argument s - m_next is
// rounded to bf16 and p is rounded to bf16 (exp in fp32 of the rounded
// argument, as the TPU computes it); p is zero at masked keys by a select,
// never by a product; the running max starts at -0.7 * FLT_MAX, so masked
// logits are finite; a row sum l == 0 gives 1/l = 1; the output is the
// fp32 accumulator times 1/l, rounded to bf16.
//
// Design: mma.sync.m16n8k16 bf16 -> fp32 on the tensor cores, as in
// flash_attention_fwd.cu. A block of BQ / 16 warps owns BQ query rows (16
// per warp) and walks the key tiles of BK rows; Q, K and V tiles sit in
// shared memory (rows padded by 16 bytes for conflict-free ldmatrix),
// loaded with cp.async, the V load of a tile overlapping Q K^T and the
// softmax of that tile; P stays in registers as the A operand of P V.
// Blocks (BQ, BK) in {(64, 64), (64, 128), (128, 64)}: a warp's fp32
// accumulator at D = 256 is 16 x 256 / 32 = 128 registers a thread, so BQ
// = 128 takes 8 warps, and BK = 128 adds 64 registers of S a thread.
// Not copied from the TPU: the 128-lane padding of D, the padding of Lq and
// Lk to block multiples, and the TPU's blocks (512, 256).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense): 4*B*H*Lq*Lk*D flops,
// operation-bound at the lab's shape (0.350 ms at B=2 H=10 L=4112 D=256).
//
// Entry point: flash_attention_variants(...) returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for a head
// dim, block pair or flag set that is not compiled. flags: 1 PRESCALE,
// 2 EXP2, 4 CONDMASK, 8 ALPHA_BF16; the combinations compiled are the
// lab's seven rows (ops/cuda/flash_variants.py VARIANTS).

#include <math.h>
#include <stdint.h>

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

// the TPU kernel's running-max start value and masked logit
constexpr float kNegInf = -0.7f * 3.402823466e38f;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool EXP2>
__device__ __forceinline__ float exp_fn(float x) {
  return EXP2 ? exp2f(x) : expf(x);
}

template <int D, int BQ, int BK, bool PRESCALE, bool EXP2, bool CONDMASK,
          bool ALPHA_BF16>
__global__ void __launch_bounds__(BQ * 2)
    flash_variant_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o, int H, int Lq, int Lk,
                         float scale) {
  constexpr int kThreads = BQ * 2;  // BQ / 16 warps
  constexpr int kStride = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * kStride;
  __nv_bfloat16* sV = sK + BK * kStride;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
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

  const int n_tiles = (Lk + BK - 1) / BK;
  const bool masked = Lk % BK != 0;  // the last tile is ragged

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  // running max and sum for rows g and g + 8 of the warp's 16
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};

  load_tile<D, BQ, kThreads>(sQ, qg, q0, Lq, tid);
  cp_async_commit();

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    load_tile<D, BK, kThreads>(sK, kg, k0, Lk, tid);
    cp_async_commit();
    load_tile<D, BK, kThreads>(sV, vg, k0, Lk, tid);
    cp_async_commit();
    cp_async_wait<1>();  // Q and K have landed; V may still be in flight
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's BK keys
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a0, a1, a2, a3;
      ldsm_x4(smem_u32(sQ + (warp * 16 + (lane & 15)) * kStride + kk * 16 +
                       (lane >> 4) * 8),
              a0, a1, a2, a3);
#pragma unroll
      for (int nj = 0; nj < BK / 16; ++nj) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(sK + (nj * 16 + mr + (mi >> 1) * 8) * kStride +
                         kk * 16 + (mi & 1) * 8),
                b0, b1, b2, b3);
        mma_bf16(s[2 * nj], a0, a1, a2, a3, b0, b1);
        mma_bf16(s[2 * nj + 1], a0, a1, a2, a3, b2, b3);
      }
    }
    if (!PRESCALE) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale;
      }
    }

    // the key mask: on every tile when the last one is ragged, or under
    // CONDMASK only on the tile that straddles Lk (uniform per block)
    const bool apply_mask = masked && (!CONDMASK || k0 + BK > Lk);
    if (apply_mask) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + tig * 2 + (e & 1);
          s[j][e] = col < Lk ? s[j][e] : kNegInf;
        }
      }
    }

    float m_next[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        m_next[e >> 1] = fmaxf(m_next[e >> 1], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_next[r] = fmaxf(m_next[r], __shfl_xor_sync(0xffffffffu, m_next[r], 1));
      m_next[r] = fmaxf(m_next[r], __shfl_xor_sync(0xffffffffu, m_next[r], 2));
      if (ALPHA_BF16) {
        alpha[r] = round_bf16(exp_fn<EXP2>(round_bf16(m_run[r] - m_next[r])));
      } else {
        alpha[r] = exp_fn<EXP2>(m_run[r] - m_next[r]);
      }
      m_run[r] = m_next[r];
    }

    // p = bf16(exp(bf16(s - m_next))), zero at masked keys by a select
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = round_bf16(exp_fn<EXP2>(round_bf16(s[j][e] - m_run[e >> 1])));
        if (apply_mask) {
          const int col = k0 + j * 8 + tig * 2 + (e & 1);
          p = col < Lk ? p : 0.f;
        }
        s[j][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_run[r] = rs[r] + alpha[r] * l_run[r];
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

    // acc += P V, with P (exact in bf16) taken from the S fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
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

  const float inv0 = l_run[0] == 0.f ? 1.f : 1.f / l_run[0];
  const float inv1 = l_run[1] == 0.f ? 1.f : 1.f / l_run[1];
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

template <int D, int BQ, int BK, bool PRESCALE, bool EXP2, bool CONDMASK,
          bool ALPHA_BF16>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Lq, int Lk, float scale,
                   cudaStream_t stream) {
  auto kernel =
      flash_variant_kernel<D, BQ, BK, PRESCALE, EXP2, CONDMASK, ALPHA_BF16>;
  const size_t smem =
      static_cast<size_t>(BQ + 2 * BK) * (D + 8) * sizeof(__nv_bfloat16);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + BQ - 1) / BQ, H, B);
  kernel<<<grid, BQ * 2, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H,
      Lq, Lk, scale);
  return cudaGetLastError();
}

// the lab's seven rows: base, prescale, exp2, condmask, condmask-e,
// alphabf16, all (flags as in the file header)
template <int D, int BQ, int BK>
cudaError_t launch_flags(int flags, const void* q, const void* k,
                         const void* v, void* o, int B, int H, int Lq, int Lk,
                         float scale, cudaStream_t st) {
  switch (flags) {
    case 0:
      return launch<D, BQ, BK, false, false, false, false>(q, k, v, o, B, H,
                                                           Lq, Lk, scale, st);
    case 1:
      return launch<D, BQ, BK, true, false, false, false>(q, k, v, o, B, H, Lq,
                                                          Lk, scale, st);
    case 1 | 2:
      return launch<D, BQ, BK, true, true, false, false>(q, k, v, o, B, H, Lq,
                                                         Lk, scale, st);
    case 1 | 2 | 4:
      return launch<D, BQ, BK, true, true, true, false>(q, k, v, o, B, H, Lq,
                                                        Lk, scale, st);
    case 4:
      return launch<D, BQ, BK, false, false, true, false>(q, k, v, o, B, H, Lq,
                                                          Lk, scale, st);
    case 1 | 8:
      return launch<D, BQ, BK, true, false, false, true>(q, k, v, o, B, H, Lq,
                                                         Lk, scale, st);
    case 1 | 2 | 4 | 8:
      return launch<D, BQ, BK, true, true, true, true>(q, k, v, o, B, H, Lq,
                                                       Lk, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int D>
cudaError_t launch_blocks(int block_q, int block_k, int flags, const void* q,
                          const void* k, const void* v, void* o, int B, int H,
                          int Lq, int Lk, float scale, cudaStream_t st) {
  if (block_q == 64 && block_k == 64)
    return launch_flags<D, 64, 64>(flags, q, k, v, o, B, H, Lq, Lk, scale, st);
  if (block_q == 64 && block_k == 128)
    return launch_flags<D, 64, 128>(flags, q, k, v, o, B, H, Lq, Lk, scale, st);
  if (block_q == 128 && block_k == 64)
    return launch_flags<D, 128, 64>(flags, q, k, v, o, B, H, Lq, Lk, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_attention_variants(const void* q, const void* k,
                                        const void* v, void* o, int B, int H,
                                        int Lq, int Lk, int D, float scale,
                                        int block_q, int block_k, int flags,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_blocks<64>(block_q, block_k, flags, q, k, v, o, B, H, Lq, Lk,
                             scale, st);
  if (D == 256)
    return launch_blocks<256>(block_q, block_k, flags, q, k, v, o, B, H, Lq,
                              Lk, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
