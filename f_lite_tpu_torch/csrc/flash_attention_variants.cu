// Forward flash-attention variants for Hopper (sm_90a): the perf lab's
// kernel, bound to Python with ctypes.
//
// Replaces the TPU kernel `_kernel` of tools/flash_variants.py:43 (launcher
// `flash_fwd` :135, pallas_call :162): the online-softmax forward over every
// key (no kv_lens), for q (B,H,Lq,D) and k, v (B,H,Lk,D), bf16, contiguous,
// with four compile-time choices and a compile-time key tile, so that the
// lab can time each against the others:
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
// never by a product; the running max starts at -0.7 * FLT_MAX and a
// masked logit is -0.7 * FLT_MAX (times the scale when the kernel scales:
// the mask runs before the scale, which changes no real logit, no max and
// no p); a row sum l == 0 gives 1/l = 1; the output is the fp32
// accumulator times 1/l, rounded to bf16. The subtractions and the scale
// are __fsub_rn / __fmul_rn, so no FMA contraction makes a masked tile's
// numbers differ from an unmasked one's (condmask stays bit-equal to its
// twin).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense): 4*B*H*Lq*Lk*D flops,
// operation-bound at the lab's shape (0.350 ms at B=2 H=10 L=4112 D=256).
//
// Design: the serving forward's warp-specialised mainloop
// (flash_fwd_mainloop.cuh: TMA loads by a producer warpgroup through a
// two-stage mbarrier ring, two consumer warpgroups on wgmma, P in
// registers) with the lab's softmax policy (`LabPolicy`), so the lab times
// the loop that serves and a finding carries over to the serving kernel.
// The loop fixes 128 query rows a block; the key tile BK is the lab's
// choice: 48, 64 and 80 at D = 256 (80 is the serving tile and the widest
// whose two stages fit 227 KB), 32, 64 and 128 at D = 64 (32 is the
// serving tile). Not copied from the TPU: the 128-lane padding of D (the
// wrapper pads D to 64 or 256 instead), the padding of Lq and Lk to block
// multiples (TMA zero-fills past the ends), and the TPU's blocks (512,
// 256).
//
// Entry point: flash_attention_variants(...) returns cudaGetLastError()
// after the launch (0 on success), one of the kErr* codes of
// flash_fwd_mainloop.cuh, or cudaErrorInvalidValue for a head dim, block
// pair or flag set that is not compiled. flags: 1 PRESCALE, 2 EXP2, 4
// CONDMASK, 8 ALPHA_BF16; the combinations compiled are the lab's seven
// rows, the pairs those of ops/cuda/flash_variants.py BLOCKS (42
// instances; one nvcc process builds them in about half a minute).

#include <math.h>
#include <stdint.h>

#include "flash_attention_common.cuh"
#include "flash_fwd_mainloop.cuh"

namespace {

using namespace flash;
using namespace flash_fwd;

// the TPU kernel's running-max start value and masked logit
constexpr float kNegInf = -0.7f * 3.402823466e38f;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool EXP2>
__device__ __forceinline__ float exp_fn(float x) {
  return EXP2 ? exp2f(x) : expf(x);
}

template <bool PRESCALE, bool EXP2, bool CONDMASK, bool ALPHA_BF16>
struct LabPolicy {
  float scale_;  // the softmax scale, read unless PRESCALE

  static constexpr float kMaxStart = kNegInf;
  static constexpr float kMasked = kNegInf;
  static constexpr bool kSelectMaskedP = true;

  __device__ __forceinline__ bool mask_tile(bool last, bool ragged) const {
    return ragged && (!CONDMASK || last);
  }
  __device__ __forceinline__ float scale(float s) const {
    return PRESCALE ? s : __fmul_rn(s, scale_);
  }
  __device__ __forceinline__ float alpha(float m_prev, float m_new) const {
    const float x = __fsub_rn(m_prev, m_new);
    return ALPHA_BF16 ? round_bf16(exp_fn<EXP2>(round_bf16(x)))
                      : exp_fn<EXP2>(x);
  }
  __device__ __forceinline__ float p(float s, float m) const {
    return round_bf16(exp_fn<EXP2>(round_bf16(__fsub_rn(s, m))));
  }
  __device__ __forceinline__ float inv_l(float l) const {
    return l == 0.f ? 1.f : 1.f / l;
  }
  __device__ __forceinline__ void store_stats(int, int, int, int,
                                              const float (&)[2],
                                              const float (&)[2]) const {}
};

template <int D, int BK, bool PRESCALE, bool EXP2, bool CONDMASK,
          bool ALPHA_BF16>
__global__ void __launch_bounds__(kWgThreadsAll, Tiles<D, BK>::kMinBlocks)
    flash_variant_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         __nv_bfloat16* __restrict__ o, int H, int Lq, int Lk,
                         float scale) {
  mainloop<D, BK>(&q_map, &k_map, &v_map, o, H, Lq, Lk,
                  LabPolicy<PRESCALE, EXP2, CONDMASK, ALPHA_BF16>{scale});
}

template <int D, int BK, bool PRESCALE, bool EXP2, bool CONDMASK,
          bool ALPHA_BF16>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Lq, int Lk, float scale, cudaStream_t stream) {
  using T = Tiles<D, BK>;
  auto kernel =
      flash_variant_kernel<D, BK, PRESCALE, EXP2, CONDMASK, ALPHA_BF16>;
  static const int registers = check_registers<D, BK>(kernel);
  CUtensorMap q_map, k_map, v_map;
  int code =
      encode_maps<D, BK>(&q_map, &k_map, &v_map, q, k, v, B, H, Lq, Lk);
  if (code == 0) code = registers;
  if (code != 0) return code;
  cudaError_t err = allow_smem(kernel, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kWgThreadsAll, T::kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), H, Lq, Lk, scale);
  return static_cast<int>(cudaGetLastError());
}

// the lab's seven rows: base, prescale, exp2, condmask, condmask-e,
// alphabf16, all (flags as in the file header)
template <int D, int BK>
int launch_flags(int flags, const void* q, const void* k, const void* v,
                 void* o, int B, int H, int Lq, int Lk, float scale,
                 cudaStream_t st) {
  switch (flags) {
    case 0:
      return launch<D, BK, false, false, false, false>(q, k, v, o, B, H, Lq,
                                                       Lk, scale, st);
    case 1:
      return launch<D, BK, true, false, false, false>(q, k, v, o, B, H, Lq,
                                                      Lk, scale, st);
    case 1 | 2:
      return launch<D, BK, true, true, false, false>(q, k, v, o, B, H, Lq, Lk,
                                                     scale, st);
    case 1 | 2 | 4:
      return launch<D, BK, true, true, true, false>(q, k, v, o, B, H, Lq, Lk,
                                                    scale, st);
    case 4:
      return launch<D, BK, false, false, true, false>(q, k, v, o, B, H, Lq,
                                                      Lk, scale, st);
    case 1 | 8:
      return launch<D, BK, true, false, false, true>(q, k, v, o, B, H, Lq, Lk,
                                                     scale, st);
    case 1 | 2 | 4 | 8:
      return launch<D, BK, true, true, true, true>(q, k, v, o, B, H, Lq, Lk,
                                                   scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// head dim D at the key tiles BKs, 128 query rows a block
template <int D, int... BKs>
int launch_blocks(int block_q, int block_k, int flags, const void* q,
                  const void* k, const void* v, void* o, int B, int H, int Lq,
                  int Lk, float scale, cudaStream_t st) {
  int code = static_cast<int>(cudaErrorInvalidValue);
  if (block_q != kBQ) return code;
  ((code = block_k == BKs ? launch_flags<D, BKs>(flags, q, k, v, o, B, H, Lq,
                                                 Lk, scale, st)
                          : code),
   ...);
  return code;
}

}  // namespace

extern "C" int flash_attention_variants(const void* q, const void* k,
                                        const void* v, void* o, int B, int H,
                                        int Lq, int Lk, int D, float scale,
                                        int block_q, int block_k, int flags,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_blocks<64, 32, 64, 128>(block_q, block_k, flags, q, k, v, o,
                                          B, H, Lq, Lk, scale, st);
  if (D == 256)
    return launch_blocks<256, 48, 64, 80>(block_q, block_k, flags, q, k, v, o,
                                          B, H, Lq, Lk, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
