// The warp-specialised bf16 flash-attention forward mainloop for Hopper
// (sm_90a), shared by the serving forward (flash_attention_fwd.cu) and the
// perf lab's variant kernel (flash_attention_variants.cuh).
//
// A block of three warpgroups owns 128 query rows of one (batch, head):
// - warpgroup 0, the producer, lowers its registers (setmaxnreg) and one
//   thread issues TMA loads: the Q tile once, then K and V tiles of BK keys
//   through a ring of kStages stages, each with a full and an empty
//   mbarrier (K and V apart, so Q K^T starts before V has landed). Tiles
//   past kv_len are never loaded; the tensor maps are 3-D (D, L, B*H), so
//   rows past a head's end (Lq % 128, Lk < BK, ragged tails) arrive as
//   zeros and never as the next head's rows.
// - warpgroups 1 and 2, the consumers, raise their registers and own 64
//   query rows each: S = Q K^T by wgmma with both operands in shared memory
//   (128-byte swizzle, as TMA wrote it), the online softmax in the
//   accumulator layout (quad shuffles), then O += P V by wgmma with P
//   converted to bf16 in registers as the A operand and V read MN-major
//   from shared memory. Each consumer releases a stage by one arrival per
//   warp once its wgmma has been waited for.
// No ping-pong between the consumers, no softmax/GEMM overlap inside one,
// no persistent grid.
//
// A softmax policy (a struct of device functions and constants, inlined)
// decides what differs between the kernels built on this loop:
//   kMaxStart, kMasked   the running max's start and a masked logit;
//   mask_tile(last, ragged)  whether tile t masks keys >= kv_len (`last`:
//                        t is the last visited tile; `ragged`: kv_len %
//                        BK != 0);
//   scale(s)             the logit from the fp32 product (after the mask);
//   alpha(m_prev, m_new) the rescale factor of O and l;
//   p(s, m)              the probability fed to P V (before bf16);
//   kSelectMaskedP       p at masked keys set to 0 by a select;
//   inv_l(l)             the epilogue's factor of O;
//   store_stats(...)     per-row statistics the epilogue writes (lse).
//
// Host side: Tiles<D, BK> (shared memory, registers of the setmaxnreg
// split), check_registers (the split fits what ptxas allocated) and
// encode_maps (the three tensor maps).
#pragma once

#include <math.h>
#include <stdint.h>

#include "flash_attention_common.cuh"
#include "hopper.cuh"

namespace flash_fwd {

using namespace flash;
using namespace hopper;

constexpr int kErrTensorMap = 10001;   // cuTensorMapEncodeTiled failed
constexpr int kErrRegisters = 10002;   // setmaxnreg's split would not fit
constexpr int kErrAlignment = 10003;   // a bf16 q, k or v not 16-byte aligned

constexpr int kBQ = 128;                    // query rows per block
constexpr int kWgThreads = 128;             // one warpgroup
constexpr int kWgThreadsAll = 3 * kWgThreads;  // producer + 2 consumers
constexpr int kStages = 2;                  // K/V ring depth
constexpr int kProducerRegs = 24;
constexpr int kBoxBytes = 128;              // one row of a 64-column box

template <int D, int BK>
struct Tiles {
  static constexpr int kBK = BK;
  // two blocks an SM where a consumer's fragments fit half the registers
  static constexpr int kMinBlocks = D * BK <= 64 * 64 ? 2 : 1;
  // registers a thread at launch, and the consumers' share once the
  // producer has given up all but kProducerRegs
  static constexpr int kEntryRegs =
      65536 / (kWgThreadsAll * kMinBlocks) / 8 * 8;
  static constexpr int kConsumerRegs =
      (kEntryRegs * kWgThreadsAll - kProducerRegs * kWgThreads) /
      (2 * kWgThreads) / 8 * 8;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = BK * D * 2;
  // 1024 bytes of slack to align the tiles for the 128-byte swizzle, then
  // Q, the K ring, the V ring and the barriers
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 4 * kStages);
  static_assert(BK % 16 == 0 && BK <= 256, "BK: a multiple of 16");
  static_assert(kSmem <= 232448, "shared memory of one block");
};

// The block's work: 128 query rows of (batch blockIdx.z, head blockIdx.y)
// against keys [0, kv_len), O written for rows < Lq. Called by every thread
// of a __global__ kernel launched with kWgThreadsAll threads and
// Tiles<D, BK>::kSmem bytes of dynamic shared memory.
template <int D, int BK, class Policy>
__device__ __forceinline__ void mainloop(const CUtensorMap* q_map,
                                         const CUtensorMap* k_map,
                                         const CUtensorMap* v_map,
                                         __nv_bfloat16* __restrict__ o,
                                         int H, int Lq, int kv_len,
                                         const Policy& pol) {
  using T = Tiles<D, BK>;
  constexpr int kBoxes = D / 64;  // 64-column boxes of a row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + T::kQBytes;             // kStages tiles
  const uint32_t sV = sK + kStages * T::kKVBytes;  // kStages tiles
  const uint32_t q_full = sV + kStages * T::kKVBytes;
  // per stage s: k_full, k_empty, v_full, v_empty
  const uint32_t ring_bars = q_full + 8;

  const int bh = blockIdx.z * H + blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  // warp-uniform for the compiler too (a shuffle from lane 0), so that
  // what derives from it can live in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWgThreads, 0);
  const int n_tiles = (kv_len + BK - 1) / BK;

  if (threadIdx.x == 0) {
    // fetch the tensor maps while the barriers are set up
    prefetch_tensor_map(q_map);
    prefetch_tensor_map(k_map);
    prefetch_tensor_map(v_map);
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring_bars + 32 * s, 1);       // k_full: the producer
      mbar_init(ring_bars + 32 * s + 8, 8);   // k_empty: each consumer warp
      mbar_init(ring_bars + 32 * s + 16, 1);  // v_full
      mbar_init(ring_bars + 32 * s + 24, 8);  // v_empty
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the TMA loads in flight ----
    regs_lower<kProducerRegs>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(q_full, T::kQBytes);
#pragma unroll
      for (int c = 0; c < kBoxes; ++c)
        tma_load_3d(sQ + c * kBQ * kBoxBytes, q_map, q_full, c * 64, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        // a stage's first use waits for nothing (the phase before 0)
        const uint32_t parity = ((t / kStages) & 1) ^ 1;
        const uint32_t bars = ring_bars + 32 * s;
        mbar_wait(bars + 8, parity);
        mbar_expect_tx(bars, T::kKVBytes);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c)
          tma_load_3d(sK + s * T::kKVBytes + c * BK * kBoxBytes, k_map, bars,
                      c * 64, t * BK, bh);
        mbar_wait(bars + 24, parity);
        mbar_expect_tx(bars + 16, T::kKVBytes);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c)
          tma_load_3d(sV + s * T::kKVBytes + c * BK * kBoxBytes, v_map,
                      bars + 16, c * 64, t * BK, bh);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    regs_raise<T::kConsumerRegs>();
    const int cw = wg - 1;
    const int tw = threadIdx.x - wg * kWgThreads;
    const int warp = tw >> 5;
    const int lane = tw & 31;
    const int g = lane >> 2;   // accumulator row group
    const int tig = lane & 3;  // thread in group

    // O (64 x D) in the wgmma accumulator layout: acc[4j + 2i + e] is row
    // 16 * warp + g + 8i, column 8j + 2 tig + e
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // running max and sum for rows g and g + 8
    float m_run[2] = {Policy::kMaxStart, Policy::kMaxStart};
    float l_run[2] = {0.f, 0.f};

    // this warpgroup's 64 rows of each 128-row Q box
    const uint32_t q_desc = desc_lo(sQ + cw * 64 * kBoxBytes, 16);
    if (n_tiles > 0) mbar_wait(q_full, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t parity = (t / kStages) & 1;
      const uint32_t bars = ring_bars + 32 * s;
      const uint32_t k_desc = desc_lo(sK + s * T::kKVBytes, 16);
      const uint32_t v_desc = desc_lo(sV + s * T::kKVBytes, BK * kBoxBytes);

      // S = Q K^T: 64 x BK, D / 16 k-steps of 32 bytes inside each box
      float sc[BK / 2];
      mbar_wait(bars, parity);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t in_box = (kk % 4) * 32;
        wgmma_ss<BK>(sc, q_desc + (((kk / 4) * kBQ * kBoxBytes + in_box) >> 4),
                     k_desc + (((kk / 4) * BK * kBoxBytes + in_box) >> 4),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(bars + 8);  // K stage free

      // keys >= kv_len lie in the last visited tile only; the policy says
      // which tiles run the mask (column 8j + 2 tig + (e & 1) of sc[4j + e])
      const bool mask = pol.mask_tile(t == n_tiles - 1, kv_len % BK != 0);
      const int limit = kv_len - t * BK;
      if (mask) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (j * 8 + tig * 2 + (e & 1) >= limit)
              sc[4 * j + e] = Policy::kMasked;
          }
        }
      }

      // online softmax in fp32
      float mx[2] = {Policy::kMaxStart, Policy::kMaxStart};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        sc[i] = pol.scale(sc[i]);
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // key t * BK < kv_len is in every visited tile: the new max is a
        // real logit's
        const float m_new = fmaxf(m_run[r], mx[r]);
        alpha[r] = pol.alpha(m_run[r], m_new);
        m_run[r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float p = pol.p(sc[i], m_run[(i >> 1) & 1]);
        if (Policy::kSelectMaskedP && mask &&
            (i >> 2) * 8 + tig * 2 + (i & 1) >= limit)
          p = 0.f;
        sc[i] = p;
        rs[(i >> 1) & 1] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l_run[r] = l_run[r] * alpha[r] + rs[r];
      }
      if (t > 0) {  // O is still zero on the first tile
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }

      // P in bf16 as the A fragments of BK / 16 k-steps
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      // O += P V: V (BK x D) is MN-major for this product; a k-step is 16
      // rows of every box
      mbar_wait(bars + 16, parity);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D>(acc, pa[kk], v_desc + ((kk * 16 * kBoxBytes) >> 4), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(bars + 24);  // V stage free
    }

    // one multiplication per element by the row's factor
    const float inv0 = pol.inv_l(l_run[0]);
    const float inv1 = pol.inv_l(l_run[1]);
    const int row = q0 + cw * 64 + warp * 16 + g;
    pol.store_stats(bh, Lq, row, tig, m_run, l_run);
    __nv_bfloat16* og = o + static_cast<size_t>(bh) * Lq * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + tig * 2;
      if (row < Lq) {
        *reinterpret_cast<__nv_bfloat162*>(og + static_cast<size_t>(row) * D +
                                           col) =
            __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      }
      if (row + 8 < Lq) {
        *reinterpret_cast<__nv_bfloat162*>(
            og + static_cast<size_t>(row + 8) * D + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
      }
    }
  }
}

// 0 when setmaxnreg's split fits the registers `kernel` was built with (an
// instance of Tiles<D, BK>): the consumers' raise waits for registers the
// producer gives up, so a split that does not fit would never return.
template <int D, int BK, class Kernel>
int check_registers(Kernel kernel) {
  using T = Tiles<D, BK>;
  cudaFuncAttributes attr{};
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pool = attr.numRegs * kWgThreadsAll;
  const int needed =
      kProducerRegs * kWgThreads + T::kConsumerRegs * 2 * kWgThreads;
  return attr.numRegs <= T::kEntryRegs && needed <= pool ? 0 : kErrRegisters;
}

// The tensor maps of contiguous bf16 q (B, H, Lq, D) and k, v (B, H, Lk,
// D): 0, kErrAlignment where a base is not 16-byte aligned, or
// kErrTensorMap where an encode fails.
template <int D, int BK>
int encode_maps(CUtensorMap* q_map, CUtensorMap* k_map, CUtensorMap* v_map,
                const void* q, const void* k, const void* v, int B, int H,
                int Lq, int Lk) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return kErrAlignment;
  const uint64_t n = static_cast<uint64_t>(B) * H;
  if (!encode_bf16_rows(q_map, q, n, Lq, D, kBQ) ||
      !encode_bf16_rows(k_map, k, n, Lk, D, BK) ||
      !encode_bf16_rows(v_map, v, n, Lk, D, BK))
    return kErrTensorMap;
  return 0;
}

}  // namespace flash_fwd
