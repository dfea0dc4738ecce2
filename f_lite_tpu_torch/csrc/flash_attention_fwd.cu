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
//   full rate, which only wgmma reaches. A block of three warpgroups owns
//   128 query rows of one (batch, head):
//   * warpgroup 0, the producer, lowers its registers (setmaxnreg) and one
//     thread issues TMA loads: the Q tile once, then K and V tiles of BK
//     keys through a ring of kStages stages, each with a full and an empty
//     mbarrier (K and V apart, so Q K^T starts before V has landed). Tiles
//     past kv_len are never loaded; the tensor maps are 3-D (D, L, B*H), so
//     rows past a head's end (Lq % 128, Lk < BK, ragged tails) arrive as
//     zeros and never as the next head's rows.
//   * warpgroups 1 and 2, the consumers, raise their registers and own 64
//     query rows each: S = Q K^T by wgmma with both operands in shared
//     memory (128-byte swizzle, as TMA wrote it), the online softmax in the
//     accumulator layout (quad shuffles), keys >= kv_len masked on the last
//     visited tile only (every earlier tile is full), then O += P V by
//     wgmma with P converted to bf16 in registers as the A operand and V
//     read MN-major from shared memory. Each consumer releases a stage by
//     one arrival per warp once its wgmma has been waited for.
//   The epilogue divides by l, stores bf16 O for rows < Lq and lse.
//   No ping-pong between the consumers, no softmax/GEMM overlap inside one,
//   no persistent grid: later work.
// - fp32 (parity): plain FMA on CUDA cores, 16 query rows per block.
//
// Entry point: flash_attention_fwd(...) returns cudaGetLastError() after
// the launch (0 on success), or one of the kErr* codes below without
// launching. dtype: 0 = fp32, 1 = bf16. kv_lens may be null (every key is
// real); lse may be null (no lse output). bf16 q, k, v must be 16-byte
// aligned (TMA).

#include <math.h>
#include <stdint.h>

#include "flash_attention_common.cuh"
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
using namespace hopper;

constexpr int kErrTensorMap = 10001;   // cuTensorMapEncodeTiled failed
constexpr int kErrRegisters = 10002;   // setmaxnreg's split would not fit
constexpr int kErrAlignment = 10003;   // a bf16 q, k or v not 16-byte aligned

constexpr int kThreads = 128;  // fp32 instance: 4 warps

// ---------------------------------------------------------------------------
// bf16 instance: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kBQ = 128;                    // query rows per block
constexpr int kWgThreads = 128;             // one warpgroup
constexpr int kWgThreadsAll = 3 * kWgThreads;  // producer + 2 consumers
constexpr int kStages = 2;                  // K/V ring depth
constexpr int kProducerRegs = 24;
constexpr int kBoxBytes = 128;              // one row of a 64-column box

template <int D>
struct FwdTiles {
  static constexpr int kBK = D == 256 ? FLASH_FWD_BK_D256 : FLASH_FWD_BK_D64;
  // two blocks an SM where a consumer's fragments fit half the registers
  static constexpr int kMinBlocks = D * kBK <= 64 * 64 ? 2 : 1;
  // registers a thread at launch, and the consumers' share once the
  // producer has given up all but kProducerRegs
  static constexpr int kEntryRegs =
      65536 / (kWgThreadsAll * kMinBlocks) / 8 * 8;
  static constexpr int kConsumerRegs =
      (kEntryRegs * kWgThreadsAll - kProducerRegs * kWgThreads) /
      (2 * kWgThreads) / 8 * 8;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;
  // 1024 bytes of slack to align the tiles for the 128-byte swizzle, then
  // Q, the K ring, the V ring and the barriers
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 4 * kStages);
  static_assert(kBK % 16 == 0 && kBK <= 256, "BK: a multiple of 16");
  static_assert(kSmem <= 232448, "shared memory of one block");
};

template <int D>
__global__ void __launch_bounds__(kWgThreadsAll, FwdTiles<D>::kMinBlocks)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const int* __restrict__ kv_lens,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int H, int Lq, int Lk,
                          float scale_log2) {
  using T = FwdTiles<D>;
  constexpr int BK = T::kBK;
  constexpr int kBoxes = D / 64;  // 64-column boxes of a row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + T::kQBytes;             // kStages tiles
  const uint32_t sV = sK + kStages * T::kKVBytes;  // kStages tiles
  const uint32_t q_full = sV + kStages * T::kKVBytes;
  // per stage s: k_full, k_empty, v_full, v_empty
  const uint32_t ring_bars = q_full + 8;

  const int b = blockIdx.z;
  const int bh = b * H + blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  // warp-uniform for the compiler too (a shuffle from lane 0), so that
  // what derives from it can live in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWgThreads, 0);

  int kv_len = kv_lens != nullptr ? kv_lens[b] : Lk;
  kv_len = max(0, min(kv_len, Lk));
  const int n_tiles = (kv_len + BK - 1) / BK;

  if (threadIdx.x == 0) {
    // fetch the tensor maps while the barriers are set up
    prefetch_tensor_map(&q_map);
    prefetch_tensor_map(&k_map);
    prefetch_tensor_map(&v_map);
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
        tma_load_3d(sQ + c * kBQ * kBoxBytes, &q_map, q_full, c * 64, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        // a stage's first use waits for nothing (the phase before 0)
        const uint32_t parity = ((t / kStages) & 1) ^ 1;
        const uint32_t bars = ring_bars + 32 * s;
        mbar_wait(bars + 8, parity);
        mbar_expect_tx(bars, T::kKVBytes);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c)
          tma_load_3d(sK + s * T::kKVBytes + c * BK * kBoxBytes, &k_map, bars,
                      c * 64, t * BK, bh);
        mbar_wait(bars + 24, parity);
        mbar_expect_tx(bars + 16, T::kKVBytes);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c)
          tma_load_3d(sV + s * T::kKVBytes + c * BK * kBoxBytes, &v_map,
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
    // running max (log2 domain, scaled) and sum for rows g and g + 8
    float m_run[2] = {-INFINITY, -INFINITY};
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

      // the last visited tile holds key kv_len - 1; mask the keys past it
      if (t == n_tiles - 1) {
        const int limit = kv_len - t * BK;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (j * 8 + tig * 2 + (e & 1) >= limit) sc[4 * j + e] = -INFINITY;
          }
        }
      }

      // online softmax in fp32 (exp2 of log2-scaled logits)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        sc[i] *= scale_log2;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // key t * BK < kv_len is in every visited tile: the new max is finite
        const float m_new = fmaxf(m_run[r], mx[r]);
        alpha[r] = exp2f(m_run[r] - m_new);
        m_run[r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const float p = exp2f(sc[i] - m_run[(i >> 1) & 1]);
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

    // one division per row; a row that saw no key (kv_len == 0) is zero
    const float inv0 = l_run[0] > 0.f ? 1.f / l_run[0] : 0.f;
    const float inv1 = l_run[1] > 0.f ? 1.f / l_run[1] : 0.f;
    const int row = q0 + cw * 64 + warp * 16 + g;
    if (lse != nullptr && tig == 0) {
      // m_run is in the log2 domain of the scaled logits
      float* lg = lse + static_cast<size_t>(bh) * Lq;
      if (row < Lq)
        lg[row] = l_run[0] > 0.f ? m_run[0] * kLn2 + logf(l_run[0]) : kLseEmpty;
      if (row + 8 < Lq)
        lg[row + 8] =
            l_run[1] > 0.f ? m_run[1] * kLn2 + logf(l_run[1]) : kLseEmpty;
    }
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

// 0 when setmaxnreg's split fits the registers the kernel was built with:
// the consumers' raise waits for registers the producer gives up, so a
// split that does not fit would never return.
template <int D>
int check_registers() {
  using T = FwdTiles<D>;
  cudaFuncAttributes attr{};
  const cudaError_t err = cudaFuncGetAttributes(&attr, flash_fwd_bf16_kernel<D>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pool = attr.numRegs * kWgThreadsAll;
  const int needed =
      kProducerRegs * kWgThreads + T::kConsumerRegs * 2 * kWgThreads;
  return attr.numRegs <= T::kEntryRegs && needed <= pool ? 0 : kErrRegisters;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v,
                const int* kv_lens, void* o, float* lse, int B, int H, int Lq,
                int Lk, float scale, cudaStream_t stream) {
  using T = FwdTiles<D>;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return kErrAlignment;
  static const int registers = check_registers<D>();
  if (registers != 0) return registers;
  CUtensorMap q_map, k_map, v_map;
  const uint64_t n = static_cast<uint64_t>(B) * H;
  if (!encode_bf16_rows(&q_map, q, n, Lq, D, kBQ) ||
      !encode_bf16_rows(&k_map, k, n, Lk, D, T::kBK) ||
      !encode_bf16_rows(&v_map, v, n, Lk, D, T::kBK))
    return kErrTensorMap;
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
