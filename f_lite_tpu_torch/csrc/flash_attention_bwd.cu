// Flash-attention backward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernels `_dq_kernel` and `_dkv_kernel` (f_lite_tpu/ops/
// pallas/flash_attention.py:269 and :316, launched by `_flash_backward`).
// For q, dO (B,H,Lq,D), k, v (B,H,Lk,D), the forward's row log-sum-exp lse
// (B,H,Lq) and delta = rowsum(dO * O) (B,H,Lq), both fp32 and computed
// outside (FA2):
//   P  = exp(scale * Q K^T - lse), 0 at keys j >= kv_lens[b]
//   dP = dO V^T,  dS = P * (dP - delta)
//   dq = scale * dS K          (dq kernel: 3 products)
//   dv = P^T dO, dk = scale * dS^T Q
//                              (dkv kernel: 4 products)
// As in the TPU kernels, P is rounded to dO's dtype before P^T dO and dS to
// q's dtype before the dq and dk products; sums are fp32. Two kernels, as
// the TPU has them: no atomics, so the gradients repeat bit for bit.
//
// Masking never multiplies an overflowed exponent: P is selected to 0 at
// masked keys and at q rows past Lq before any product, so keys at or past
// kv_len get dk = dv = 0 exactly and a kv_len == 0 batch row (lse
// kLseEmpty) gets dq = 0, visiting no key tile and waiting on no barrier.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): dq needs
// 6*B*H*Lq*Lk*D flops over the real keys, dkv 8*...; at the training shapes
// self-attention is operation-bound and cross-attention over short text
// byte-bound.
//
// bf16 design: the forward's mainloop (flash_attention_fwd.cu, helpers in
// hopper.cuh). A block is three warpgroups: warpgroup 0, the producer,
// lowers its registers (setmaxnreg) and one thread keeps TMA loads in
// flight through a ring of stages guarded by full and empty mbarriers;
// warpgroups 1 and 2, the consumers, raise theirs and run every product on
// wgmma from tiles as TMA wrote them (128-byte swizzle). Tensor maps are
// 3-D (D, L, B*H), so rows past a head's end arrive as zeros.
// - dq kernel: one block per 128 q rows, 64 a consumer. The producer loads
//   Q and dO once and streams K and V tiles of BK keys, up to kv_len only.
//   A consumer computes S = Q K^T and dP = dO V^T (both operands K-major,
//   dP's product in flight while P is computed), P and dS in registers,
//   and dq += dS K with dS as the register A operand and K read MN-major.
//   Its 64 x D fp32 dq is 128 registers a thread at D = 256, as the
//   forward's O.
// - dkv kernel, computed transposed so that no P^T is formed by a copy:
//   K and V stay resident; the producer streams Q, dO, lse and delta tiles
//   of BQ rows (lse and delta by bulk copy: the wrapper pads their rows to
//   a multiple of kStatRows, so each tile's rows start 16-byte aligned at
//   every Lq). A consumer computes
//   S^T = K Q^T and dP^T = V dO^T (K-major operands), then dv += P^T dO and
//   dk += dS^T Q with dO and Q read MN-major.
//   * D = 256: dk and dv of 64 keys x 256 would be 256 registers a thread,
//     over the limit. So a block owns 64 keys and the consumers split the
//     work twice: each computes S^T and dP^T for half of the tile's q
//     columns and stores its half of P^T and dS^T (bf16, swizzled as TMA
//     would) to shared memory; a named barrier joins the two; each then
//     accumulates dk and dv for its half of D (2 x 64 registers), reading
//     P^T and dS^T from shared memory. The P^T / dS^T buffers alternate
//     between tiles, so one barrier a tile orders their reuse.
//   * D = 64: dk and dv fit, so a block owns 128 keys, 64 a consumer, and
//     P^T and dS^T stay in registers as the A operands.
// - fp32 (the parity type): plain FMA on CUDA cores, 128 threads, 16 rows
//   per block, tiles of 32 streamed rows, S / dP / dS in shared memory.
//
// Entry points return cudaGetLastError() after the launch (0 on success),
// or one of the kErr* codes below without launching. dtype: 0 = fp32, 1 =
// bf16. kv_lens may be null (every key is real). bf16 q, k, v, dO, lse and
// delta must be 16-byte aligned, and bf16 lse and delta hold
// stat_stride(Lq) rows a head (the rows past Lq are read, never used).

#include <math.h>
#include <stdint.h>

#include "flash_attention_common.cuh"
#include "hopper.cuh"

// Keys per K/V tile of the dq kernel (48 at D = 256: two stages beside Q
// and dO in 225 KB; 32 at D = 64, two blocks an SM), and q rows per Q/dO
// tile of the dkv kernel at D = 64 (at D = 256 it is 64). The tile trial
// (f_lite_tpu_torch/tools/backward_tiles.py) builds other values; the
// package's library always uses these.
#ifndef FLASH_DQ_BK_D256
#define FLASH_DQ_BK_D256 48
#endif
#ifndef FLASH_DQ_BK_D64
#define FLASH_DQ_BK_D64 32
#endif
#ifndef FLASH_DKV_BQ_D64
#define FLASH_DKV_BQ_D64 64
#endif

namespace {

using namespace flash;
using namespace hopper;

using bf16 = __nv_bfloat16;

constexpr int kErrTensorMap = 10001;   // cuTensorMapEncodeTiled failed
constexpr int kErrRegisters = 10002;   // setmaxnreg's split would not fit
constexpr int kErrAlignment = 10003;   // a bf16 input not 16-byte aligned

constexpr int kWgThreads = 128;                // one warpgroup
constexpr int kWgThreadsAll = 3 * kWgThreads;  // producer + 2 consumers
constexpr int kProducerRegs = 24;
constexpr int kBoxBytes = 128;      // one row of a 64-column box
constexpr int kSmemMax = 232448;    // shared memory of one block
constexpr int kStatRows = 128;      // the wrapper's STAT_ROWS

// Rows a head of the bf16 kernels' lse and delta.
__host__ __device__ constexpr int stat_stride(int lq) {
  return (lq + kStatRows - 1) / kStatRows * kStatRows;
}

// Registers a thread at launch with kMinBlocks blocks an SM, and the
// consumers' share once the producer has given up all but kProducerRegs.
template <int kMinBlocks>
struct RegSplit {
  static constexpr int kEntry = 65536 / (kWgThreadsAll * kMinBlocks) / 8 * 8;
  static constexpr int kConsumer =
      (kEntry * kWgThreadsAll - kProducerRegs * kWgThreads) /
      (2 * kWgThreads) / 8 * 8;
};

// P = exp2(s * scale_log2 - lse2), or 0 where the key or q row is masked.
__device__ __forceinline__ float prob(float s, float scale_log2, float lse2,
                                      bool ok) {
  return ok ? exp2f(s * scale_log2 - lse2) : 0.f;
}

// ---------------------------------------------------------------------------
// bf16 dq kernel
// ---------------------------------------------------------------------------

constexpr int dq_smem(int q_bytes, int kv_bytes, int stages) {
  return 1024 + 2 * q_bytes + 2 * stages * kv_bytes + 8 * (1 + 4 * stages);
}

template <int D>
struct DqTiles {
  static constexpr int kBQ = 128;  // q rows per block
  static constexpr int kBK = D == 256 ? FLASH_DQ_BK_D256 : FLASH_DQ_BK_D64;
  // two blocks an SM where a consumer's fragments fit half the registers
  static constexpr int kMinBlocks = D * kBK <= 64 * 32 ? 2 : 1;
  static constexpr int kQBytes = kBQ * D * 2;   // Q, and dO
  static constexpr int kKVBytes = kBK * D * 2;  // a K or a V tile
  // 1024 bytes of slack to align the tiles for the 128-byte swizzle, then
  // Q, dO, the K ring, the V ring and the barriers
  static constexpr int kStages =
      dq_smem(kQBytes, kKVBytes, 2) <= kSmemMax / kMinBlocks ? 2 : 1;
  static constexpr int kSmem = dq_smem(kQBytes, kKVBytes, kStages);
  static_assert(kBK % 16 == 0 && kBK <= 256, "BK: a multiple of 16");
  static_assert(kSmem <= kSmemMax / kMinBlocks, "shared memory");
};

template <int D>
__global__ void __launch_bounds__(kWgThreadsAll, DqTiles<D>::kMinBlocks)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const __grid_constant__ CUtensorMap do_map,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const int* __restrict__ kv_lens,
                             bf16* __restrict__ dq, int H, int Lq, int Lk,
                             float scale) {
  using T = DqTiles<D>;
  constexpr int BK = T::kBK;
  constexpr int kBQ = T::kBQ;
  constexpr int kStages = T::kStages;
  constexpr int kBoxes = D / 64;  // 64-column boxes of a row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sDO = sQ + T::kQBytes;
  const uint32_t sK = sDO + T::kQBytes;            // kStages tiles
  const uint32_t sV = sK + kStages * T::kKVBytes;  // kStages tiles
  const uint32_t qd_full = sV + kStages * T::kKVBytes;
  // per stage s: k_full, k_empty, v_full, v_empty
  const uint32_t ring_bars = qd_full + 8;

  const int b = blockIdx.z;
  const int bh = b * H + blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWgThreads, 0);

  int kv_len = kv_lens != nullptr ? kv_lens[b] : Lk;
  kv_len = max(0, min(kv_len, Lk));
  const int n_tiles = (kv_len + BK - 1) / BK;

  if (threadIdx.x == 0) {
    prefetch_tensor_map(&q_map);
    prefetch_tensor_map(&k_map);
    prefetch_tensor_map(&v_map);
    prefetch_tensor_map(&do_map);
    mbar_init(qd_full, 1);
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
      mbar_expect_tx(qd_full, 2 * T::kQBytes);
#pragma unroll
      for (int c = 0; c < kBoxes; ++c) {
        tma_load_3d(sQ + c * kBQ * kBoxBytes, &q_map, qd_full, c * 64, q0, bh);
        tma_load_3d(sDO + c * kBQ * kBoxBytes, &do_map, qd_full, c * 64, q0,
                    bh);
      }
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
    // ---- consumers: 64 q rows each ----
    regs_raise<RegSplit<T::kMinBlocks>::kConsumer>();
    const int cw = wg - 1;
    const int tw = threadIdx.x - wg * kWgThreads;
    const int warp = tw >> 5;
    const int lane = tw & 31;
    const int g = lane >> 2;   // accumulator row group
    const int tig = lane & 3;  // thread in group

    // dq (64 x D) in the wgmma accumulator layout: acc[4j + 2i + e] is row
    // 16 * warp + g + 8i, column 8j + 2 tig + e
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    // this thread's rows: lse (log2 domain) and delta; 0 past Lq, where Q
    // and dO are zero-filled, so dS is 0 there
    const int row = q0 + cw * 64 + warp * 16 + g;
    const size_t stats = static_cast<size_t>(bh) * stat_stride(Lq);
    float lse2[2], dval[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool live = row + 8 * r < Lq;
      lse2[r] = live ? lse[stats + row + 8 * r] * kLog2e : 0.f;
      dval[r] = live ? delta[stats + row + 8 * r] : 0.f;
    }
    const float scale_log2 = scale * kLog2e;

    // this warpgroup's 64 rows of each 128-row Q and dO box
    const uint32_t q_desc = desc_lo(sQ + cw * 64 * kBoxBytes, 16);
    const uint32_t do_desc = desc_lo(sDO + cw * 64 * kBoxBytes, 16);
    if (n_tiles > 0) mbar_wait(qd_full, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t parity = (t / kStages) & 1;
      const uint32_t bars = ring_bars + 32 * s;
      const uint32_t k_tile = sK + s * T::kKVBytes;
      const uint32_t k_desc = desc_lo(k_tile, 16);
      const uint32_t v_desc = desc_lo(sV + s * T::kKVBytes, 16);

      // S = Q K^T and dP = dO V^T: 64 x BK each, D / 16 k-steps of 32
      // bytes inside each box; dP's product runs while P is computed
      float sc[BK / 2], dp[BK / 2];
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
      mbar_wait(bars + 16, parity);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t in_box = (kk % 4) * 32;
        wgmma_ss<BK>(dp,
                     do_desc + (((kk / 4) * kBQ * kBoxBytes + in_box) >> 4),
                     v_desc + (((kk / 4) * BK * kBoxBytes + in_box) >> 4),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);

      // P, with the keys past kv_len (in the last visited tile) selected
      // to 0
      const int limit = kv_len - t * BK;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[4 * j + e] = prob(sc[4 * j + e], scale_log2, lse2[e >> 1],
                               j * 8 + tig * 2 + (e & 1) < limit);
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
      if (lane == 0) mbar_arrive(bars + 24);  // V stage free

      // dS = P (dP - delta) in bf16 as the A fragments of BK / 16 k-steps
      uint32_t ds[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int i = 8 * kk + 2 * f;
          const float dl = dval[f & 1];
          ds[kk][f] =
              pack_bf16(sc[i] * (dp[i] - dl), sc[i + 1] * (dp[i + 1] - dl));
        }
      }

      // dq += dS K: K (BK x D) is MN-major for this product; a k-step is
      // 16 rows of every box
      const uint32_t kt_desc = desc_lo(k_tile, BK * kBoxBytes);
      fence_regs(acc);
      fence_regs(ds);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D>(acc, ds[kk], kt_desc + ((kk * 16 * kBoxBytes) >> 4), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(bars + 8);  // K stage free
    }

    bf16* dqg = dq + static_cast<size_t>(bh) * Lq * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + tig * 2;
      if (row < Lq) {
        *reinterpret_cast<__nv_bfloat162*>(dqg + static_cast<size_t>(row) * D +
                                           col) =
            __floats2bfloat162_rn(acc[4 * j] * scale, acc[4 * j + 1] * scale);
      }
      if (row + 8 < Lq) {
        *reinterpret_cast<__nv_bfloat162*>(
            dqg + static_cast<size_t>(row + 8) * D + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] * scale,
                                  acc[4 * j + 3] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 dkv kernel
// ---------------------------------------------------------------------------

constexpr int dkv_smem(int kv_bytes, int q_bytes, int stat_bytes,
                       int p_bytes, int stages) {
  return 1024 + 2 * kv_bytes + stages * (2 * q_bytes + 2 * stat_bytes) +
         4 * p_bytes + 8 * (1 + 2 * stages);
}

template <int D>
struct DkvTiles {
  // D split between the consumers (their dk and dv would not fit whole)
  static constexpr bool kSplit = D > 64;
  static constexpr int kKeys = kSplit ? 64 : 128;  // keys per block
  static constexpr int kBQ = kSplit ? 64 : FLASH_DKV_BQ_D64;  // q rows a tile
  static constexpr int kCols = kSplit ? kBQ / 2 : kBQ;  // S^T columns a consumer
  static constexpr int kAccN = kSplit ? D / 2 : D;  // dk, dv columns a consumer
  static constexpr int kKVBytes = kKeys * D * 2;  // K or V
  static constexpr int kQBytes = kBQ * D * 2;     // a Q or dO tile
  static constexpr int kStatBytes = kBQ * 4;      // an lse or delta tile
  static constexpr int kPBytes = kSplit ? kKeys * kBQ * 2 : 0;  // P^T or dS^T
  // slack, K, V, the Q / dO / lse / delta ring, the P^T and dS^T buffers
  // and the barriers; as many stages as fit, up to 4
  static constexpr int kStages =
      dkv_smem(kKVBytes, kQBytes, kStatBytes, kPBytes, 4) <= kSmemMax   ? 4
      : dkv_smem(kKVBytes, kQBytes, kStatBytes, kPBytes, 3) <= kSmemMax ? 3
                                                                        : 2;
  static constexpr int kSmem =
      dkv_smem(kKVBytes, kQBytes, kStatBytes, kPBytes, kStages);
  static_assert(kBQ % 16 == 0 && kCols % 8 == 0, "BQ: a multiple of 16");
  static_assert(!kSplit || kBQ == 64, "the split's P^T rows are one box");
  static_assert(kSmem <= kSmemMax, "shared memory of one block");
};

template <int D>
__global__ void __launch_bounds__(kWgThreadsAll, 1)
    flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const __grid_constant__ CUtensorMap do_map,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const int* __restrict__ kv_lens,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              int H, int Lq, int Lk, float scale) {
  using T = DkvTiles<D>;
  constexpr int kBQ = T::kBQ;
  constexpr int kKeys = T::kKeys;
  constexpr int kCols = T::kCols;
  constexpr int kAccN = T::kAccN;
  constexpr int kStages = T::kStages;
  constexpr int kBoxes = D / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t smem_base = smem_u32(smem_raw);
  const uint32_t sK = (smem_base + 1023u) & ~1023u;
  const uint32_t sV = sK + T::kKVBytes;
  const uint32_t sQ = sV + T::kKVBytes;             // kStages tiles
  const uint32_t sDO = sQ + kStages * T::kQBytes;   // kStages tiles
  const uint32_t sP = sDO + kStages * T::kQBytes;   // 2 buffers (split)
  const uint32_t sDS = sP + 2 * T::kPBytes;         // 2 buffers (split)
  const uint32_t sLse = sDS + 2 * T::kPBytes;       // kStages tiles
  const uint32_t sDelta = sLse + kStages * T::kStatBytes;
  const uint32_t kv_full = sDelta + kStages * T::kStatBytes;
  const uint32_t ring_bars = kv_full + 8;  // per stage s: full, empty
  // a shared-memory address as a generic pointer
  auto at = [&](uint32_t addr) { return smem_raw + (addr - smem_base); };

  const int b = blockIdx.z;
  const int bh = b * H + blockIdx.y;
  const int k0 = blockIdx.x * kKeys;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWgThreads, 0);

  int kv_len = kv_lens != nullptr ? kv_lens[b] : Lk;
  kv_len = max(0, min(kv_len, Lk));
  // consumers with a real key: both or none where D is split, else one
  // for each 64 keys that hold one; the others only write zeros
  const int n_active = T::kSplit ? (k0 < kv_len ? 2 : 0)
                                 : max(0, min(2, (kv_len - k0 + 63) / 64));
  const int n_tiles = (Lq + kBQ - 1) / kBQ;

  if (threadIdx.x == 0) {
    prefetch_tensor_map(&q_map);
    prefetch_tensor_map(&k_map);
    prefetch_tensor_map(&v_map);
    prefetch_tensor_map(&do_map);
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring_bars + 16 * s, 1);  // full: the producer
      // empty: each warp of the active consumers
      mbar_init(ring_bars + 16 * s + 8, 4 * max(n_active, 1));
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: K and V once, then Q, dO, lse and delta tiles ----
    regs_lower<kProducerRegs>();
    if (threadIdx.x == 0 && n_active > 0) {
      mbar_expect_tx(kv_full, 2 * T::kKVBytes);
#pragma unroll
      for (int c = 0; c < kBoxes; ++c) {
        tma_load_3d(sK + c * kKeys * kBoxBytes, &k_map, kv_full, c * 64, k0,
                    bh);
        tma_load_3d(sV + c * kKeys * kBoxBytes, &v_map, kv_full, c * 64, k0,
                    bh);
      }
      const size_t stats = static_cast<size_t>(bh) * stat_stride(Lq);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const uint32_t parity = ((t / kStages) & 1) ^ 1;
        const uint32_t full = ring_bars + 16 * s;
        mbar_wait(full + 8, parity);
        mbar_expect_tx(full, 2 * T::kQBytes + 2 * T::kStatBytes);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c) {
          tma_load_3d(sQ + s * T::kQBytes + c * kBQ * kBoxBytes, &q_map, full,
                      c * 64, t * kBQ, bh);
          tma_load_3d(sDO + s * T::kQBytes + c * kBQ * kBoxBytes, &do_map,
                      full, c * 64, t * kBQ, bh);
        }
        bulk_load(sLse + s * T::kStatBytes, lse + stats + t * kBQ,
                  T::kStatBytes, full);
        bulk_load(sDelta + s * T::kStatBytes, delta + stats + t * kBQ,
                  T::kStatBytes, full);
      }
    }
  } else {
    // ---- consumers ----
    regs_raise<RegSplit<1>::kConsumer>();
    const int cw = wg - 1;
    const int tw = threadIdx.x - wg * kWgThreads;
    const int warp = tw >> 5;
    const int lane = tw & 31;
    const int g = lane >> 2;
    const int tig = lane & 3;
    const int kbase = T::kSplit ? 0 : cw * 64;       // first key (block)
    const int colbase = T::kSplit ? cw * kCols : 0;  // first S^T column
    const int dbase = T::kSplit ? cw * kAccN : 0;    // first dk/dv column
    const bool active = T::kSplit ? n_active > 0 : cw < n_active;

    // dk, dv (64 keys x kAccN) in the accumulator layout: acc[4j + 2i + e]
    // is key kbase + 16 * warp + g + 8i, column dbase + 8j + 2 tig + e
    float acc_dk[kAccN / 2], acc_dv[kAccN / 2];
#pragma unroll
    for (int i = 0; i < kAccN / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
    const int key = k0 + kbase + warp * 16 + g;  // and key + 8
    const bool key_ok[2] = {key < kv_len, key + 8 < kv_len};
    const float scale_log2 = scale * kLog2e;
    // this consumer's 64 keys of each K and V box
    const uint32_t k_desc = desc_lo(sK + kbase * kBoxBytes, 16);
    const uint32_t v_desc = desc_lo(sV + kbase * kBoxBytes, 16);

    if (active) mbar_wait(kv_full, 0);
    for (int t = 0; active && t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t parity = (t / kStages) & 1;
      const uint32_t full = ring_bars + 16 * s;
      const uint32_t q_tile = sQ + s * T::kQBytes;
      const uint32_t do_tile = sDO + s * T::kQBytes;
      // this consumer's q rows of each Q and dO box, K-major for S^T, dP^T
      const uint32_t qc_desc = desc_lo(q_tile + colbase * kBoxBytes, 16);
      const uint32_t doc_desc = desc_lo(do_tile + colbase * kBoxBytes, 16);

      // S^T = K Q^T and dP^T = V dO^T: 64 x kCols each; dP^T's product
      // runs while P^T is computed
      float st[kCols / 2], dpt[kCols / 2];
      mbar_wait(full, parity);
      fence_regs(st);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t in_box = (kk % 4) * 32;
        wgmma_ss<kCols>(
            st, k_desc + (((kk / 4) * kKeys * kBoxBytes + in_box) >> 4),
            qc_desc + (((kk / 4) * kBQ * kBoxBytes + in_box) >> 4), kk > 0);
      }
      wgmma_commit();
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t in_box = (kk % 4) * 32;
        wgmma_ss<kCols>(
            dpt, v_desc + (((kk / 4) * kKeys * kBoxBytes + in_box) >> 4),
            doc_desc + (((kk / 4) * kBQ * kBoxBytes + in_box) >> 4), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);

      // P^T, selected to 0 at masked keys and at q rows past Lq; lse and
      // delta of column c are the tile's row colbase + c
      const float* lse_t =
          reinterpret_cast<const float*>(at(sLse + s * T::kStatBytes)) + colbase;
      const float* delta_t =
          reinterpret_cast<const float*>(at(sDelta + s * T::kStatBytes)) +
          colbase;
      const int q_limit = Lq - t * kBQ - colbase;
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const int c = j * 8 + tig * 2;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[4 * j + e] = prob(st[4 * j + e], scale_log2,
                               ((e & 1) ? l2.y : l2.x) * kLog2e,
                               key_ok[e >> 1] && c + (e & 1) < q_limit);
        }
      }
      wgmma_wait<0>();
      fence_regs(dpt);
      // dS^T = P^T (dP^T - delta), in place of dP^T
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(delta_t + j * 8 + tig * 2);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * j + e] =
              st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? d2.y : d2.x));
      }

      // dv += P^T dO and dk += dS^T Q over this consumer's dk/dv columns;
      // dO and Q are MN-major here (a k-step is 16 q rows of every box)
      const uint32_t dom_desc =
          desc_lo(do_tile + (dbase / 64) * kBQ * kBoxBytes, kBQ * kBoxBytes);
      const uint32_t qm_desc =
          desc_lo(q_tile + (dbase / 64) * kBQ * kBoxBytes, kBQ * kBoxBytes);
      if constexpr (T::kSplit) {
        // this consumer's columns of P^T and dS^T to the tile's buffers, in
        // bf16, swizzled as TMA would store a 64 x kBQ tile
        const uint32_t p_buf = sP + (t & 1) * T::kPBytes;
        const uint32_t ds_buf = sDS + (t & 1) * T::kPBytes;
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const uint32_t off = swizzle128_offset(
                kKeys, warp * 16 + g + 8 * i, colbase + j * 8 + tig * 2);
            *reinterpret_cast<uint32_t*>(at(p_buf + off)) =
                pack_bf16(st[4 * j + 2 * i], st[4 * j + 2 * i + 1]);
            *reinterpret_cast<uint32_t*>(at(ds_buf + off)) =
                pack_bf16(dpt[4 * j + 2 * i], dpt[4 * j + 2 * i + 1]);
          }
        }
        fence_proxy_async();
        named_barrier_sync(1, 2 * kWgThreads);  // both halves stored
        const uint32_t p_desc = desc_lo(p_buf, 16);
        const uint32_t ds_desc = desc_lo(ds_buf, 16);
        fence_regs(acc_dv);
        fence_regs(acc_dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBQ / 16; ++kk) {
          const uint32_t a_off =
              ((kk / 4) * kKeys * kBoxBytes + (kk % 4) * 32) >> 4;
          const uint32_t b_off = (kk * 16 * kBoxBytes) >> 4;
          wgmma_ss_mn<kAccN>(acc_dv, p_desc + a_off, dom_desc + b_off, 1);
          wgmma_ss_mn<kAccN>(acc_dk, ds_desc + a_off, qm_desc + b_off, 1);
        }
      } else {
        // P^T and dS^T in bf16 as the A fragments of kBQ / 16 k-steps
        uint32_t pa[kBQ / 16][4], da[kBQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBQ / 16; ++kk) {
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const int i = 8 * kk + 2 * f;
            pa[kk][f] = pack_bf16(st[i], st[i + 1]);
            da[kk][f] = pack_bf16(dpt[i], dpt[i + 1]);
          }
        }
        fence_regs(acc_dv);
        fence_regs(acc_dk);
        fence_regs(pa);
        fence_regs(da);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBQ / 16; ++kk) {
          const uint32_t b_off = (kk * 16 * kBoxBytes) >> 4;
          wgmma_rs<kAccN>(acc_dv, pa[kk], dom_desc + b_off, 1);
          wgmma_rs<kAccN>(acc_dk, da[kk], qm_desc + b_off, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      if (lane == 0) mbar_arrive(full + 8);  // Q / dO stage free
    }

    // keys at or past kv_len hold exact zeros (P was 0 there)
    bf16* dkg = dk + static_cast<size_t>(bh) * Lk * D;
    bf16* dvg = dv + static_cast<size_t>(bh) * Lk * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = key + 8 * i;
      if (r >= Lk) continue;
#pragma unroll
      for (int j = 0; j < kAccN / 8; ++j) {
        const size_t off = static_cast<size_t>(r) * D + dbase + j * 8 + tig * 2;
        *reinterpret_cast<__nv_bfloat162*>(dkg + off) = __floats2bfloat162_rn(
            acc_dk[4 * j + 2 * i] * scale, acc_dk[4 * j + 2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dvg + off) = __floats2bfloat162_rn(
            acc_dv[4 * j + 2 * i], acc_dv[4 * j + 2 * i + 1]);
      }
    }
  }
}

// 0 when setmaxnreg's split fits the registers `kernel` was built with:
// the consumers' raise waits for registers the producer gives up, so a
// split that does not fit would never return.
template <int kMinBlocks, typename Kernel>
int check_registers(Kernel kernel) {
  using R = RegSplit<kMinBlocks>;
  cudaFuncAttributes attr{};
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pool = attr.numRegs * kWgThreadsAll;
  const int needed = kProducerRegs * kWgThreads + R::kConsumer * 2 * kWgThreads;
  return attr.numRegs <= R::kEntry && needed <= pool ? 0 : kErrRegisters;
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

bool misaligned(const BwdArgs& a) {
  return (reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
          reinterpret_cast<uintptr_t>(a.v) |
          reinterpret_cast<uintptr_t>(a.dout) |
          reinterpret_cast<uintptr_t>(a.lse) |
          reinterpret_cast<uintptr_t>(a.delta)) %
             16 !=
         0;
}

// Tensor maps of q and dO read in boxes of `q_rows` rows, k and v in boxes
// of `k_rows`; false where an encode fails.
template <int D>
bool encode_maps(const BwdArgs& a, int q_rows, int k_rows, CUtensorMap* q_map,
                 CUtensorMap* k_map, CUtensorMap* v_map,
                 CUtensorMap* do_map) {
  const uint64_t n = static_cast<uint64_t>(a.B) * a.H;
  return encode_bf16_rows(q_map, a.q, n, a.Lq, D, q_rows) &&
         encode_bf16_rows(do_map, a.dout, n, a.Lq, D, q_rows) &&
         encode_bf16_rows(k_map, a.k, n, a.Lk, D, k_rows) &&
         encode_bf16_rows(v_map, a.v, n, a.Lk, D, k_rows);
}

template <int D>
int launch_dq_bf16(const BwdArgs& a, void* dq) {
  using T = DqTiles<D>;
  if (misaligned(a)) return kErrAlignment;
  static const int registers =
      check_registers<T::kMinBlocks>(flash_bwd_dq_bf16_kernel<D>);
  if (registers != 0) return registers;
  CUtensorMap q_map, k_map, v_map, do_map;
  if (!encode_maps<D>(a, T::kBQ, T::kBK, &q_map, &k_map, &v_map, &do_map))
    return kErrTensorMap;
  cudaError_t err = allow_smem(flash_bwd_dq_bf16_kernel<D>, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Lq + T::kBQ - 1) / T::kBQ, a.H, a.B);
  flash_bwd_dq_bf16_kernel<D><<<grid, kWgThreadsAll, T::kSmem, a.stream>>>(
      q_map, k_map, v_map, do_map, a.lse, a.delta, a.kv_lens,
      static_cast<bf16*>(dq), a.H, a.Lq, a.Lk, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_bf16(const BwdArgs& a, void* dk, void* dv) {
  using T = DkvTiles<D>;
  if (misaligned(a)) return kErrAlignment;
  static const int registers =
      check_registers<1>(flash_bwd_dkv_bf16_kernel<D>);
  if (registers != 0) return registers;
  CUtensorMap q_map, k_map, v_map, do_map;
  if (!encode_maps<D>(a, T::kBQ, T::kKeys, &q_map, &k_map, &v_map, &do_map))
    return kErrTensorMap;
  cudaError_t err = allow_smem(flash_bwd_dkv_bf16_kernel<D>, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Lk + T::kKeys - 1) / T::kKeys, a.H, a.B);
  flash_bwd_dkv_bf16_kernel<D><<<grid, kWgThreadsAll, T::kSmem, a.stream>>>(
      q_map, k_map, v_map, do_map, a.lse, a.delta, a.kv_lens,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.H, a.Lq, a.Lk,
      a.scale);
  return static_cast<int>(cudaGetLastError());
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
  if (dtype == 0 && D == 64) return static_cast<int>(launch_dq_f32<64>(a, dq));
  if (dtype == 0 && D == 256) return static_cast<int>(launch_dq_f32<256>(a, dq));
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
  if (dtype == 0 && D == 64)
    return static_cast<int>(launch_dkv_f32<64>(a, dk, dv));
  if (dtype == 0 && D == 256)
    return static_cast<int>(launch_dkv_f32<256>(a, dk, dv));
  return static_cast<int>(cudaErrorInvalidValue);
}
