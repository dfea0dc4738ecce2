// Int8 W8A8 projections for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces `quant_matmul` (f_lite_tpu/quant.py:52). It has no Pallas
// kernel: XLA lowers it, fusing the per-token activation quantization into
// one pass and the dequant into the epilogue of an int8 x int8 -> int32
// dot. Those two fusions are the two kernels here:
//
// - quantize_rows_kernel: x (M, K) bf16 or fp32 -> x8 (M, K) int8 and
//   sx (M,) fp32, one block a row: amax of |x| over the row (fp32), sx =
//   amax / 127 (IEEE division; 1 where it is 0), x8 = clip(rint(x / sx),
//   -127, 127) with rint rounding half to even, as jnp.round does. Two
//   more entries serve a row-parallel layer under tensor parallelism,
//   whose K is split over the ranks while sx is the whole row's:
//   `row_amax` writes each row's amax only, and `quantize_rows_given`
//   quantizes with a given amax (the ranks' maximum) in place of its own.
//   Bound:
//   bytes (read x, write x8 and sx; 63 MB, 0.019 ms at (8224, 2560) bf16).
//   The row is read twice, the second time from L1/L2.
//
// - int8_gemm_kernel: y[m, n] = out((float(acc[m, n]) * sx[m]) * scale[n])
//   (+ bias[n], added in the output type after the rounding), with acc =
//   sum_k x8[m, k] * w8[n, k] in int32; out is bf16 or fp32 (the
//   activations' type), or, for tests, the int32 acc itself. Bound: int8
//   operations at the serving shapes (2*M*N*K: 0.163 ms at the 7B's qkv,
//   M 8224, N 7680, K 2560, against 1,979 TOP/s). No int32 tensor reaches
//   device memory: the dequant runs on the accumulators in registers.
//   Design: persistent and warp-specialised. min(tiles, SMs) blocks of
//   three warpgroups each walk their output tiles in a grouped raster
//   order (`tile_coords`). Warpgroup 0 is the producer: one thread issues
//   TMA loads of 128-byte-swizzled K tiles (128 int8 a row) of x8 and w8
//   through a ring of kStages stages, each with a full and an empty
//   mbarrier, and its stage and phase run on from tile to tile, so the
//   next tile's loads overlap this one's end. Warpgroups 1 and 2 are the
//   consumers: wgmma.mNk32.s32.s8.s8 with both operands K-major in shared
//   memory (the only layout 8-bit wgmma takes, which is why the weight
//   stays in torch's (N, K) layout), four k-steps of 32 bytes a K tile,
//   one group in flight while the next K tile's wait runs; a stage is
//   released when the group that read it has completed. Two designs, both
//   compiled; the wrapper picks one from K (`gemm_design`):
//   - ping-pong (K below 4096): each consumer owns every other 128 x 128
//     tile (two m64n128k32 a k-step, 128 int32 accumulators a thread) and
//     the two mainloops take turns (named barriers), so one consumer's
//     epilogue runs under the other's products; 4 stages of 32 KB;
//   - cooperative (K from 4096): both consumers share a 128 x 256 tile, 64
//     rows each (one m64n256k32 a k-step); 3 stages of 48 KB.
//   The epilogue stages the dequantized tile in shared memory (swizzled,
//   bank-conflict free) and one thread TMA stores it; scale, bias and sx
//   are loaded once a tile, before the mainloop. Rows past M, columns past
//   N and K past its end arrive as TMA's zeros; the stores clip. The
//   epilogue converts with __int2float_rn and multiplies with __fmul_rn
//   (no contraction into an FMA), so the result equals the plain
//   version's bit for bit.
//
//   Why these choices (`tools/int8_tiles.py --k-sweep`, NVIDIA H100 80GB
//   HBM3 at 700 W, both designs in turns at M 8224, N 7680): ping-pong
//   hides the epilogue, so it leads where tiles are short (0.2354 ms
//   against the cooperative tile's 0.2514 at K 2560, 0.1107 against
//   0.1294 at K 1024), but its k-tiles cost more (0.79 us for 128 x 256
//   outputs against 0.69, fits over K >= 1024; it reads a third more L2
//   and a fifth more shared-memory bytes a product): from K 5120 the
//   cooperative tile leads (0.428 against 0.455 ms; 0.877 against 0.959
//   at K 10240, and 0.2797 against 0.3145 at the 7B's down_proj). The
//   times cross near K 3500, hence 4096. Shared memory:
//   ping-pong's 4 stages of 32 KB beside 64 KB of staging fit the 227 KB
//   of a block, 5 do not; the cooperative tile fits 3 stages of 48 KB
//   beside the same staging. A cluster of two CTAs that multicast the
//   weight tile (half the L2 bytes) was 2-10% slower with either design,
//   and raster groups of 4 or 16 m-tiles no faster than 8.
//
// Entry points return cudaGetLastError() after the launch (0 on success)
// or a kErr* code without launching. Dtype codes: 0 fp32, 1 bf16, 2 int32
// (the gemm's output only). x, x8, w8 and the gemm's output must be
// 16-byte aligned, K a multiple of 16 and N of 8 (the wrapper checks all
// of it); the gemm takes the card's SM count, the persistent grid's size,
// and the design (0 ping-pong, 1 cooperative).

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "flash_attention_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int kErrTensorMap = 10001;  // cuTensorMapEncodeTiled failed
constexpr int kErrAlignment = 10003;  // x, x8 or w8 not 16-byte aligned

// ---------------------------------------------------------------------------
// quantize_rows
// ---------------------------------------------------------------------------

constexpr int kQMaxThreads = 256;  // threads a row at most (8 values each)

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// What a launch of quantize_rows_kernel does with a row.
enum QuantMode : int {
  kFused = 0,  // amax of the row, sx, x8
  kGiven = 1,  // sx and x8 from the given amax_in[row]
  kAmax = 2,   // amax of the row only, written to sx[row]
};

// One row of K values a block of blockDim.x (a multiple of 32, at most
// kQMaxThreads) threads, 8 consecutive values a thread a step.
template <typename T, int Mode>
__global__ void __launch_bounds__(kQMaxThreads)
    quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ x8,
                         float* __restrict__ sx,
                         const float* __restrict__ amax_in, int K) {
  __shared__ float warp_max[kQMaxThreads / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * K;
  int8_t* qr = x8 + row * K;
  const int step = blockDim.x * 8;

  float amax = 0.f;
  if constexpr (Mode == kGiven) {
    amax = amax_in[row];
  } else {
    for (int c = threadIdx.x * 8; c < K; c += step) {
      float v[8];
      load8(xr + c, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
    __syncthreads();
    amax = warp_max[0];
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w)
      amax = fmaxf(amax, warp_max[w]);
    if constexpr (Mode == kAmax) {
      if (threadIdx.x == 0) sx[row] = amax;
      return;
    }
  }
  float s = __fdiv_rn(amax, 127.f);
  s = s == 0.f ? 1.f : s;
  if (threadIdx.x == 0) sx[row] = s;

  for (int c = threadIdx.x * 8; c < K; c += step) {
    float v[8];
    load8(xr + c, v);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float q = fminf(fmaxf(rintf(__fdiv_rn(v[i], s)), -127.f), 127.f);
      const uint32_t byte = static_cast<uint32_t>(__float2int_rn(q)) & 0xffu;
      packed[i / 4] |= byte << (8 * (i % 4));
    }
    *reinterpret_cast<uint2*>(qr + c) = make_uint2(packed[0], packed[1]);
  }
}

template <typename T, int Mode>
int launch_quantize(const void* x, void* x8, float* sx, const float* amax_in,
                    int M, int K, cudaStream_t stream) {
  // one thread per 8 values of the row, whole warps, at most kQMaxThreads
  const int warps = (K / 8 + 31) / 32;
  const int threads = warps * 32 < kQMaxThreads ? warps * 32 : kQMaxThreads;
  quantize_rows_kernel<T, Mode><<<M, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(x8), sx, amax_in, K);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// int8_gemm: persistent, TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kBM = 128;     // rows of an output tile
constexpr int kBK = 128;     // int8 a K tile: one 128-byte swizzled row
constexpr int kGroupM = 8;   // m-tiles a group of the raster order
constexpr int kWgThreads = 128;
constexpr int kThreads = 3 * kWgThreads;  // producer + 2 consumers
constexpr int kABytes = kBM * kBK;

// The two designs' tiles and shared memory.
template <bool PingPong>
struct Design {
  static constexpr int kBN = PingPong ? 128 : 256;  // columns of a tile
  static constexpr int kStages = PingPong ? 4 : 3;  // ring depth
  // rows of a tile that one consumer computes: all of it (ping-pong) or
  // half of it (cooperative), in 64-row wgmma fragments
  static constexpr int kCM = PingPong ? kBM : kBM / 2;
  static constexpr int kFrags = kCM / 64;
  static constexpr int kBBytes = kBN * kBK;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // a consumer's output staging: its part of a bf16 tile, or half of it in
  // 4-byte types
  static constexpr int kOutBytes = kCM * kBN * 2;
  // a consumer's tile parameters (fp32): scale and bias of the tile's
  // columns, then sx of its rows
  static constexpr int kParamFloats = 2 * kBN + kCM;
  // warps that read a stage
  static constexpr int kEmptyArrivals = PingPong ? 4 : 8;
  // 1024 bytes of slack to align the tiles for the 128-byte swizzle, the
  // ring, the staging, the parameters, then a full and an empty barrier a
  // stage
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kOutBytes +
                               2 * 4 * kParamFloats + 16 * kStages;
  static_assert(kSmem <= 232448, "shared memory of one block");
};

// d (64 x N int32, the wgmma accumulator layout) (+)= A (64 x 32 int8,
// K-major, descriptor low word a) * B (32 x N int8, K-major, descriptor
// low word b); scale_d == 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[N / 2], uint32_t a,
                                         uint32_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<256>(uint32_t (&d)[128], uint32_t a,
                                            uint32_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %131, 0;\n"
      "mov.b64 da, {%128, %130};\n"
      "mov.b64 db, {%129, %130};\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "da, db, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "r"(a), "r"(b), "r"(kDescHi), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(uint32_t (&d)[64], uint32_t a,
                                            uint32_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %67, 0;\n"
      "mov.b64 da, {%64, %66};\n"
      "mov.b64 db, {%65, %66};\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "da, db, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a), "r"(b), "r"(kDescHi), "r"(scale_d));
}

template <int F, int N>
__device__ __forceinline__ void fence_acc(uint32_t (&r)[F][N]) {
#pragma unroll
  for (int f = 0; f < F; ++f) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[f][i])::"memory");
  }
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint2 v) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(v.x),
               "r"(v.y)
               : "memory");
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(int32_t) { return 0.f; }

// The output tile (mt, nt) of linear work index u over a tiles_m x tiles_n
// grid: groups of kGroupM m-tiles (the last group may be shorter) and,
// inside a group, the m-tiles fastest, so that the blocks that run at one
// time share the weight's n-tiles and a few activation m-tiles in L2.
// `tile_coords` and `tile_schedule` of `ops/cuda/int8_gemm.py` are the
// same order.
__device__ __forceinline__ void tile_coords(int u, int tiles_m, int tiles_n,
                                            int& mt, int& nt) {
  const int per_group = kGroupM * tiles_n;
  const int group = u / per_group;
  const int first = group * kGroupM;
  const int size = min(tiles_m - first, kGroupM);
  const int r = u - group * per_group;
  mt = first + r % size;
  nt = r / size;
}

// OutT: __nv_bfloat16 (the serving path), float, or int32_t (the
// accumulators; sx, scale and bias unused); bias, if not null, is of type
// OutT. Each consumer stages its part of the tile in kOutBytes of shared
// memory, as boxes of 128 bytes (64 bf16 or 32 4-byte columns) by kCM
// rows with the 128-byte swizzle, and one thread TMA stores them; 4-byte
// outputs go out in two passes of half the columns each.
template <bool PingPong, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                     const __grid_constant__ CUtensorMap b_map,
                     const __grid_constant__ CUtensorMap out_map,
                     const float* __restrict__ sx,
                     const float* __restrict__ scale,
                     const OutT* __restrict__ bias, OutT* __restrict__ out,
                     int M, int N, int K) {
  using D = Design<PingPong>;
  constexpr int kBN = D::kBN, kStages = D::kStages, kCM = D::kCM;
  constexpr int kFrags = D::kFrags, kBBytes = D::kBBytes;
  constexpr int kOutBytes = D::kOutBytes, kParamFloats = D::kParamFloats;
  constexpr bool kInt32 = std::is_same_v<OutT, int32_t>;
  constexpr bool kBf16 = std::is_same_v<OutT, __nv_bfloat16>;
  constexpr int kElem = sizeof(OutT);
  constexpr int kPasses = kElem / 2;          // staging passes a tile
  constexpr int kPassCols = kBN / kPasses;    // columns a pass
  constexpr int kBoxCols = 128 / kElem;       // columns a 128-byte box
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sA = (raw + 1023u) & ~1023u;   // kStages A tiles
  const uint32_t sB = sA + kStages * kABytes;   // kStages B tiles
  const uint32_t sOut = sB + kStages * kBBytes;  // two consumers' staging
  const uint32_t sPar = sOut + 2 * kOutBytes;    // two consumers' parameters
  // per stage s: full at bars + 16 s, empty at bars + 16 s + 8
  const uint32_t bars = sPar + 2 * 4 * kParamFloats;

  const int tiles_m = (M + kBM - 1) / kBM;
  const int tiles_n = (N + kBN - 1) / kBN;
  const int tiles = tiles_m * tiles_n;
  const int block = blockIdx.x, blocks = gridDim.x;
  const int n_k = (K + kBK - 1) / kBK;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWgThreads, 0);

  if (threadIdx.x == 0) {
    prefetch_tensor_map(&a_map);
    prefetch_tensor_map(&b_map);
    prefetch_tensor_map(&out_map);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 16 * s, 1);  // full: the producer's expect_tx
      mbar_init(bars + 16 * s + 8, D::kEmptyArrivals);  // empty: readers
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread walks the block's tiles and their k-tiles
    // through one ring. Its stage and phase run on across tiles, so the
    // next tile's loads start while the consumers finish this one. ----
    if (threadIdx.x == 0) {
      int g = 0;  // k-tiles loaded so far by this block
      for (int u = block; u < tiles; u += blocks) {
        int mt, nt;
        tile_coords(u, tiles_m, tiles_n, mt, nt);
        for (int kt = 0; kt < n_k; ++kt, ++g) {
          const int s = g % kStages;
          // a stage's first use waits for nothing (the phase before 0)
          mbar_wait(bars + 16 * s + 8, ((g / kStages) & 1) ^ 1);
          mbar_expect_tx(bars + 16 * s, D::kStageBytes);
          tma_load_3d(sA + s * kABytes, &a_map, bars + 16 * s, kt * kBK,
                      mt * kBM, 0);
          tma_load_3d(sB + s * kBBytes, &b_map, bars + 16 * s, kt * kBK,
                      nt * kBN, 0);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  const int c = wg - 1;
  const int tw = threadIdx.x - wg * kWgThreads;
  const int warp = tw >> 5;
  const int lane = tw & 31;
  const int g = lane >> 2;   // accumulator row group
  const int tig = lane & 3;  // thread in group
  // par[0, kBN): scale of the tile's columns; par[kBN, 2 kBN): bias;
  // par[2 kBN, 2 kBN + kCM): sx of the consumer's rows
  float* par = reinterpret_cast<float*>(smem_raw + (sPar - raw)) +
               c * kParamFloats;
  const uint32_t staging = sOut + c * kOutBytes;
  constexpr int kCols = kBN / kWgThreads;  // columns' parameters a thread loads

  // acc[f][4j + 2i + e] is row 64 f + 16 warp + g + 8i, column 8j + 2 tig
  // + e of the consumer's part of the tile
  uint32_t acc[kFrags][kBN / 2];

  // The block's i-th tile is tile block + i blocks; the cooperative
  // consumers take every tile (64 rows each), the ping-pong consumers every
  // other one (all 128 rows), and its k-tiles are the ring's [i n_k, (i +
  // 1) n_k).
  for (int i = PingPong ? c : 0; block + i * blocks < tiles;
       i += PingPong ? 2 : 1) {
    int mt, nt;
    tile_coords(block + i * blocks, tiles_m, tiles_n, mt, nt);
    const int m0 = mt * kBM + (PingPong ? 0 : c * kCM);  // consumer's rows
    const int n0 = nt * kBN;
    // The tile's parameters are loaded now and stored to shared memory for
    // the epilogue after the mainloop, so that their latency is hidden.
    float p_scale[kCols], p_bias[kCols], p_sx = 0.f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int col = n0 + tw * kCols + e;
      p_scale[e] = !kInt32 && col < N ? scale[col] : 0.f;
      p_bias[e] = !kInt32 && bias != nullptr && col < N ? to_float(bias[col])
                                                        : 0.f;
    }
    if (!kInt32 && tw < kCM && m0 + tw < M) p_sx = sx[m0 + tw];

    if constexpr (PingPong) {
      // The mainloops take turns: the other consumer's tile before this
      // one has waited for all its stages (so every phase before this
      // tile's has completed and the parity waits cannot alias) and has
      // issued all its products.
      if (i > 0) named_barrier_sync(4 - c, 2 * kWgThreads);
    }
    const int g0 = i * n_k;
    const uint32_t a_rows = sA + (PingPong ? 0 : c * 64 * kBK);
    for (int kt = 0; kt < n_k; ++kt) {
      const int gk = g0 + kt;
      const int s = gk % kStages;
      const uint32_t a_desc = desc_lo(a_rows + s * kABytes, 16);
      const uint32_t b_desc = desc_lo(sB + s * kBBytes, 16);
      mbar_wait(bars + 16 * s, (gk / kStages) & 1);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) {
#pragma unroll
        for (int f = 0; f < kFrags; ++f)
          wgmma_s8<kBN>(acc[f], a_desc + ((f * 64 * kBK + kk * 32) >> 4),
                        b_desc + ((kk * 32) >> 4), kt > 0 || kk > 0);
      }
      wgmma_commit();
      // the previous k-tile's group has completed: release its stage
      wgmma_wait<1>();
      fence_acc(acc);
      if (kt > 0 && lane == 0)
        mbar_arrive(bars + 16 * ((gk - 1) % kStages) + 8);
    }
    if constexpr (PingPong) {
      if (block + (i + 1) * blocks < tiles)
        named_barrier_arrive(3 + c, 2 * kWgThreads);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(bars + 16 * ((g0 + n_k - 1) % kStages) + 8);

    // ---- epilogue ----
    // the last tile's stores have read the staging, and every thread is
    // done with the last tile's parameters
    if (tw == 0) bulk_wait_read<0>();
    named_barrier_sync(1 + c, kWgThreads);
    if constexpr (!kInt32) {
#pragma unroll
      for (int e = 0; e < kCols; ++e) {
        par[tw * kCols + e] = p_scale[e];
        par[kBN + tw * kCols + e] = p_bias[e];
      }
      if (tw < kCM) par[2 * kBN + tw] = p_sx;
      named_barrier_sync(1 + c, kWgThreads);
    }
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
      if (pass > 0) {  // the first pass's stores have read the staging
        if (tw == 0) bulk_wait_read<0>();
        named_barrier_sync(1 + c, kWgThreads);
      }
#pragma unroll
      for (int f = 0; f < kFrags; ++f) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = f * 64 + warp * 16 + g + 8 * h;  // row in the part
          const float rs = kInt32 ? 0.f : par[2 * kBN + r];
#pragma unroll
          for (int jj = 0; jj < kPassCols / 8; ++jj) {
            const int j = pass * (kPassCols / 8) + jj;
            const int col = 8 * j + 2 * tig;  // column in the tile
            const int a0 = static_cast<int>(acc[f][4 * j + 2 * h]);
            const int a1 = static_cast<int>(acc[f][4 * j + 2 * h + 1]);
            // byte of the pair in the pass's row: its box, and its 16-byte
            // chunk swizzled with r % 8 (= g)
            const int byte = (8 * jj + 2 * tig) * kElem;
            const uint32_t addr = staging + (byte / 128) * (kCM * 128) +
                                  r * 128 +
                                  ((((byte % 128) / 16) ^ (r % 8)) << 4) +
                                  byte % 16;
            if constexpr (kInt32) {
              st_shared(addr, make_uint2(a0, a1));
            } else {
              const float2 sc = *reinterpret_cast<const float2*>(par + col);
              const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(a0), rs), sc.x);
              const float v1 = __fmul_rn(__fmul_rn(__int2float_rn(a1), rs), sc.y);
              const float2 bi =
                  *reinterpret_cast<const float2*>(par + kBN + col);
              if constexpr (kBf16) {
                // both columns rounded to bf16 by one instruction (each
                // round to nearest even, as two conversions would)
                __nv_bfloat162 y = __floats2bfloat162_rn(v0, v1);
                if (bias != nullptr) {
                  // the bias is added to the rounded output, in bf16 (one
                  // rounding)
                  const float2 yf = __bfloat1622float2(y);
                  y = __floats2bfloat162_rn(__fadd_rn(yf.x, bi.x),
                                            __fadd_rn(yf.y, bi.y));
                }
                st_shared(addr, *reinterpret_cast<const uint32_t*>(&y));
              } else {
                st_shared(addr, bias != nullptr
                                    ? make_uint2(__float_as_uint(__fadd_rn(v0, bi.x)),
                                                 __float_as_uint(__fadd_rn(v1, bi.y)))
                                    : make_uint2(__float_as_uint(v0),
                                                 __float_as_uint(v1)));
              }
            }
          }
        }
      }
      // the staging is written: one thread stores it, box by box; rows and
      // columns past the matrix are not written
      fence_proxy_async();
      named_barrier_sync(1 + c, kWgThreads);
      if (tw == 0 && m0 < M) {
#pragma unroll
        for (int b = 0; b < kPassCols / kBoxCols; ++b)
          tma_store_3d(&out_map, staging + b * (kCM * 128),
                       n0 + pass * kPassCols + b * kBoxCols, m0, 0);
        bulk_commit();
      }
    }
  }
  if (tw == 0) bulk_wait<0>();
}

// A 3-D map over a contiguous int8 matrix (rows, cols), read in boxes of
// `box_rows` rows by 128 columns (128 bytes, the widest box of the 128-byte
// swizzle). Out-of-range rows and columns read as zeros.
bool encode_i8_rows(CUtensorMap* map, const void* base, uint64_t rows,
                    uint64_t cols, uint32_t box_rows) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {cols, rows, 1};
  const cuuint64_t strides[2] = {cols, rows * cols};  // bytes
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kBK), box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base),
            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 3-D map over the (rows, cols) output of type OutT, written in boxes of
// `box_rows` rows (a consumer's) by 128 bytes of columns with the 128-byte
// swizzle.
template <typename OutT>
bool encode_out_rows(CUtensorMap* map, void* base, uint64_t rows,
                     uint64_t cols, uint32_t box_rows) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const CUtensorMapDataType type =
      std::is_same_v<OutT, float>     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : std::is_same_v<OutT, int32_t> ? CU_TENSOR_MAP_DATA_TYPE_INT32
                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t dims[3] = {cols, rows, 1};
  const cuuint64_t strides[2] = {cols * sizeof(OutT),
                                 rows * cols * sizeof(OutT)};  // bytes
  const cuuint32_t box[3] = {128 / sizeof(OutT), box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, type, 3, base, dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool PingPong, typename OutT>
int launch_gemm(const void* x8, const float* sx, const void* w8,
                const float* scale, const void* bias, void* out, int M, int N,
                int K, int num_sms, cudaStream_t stream) {
  using D = Design<PingPong>;
  CUtensorMap a_map, b_map, out_map;
  if (!encode_i8_rows(&a_map, x8, M, K, kBM) ||
      !encode_i8_rows(&b_map, w8, N, K, D::kBN) ||
      !encode_out_rows<OutT>(&out_map, out, M, N, D::kCM))
    return kErrTensorMap;
  const cudaError_t err = allow_smem(int8_gemm_kernel<PingPong, OutT>, D::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: one block for each of min(tiles, SMs) tiles
  const int tiles = ((M + kBM - 1) / kBM) * ((N + D::kBN - 1) / D::kBN);
  int8_gemm_kernel<PingPong, OutT>
      <<<tiles < num_sms ? tiles : num_sms, kThreads, D::kSmem, stream>>>(
          a_map, b_map, out_map, sx, scale, static_cast<const OutT*>(bias),
          static_cast<OutT*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <bool PingPong>
int launch_gemm_typed(const void* x8, const float* sx, const void* w8,
                      const float* scale, const void* bias, void* out, int M,
                      int N, int K, int out_dtype, int num_sms,
                      cudaStream_t st) {
  if (out_dtype == 0)
    return launch_gemm<PingPong, float>(x8, sx, w8, scale, bias, out, M, N, K,
                                        num_sms, st);
  if (out_dtype == 1)
    return launch_gemm<PingPong, __nv_bfloat16>(x8, sx, w8, scale, bias, out,
                                                M, N, K, num_sms, st);
  if (out_dtype == 2)
    return launch_gemm<PingPong, int32_t>(x8, sx, w8, scale, bias, out, M, N,
                                          K, num_sms, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int Mode>
int quantize_entry(const void* x, void* x8, float* sx, const float* amax_in,
                   int M, int K, int in_dtype, cudaStream_t stream) {
  if (!aligned16(x) || (Mode != kAmax && !aligned16(x8))) return kErrAlignment;
  if (in_dtype == 0)
    return launch_quantize<float, Mode>(x, x8, sx, amax_in, M, K, stream);
  if (in_dtype == 1)
    return launch_quantize<__nv_bfloat16, Mode>(x, x8, sx, amax_in, M, K,
                                                stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int quantize_rows(const void* x, void* x8, float* sx, int M, int K,
                             int in_dtype, void* stream) {
  return quantize_entry<kFused>(x, x8, sx, nullptr, M, K, in_dtype,
                                static_cast<cudaStream_t>(stream));
}

// x8 and sx of x with each row's amax given (amax (M,) fp32): the fused
// entry's arithmetic from its amax on.
extern "C" int quantize_rows_given(const void* x, const float* amax, void* x8,
                                   float* sx, int M, int K, int in_dtype,
                                   void* stream) {
  return quantize_entry<kGiven>(x, x8, sx, amax, M, K, in_dtype,
                                static_cast<cudaStream_t>(stream));
}

// amax (M,) fp32: max |x| over each row, as the fused entry takes it.
extern "C" int row_amax(const void* x, float* amax, int M, int K,
                        int in_dtype, void* stream) {
  return quantize_entry<kAmax>(x, nullptr, amax, nullptr, M, K, in_dtype,
                               static_cast<cudaStream_t>(stream));
}

// The argument list of `int8_gemm_dequant`, for tools that bind the
// library of another checkout: 1 = (..., out_dtype, stream), one block a
// tile; 2 = (..., out_dtype, num_sms, design, stream).
extern "C" const int int8_gemm_abi = 2;

extern "C" int int8_gemm_dequant(const void* x8, const float* sx,
                                 const void* w8, const float* scale,
                                 const void* bias, void* out, int M, int N,
                                 int K, int out_dtype, int num_sms, int design,
                                 void* stream) {
  if (!aligned16(x8) || !aligned16(w8) || !aligned16(out)) return kErrAlignment;
  if (num_sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (design == 0)
    return launch_gemm_typed<true>(x8, sx, w8, scale, bias, out, M, N, K,
                                   out_dtype, num_sms, st);
  if (design == 1)
    return launch_gemm_typed<false>(x8, sx, w8, scale, bias, out, M, N, K,
                                    out_dtype, num_sms, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
