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
//   -127, 127) with rint rounding half to even, as jnp.round does. Bound:
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
//   Design, as the flash-attention forward's: a block of three
//   warpgroups owns a 128 x 256 output tile. Warpgroup 0 is the producer:
//   one thread issues TMA loads of 128-byte-swizzled K tiles (128 int8 a
//   row) of x8 (128 rows) and w8 (256 rows) through a ring of kStages
//   stages, each with a full and an empty mbarrier. Warpgroups 1 and 2 are
//   the consumers, 64 rows each: wgmma.m64n256k32.s32.s8.s8 with both
//   operands K-major in shared memory (the only layout 8-bit wgmma takes,
//   which is why the weight stays in torch's (N, K) layout), four k-steps
//   of 32 bytes a tile, one group in flight while the next tile's wait
//   runs; a stage is released when the group that read it has completed.
//   Rows past M, columns past N and K past its end arrive as TMA's zeros;
//   stores are masked. The epilogue converts with __int2float_rn and
//   multiplies with __fmul_rn (no contraction into an FMA), so the result
//   equals the plain version's bit for bit. No persistent grid, no
//   ping-pong between the consumers, no epilogue overlap.
//
// Entry points return cudaGetLastError() after the launch (0 on success)
// or a kErr* code without launching. Dtype codes: 0 fp32, 1 bf16, 2 int32
// (the gemm's output only). x, x8 and w8 must be 16-byte aligned, K a
// multiple of 16 and N of 8 (the wrapper checks all of it).

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

// One row of K values a block of blockDim.x (a multiple of 32, at most
// kQMaxThreads) threads, 8 consecutive values a thread a step.
template <typename T>
__global__ void __launch_bounds__(kQMaxThreads)
    quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ x8,
                         float* __restrict__ sx, int K) {
  __shared__ float warp_max[kQMaxThreads / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * K;
  int8_t* qr = x8 + row * K;
  const int step = blockDim.x * 8;

  float amax = 0.f;
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

template <typename T>
int launch_quantize(const void* x, void* x8, float* sx, int M, int K,
                    cudaStream_t stream) {
  // one thread per 8 values of the row, whole warps, at most kQMaxThreads
  const int warps = (K / 8 + 31) / 32;
  const int threads = warps * 32 < kQMaxThreads ? warps * 32 : kQMaxThreads;
  quantize_rows_kernel<T><<<M, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(x8), sx, K);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// int8_gemm: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kBM = 128;       // output rows a block (two consumers of 64)
constexpr int kBN = 256;       // output columns a block (one wgmma's N)
constexpr int kBK = 128;       // int8 a K tile: one 128-byte swizzled row
constexpr int kStages = 4;     // ring depth
constexpr int kWgThreads = 128;
constexpr int kThreads = 3 * kWgThreads;  // producer + 2 consumers
constexpr int kABytes = kBM * kBK;
constexpr int kBBytes = kBN * kBK;
constexpr int kStageBytes = kABytes + kBBytes;
// 1024 bytes of slack to align the tiles for the 128-byte swizzle, the
// ring, then a full and an empty barrier a stage
constexpr int kSmem = 1024 + kStages * kStageBytes + 16 * kStages;
static_assert(kSmem <= 232448, "shared memory of one block");

// d (64 x 256 int32, the wgmma accumulator layout) (+)= A (64 x 32 int8,
// K-major, descriptor low word a) * B (32 x 256 int8, K-major, descriptor
// low word b); scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_s8_n256(uint32_t (&d)[128], uint32_t a,
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

template <int N>
__device__ __forceinline__ void fence_acc(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Stores of two adjacent output columns (n, n + 1) of one row.
__device__ __forceinline__ void store2(float* out, float v0, float v1,
                                       const float* bias, int n) {
  if (bias != nullptr) {
    v0 = __fadd_rn(v0, bias[n]);
    v1 = __fadd_rn(v1, bias[n + 1]);
  }
  *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
}

__device__ __forceinline__ void store2(__nv_bfloat16* out, float v0, float v1,
                                       const __nv_bfloat16* bias, int n) {
  __nv_bfloat16 y0 = __float2bfloat16_rn(v0);
  __nv_bfloat16 y1 = __float2bfloat16_rn(v1);
  if (bias != nullptr) {
    // the bias is added to the rounded output, in bf16 (one rounding)
    y0 = __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(y0), __bfloat162float(bias[n])));
    y1 = __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(y1), __bfloat162float(bias[n + 1])));
  }
  __nv_bfloat162 pair;
  pair.x = y0;
  pair.y = y1;
  *reinterpret_cast<__nv_bfloat162*>(out) = pair;
}

// OutT: float or __nv_bfloat16 (dequantized output, bias of the same type)
// or int32_t (the accumulators; sx, scale and bias unused).
template <typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                     const __grid_constant__ CUtensorMap b_map,
                     const float* __restrict__ sx,
                     const float* __restrict__ scale,
                     const OutT* __restrict__ bias, OutT* __restrict__ out,
                     int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sA = (smem_u32(smem_raw) + 1023u) & ~1023u;  // kStages tiles
  const uint32_t sB = sA + kStages * kABytes;                 // kStages tiles
  // per stage s: full at bars + 16 s, empty at bars + 16 s + 8
  const uint32_t bars = sB + kStages * kBBytes;

  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWgThreads, 0);
  const int n_tiles = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    prefetch_tensor_map(&a_map);
    prefetch_tensor_map(&b_map);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 16 * s, 1);      // full: the producer's expect_tx
      mbar_init(bars + 16 * s + 8, 8);  // empty: each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the TMA loads in flight ----
    if (threadIdx.x == 0) {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        // a stage's first use waits for nothing (the phase before 0)
        const uint32_t parity = ((t / kStages) & 1) ^ 1;
        mbar_wait(bars + 16 * s + 8, parity);
        mbar_expect_tx(bars + 16 * s, kStageBytes);
        tma_load_3d(sA + s * kABytes, &a_map, bars + 16 * s, t * kBK, m0, 0);
        tma_load_3d(sB + s * kBBytes, &b_map, bars + 16 * s, t * kBK, n0, 0);
      }
    }
    return;
  }

  // ---- consumers: 64 output rows each ----
  const int cw = wg - 1;
  const int tw = threadIdx.x - wg * kWgThreads;
  const int warp = tw >> 5;
  const int lane = tw & 31;
  const int g = lane >> 2;   // accumulator row group
  const int tig = lane & 3;  // thread in group

  // acc[4j + 2i + e] is row 16 * warp + g + 8i, column 8j + 2 tig + e
  uint32_t acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0u;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const uint32_t a_desc = desc_lo(sA + s * kABytes + cw * 64 * kBK, 16);
    const uint32_t b_desc = desc_lo(sB + s * kBBytes, 16);
    mbar_wait(bars + 16 * s, (t / kStages) & 1);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      wgmma_s8_n256(acc, a_desc + ((kk * 32) >> 4), b_desc + ((kk * 32) >> 4),
                    t > 0 || kk > 0);
    wgmma_commit();
    // the previous tile's group has completed: release its stage
    wgmma_wait<1>();
    fence_acc(acc);
    if (t > 0 && lane == 0) mbar_arrive(bars + 16 * ((t - 1) % kStages) + 8);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  const int row0 = m0 + cw * 64 + warp * 16 + g;
  float row_scale[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    row_scale[i] = 0.f;
    if constexpr (!std::is_same_v<OutT, int32_t>) {
      if (row < M) row_scale[i] = sx[row];
    }
  }
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * tig;
    if (n >= N) continue;  // N % 8 == 0: n + 1 < N where n < N
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= M) continue;
      OutT* dst = out + static_cast<size_t>(row) * N + n;
      const int a0 = static_cast<int>(acc[4 * j + 2 * i]);
      const int a1 = static_cast<int>(acc[4 * j + 2 * i + 1]);
      if constexpr (std::is_same_v<OutT, int32_t>) {
        *reinterpret_cast<int2*>(dst) = make_int2(a0, a1);
      } else {
        const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(a0), row_scale[i]),
                                   scale[n]);
        const float v1 = __fmul_rn(__fmul_rn(__int2float_rn(a1), row_scale[i]),
                                   scale[n + 1]);
        store2(dst, v0, v1, bias, n);
      }
    }
  }
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

template <typename OutT>
int launch_gemm(const void* x8, const float* sx, const void* w8,
                const float* scale, const void* bias, void* out, int M, int N,
                int K, cudaStream_t stream) {
  CUtensorMap a_map, b_map;
  if (!encode_i8_rows(&a_map, x8, M, K, kBM) ||
      !encode_i8_rows(&b_map, w8, N, K, kBN))
    return kErrTensorMap;
  const cudaError_t err = allow_smem(int8_gemm_kernel<OutT>, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  int8_gemm_kernel<OutT><<<grid, kThreads, kSmem, stream>>>(
      a_map, b_map, sx, scale, static_cast<const OutT*>(bias),
      static_cast<OutT*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int quantize_rows(const void* x, void* x8, float* sx, int M, int K,
                             int in_dtype, void* stream) {
  if (!aligned16(x) || !aligned16(x8)) return kErrAlignment;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0) return launch_quantize<float>(x, x8, sx, M, K, st);
  if (in_dtype == 1)
    return launch_quantize<__nv_bfloat16>(x, x8, sx, M, K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int int8_gemm_dequant(const void* x8, const float* sx,
                                 const void* w8, const float* scale,
                                 const void* bias, void* out, int M, int N,
                                 int K, int out_dtype, void* stream) {
  if (!aligned16(x8) || !aligned16(w8)) return kErrAlignment;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return launch_gemm<float>(x8, sx, w8, scale, bias, out, M, N, K, st);
  if (out_dtype == 1)
    return launch_gemm<__nv_bfloat16>(x8, sx, w8, scale, bias, out, M, N, K,
                                      st);
  if (out_dtype == 2)
    return launch_gemm<int32_t>(x8, sx, w8, scale, bias, out, M, N, K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
