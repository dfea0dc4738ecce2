// RMSNorm, forward and backward, for Hopper (sm_90a), bound to Python with
// ctypes (f_lite_tpu_torch/ops/cuda/rms_norm.py).
//
// Replaces no TPU kernel: the JAX package's `rms_norm`
// (f_lite_tpu/ops/norms.py) is plain jnp, which XLA fused into one pass
// over the rows on the TPU. The port ran it as plain torch ops (upcast,
// square, mean, add eps, rsqrt, product, weight upcast, product, downcast:
// about nine launches and 750 MB of fp32 traffic at the 7B's width);
// these kernels are that one pass. Every norm of the DiT (the pre-norms,
// the QK-norm, the context and head norms) and of the text towers runs
// here on the card.
//
// What they compute, for rows of D values x (bf16 or fp32) and an optional
// weight w (D,) (fp32 or bf16, read as fp32), all arithmetic in fp32:
// - forward: r = rsqrt(sum(x^2) * (1/D) + eps), one a row, and
//   y = (x * r) * w rounded once to x's type: the plain path's arithmetic
//   with the row sum taken in another order. r is written (fp32, one a
//   row) only where the backward will need it;
// - backward: with xh = x * r and gw = g * w,
//   dx = r * (gw - xh * mean(gw * xh)), in x's type. Where the weight needs
//   a gradient, each row group (a warp or a block) also sums g * xh over
//   the rows it visits into its own fp32 row of partial sums, and a second
//   kernel adds those rows in a fixed order into dw, in w's type: no
//   atomics, so dw repeats bit for bit.
//
// Bound: bytes. A forward reads x and writes y, 2 N sizeof(x) (84.2 MB,
// 25 us at 3.35 TB/s, at the 7B's (8224, 2560) bf16); a backward reads x
// and g and writes dx, 3 N sizeof(x), plus the partial sums (4 D bytes a
// row group, written once and read once) where dw is computed. The design
// moves each of those bytes once: a row is read into registers with
// 16-byte loads, reduced there and by warp shuffles, and written from the
// same registers with 16-byte stores. Nothing but the outputs, r and the
// partial sums reaches device memory. Two layouts, chosen from D by the
// launcher (`choose_layout`):
// - up to 128 chunks of 16 bytes (D <= 1024 in bf16, 512 in fp32): one row
//   a warp, eight rows a block of 256 threads (the QK-norm's 256-wide bf16
//   heads: 8 values a lane, one 16-byte load); no shared memory, no
//   barrier;
// - above: one row a block, at most 512 threads and four chunks a thread,
//   at least two in the forward and one in the backward (2560 bf16: 160
//   threads of two chunks in the forward, 320 of one in the backward); the
//   warps' sums meet in shared memory behind one barrier a row. Why
//   (NVIDIA H100 80GB HBM3 at 700 W, CUDA-graph replays over inputs
//   beyond L2, the three in turns): the forward at (8224, 2560) bf16 took
//   37.8, 32.9 and 36.2 us with at least one, two and four chunks a
//   thread (39.0 us with two at D 3072 against 42.5 and 41.0); the
//   backward, which holds x and g, 55.5, 60.7 and 67.9 us.
// Past 2048 chunks (D 16384 in bf16) the rows run one value a thread.
// One block a row group fills the 132 SMs many times over (8,224 blocks at
// the 7B's D 2560; 10,280 at D 256, 82,240 rows). A D that is not a
// multiple of the 16-byte vector, or a pointer that is not 16-byte
// aligned, runs the same kernels one value a thread at a time (VEC 1),
// reading the row a second time, from L1, in place of holding it in
// registers.
//
// Rows are D contiguous values, row r at r * D in x, y, g and dx: the
// wrapper hands over a dense x as it lies in memory (a transposed view
// too: its rows are then in memory order) and copies any other. Entry
// points return cudaGetLastError() after their launches (0 on success); the
// partial-rows query returns a count, or minus a CUDA error. Dtype codes:
// x 0 fp32, 1 bf16; weight 0 none, 1 fp32, 2 bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kWarpBlock = 256;   // threads a block in the warp layout
constexpr int kMaxThreads = 512;  // threads a block, at most
constexpr int kMaxChunks = 4;     // 16-byte chunks a thread, at most
constexpr int kFwdMinChunks = 2;  // in the forward's block layout, at least
constexpr int kBwdMinChunks = 1;  // in the backward's
constexpr int kScalarWarpMaxD = 1024;  // one value a thread: a warp a row up to this D
constexpr int kSumRows = 8;          // partial-sum rows a dw block adds at once

enum WeightMode : int { kNone = 0, kF32 = 1, kBF16 = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N values at p as fp32: 16-byte loads where N fills them, 8-byte loads of
// four bf16, else one value at a time. p is aligned to the load's width.
template <int N>
__device__ __forceinline__ void load(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 a = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = a.x;
      v[4 * i + 1] = a.y;
      v[4 * i + 2] = a.z;
      v[4 * i + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[i];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        v[8 * i + 2 * j] = f.x;
        v[8 * i + 2 * j + 1] = f.y;
      }
    }
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint2 raw = reinterpret_cast<const uint2*>(p)[i];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        v[4 * i + 2 * j] = f.x;
        v[4 * i + 2 * j + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = __bfloat162float(p[i]);
  }
}

// N fp32 values to p in T, rounded to nearest even: 16-byte stores where N
// fills them.
template <int N>
__device__ __forceinline__ void store(float* p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = v[i];
  }
}

template <int N>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[N]) {
  if constexpr (N == 8) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}

// The weight's N values from column `col` as fp32 (1 where there is none).
template <int WM, int N>
__device__ __forceinline__ void load_weight(const void* w, int col, float (&v)[N]) {
  if constexpr (WM == kF32) {
    load(static_cast<const float*>(w) + col, v);
  } else if constexpr (WM == kBF16) {
    load(static_cast<const __nv_bfloat16*>(w) + col, v);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = 1.f;
  }
}

__device__ __forceinline__ float warp_sum(float s) {
  // a butterfly: every lane adds the same pairs, so all end with the same bits
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// The sum of s over the tpr threads of a row: the warp's where tpr is 32,
// else the block's through `red` (a slot a warp), which every thread reads
// in the same order, so that all hold the same bits.
__device__ __forceinline__ float row_sum(float s, int tpr, float* red) {
  s = warp_sum(s);
  if (tpr == 32) return s;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < tpr >> 5; ++i) total += red[i];
  return total;
}

// Rows of D values, `tpr` threads a row (32, or the whole block), blockDim.x
// / tpr rows a block at a time; each thread holds chunks t, t + tpr, ... (at
// most CPT) of VEC values, or, where VEC is 1, values t, t + tpr, ...
// Consecutive reductions alternate between two sets of slots, so a row's
// slots are never written while a slow thread still reads the previous
// row's.
template <typename T, int WM, int VEC, int CPT>
__global__ void __launch_bounds__(kMaxThreads)
    rms_norm_fwd_kernel(const T* __restrict__ x, const void* __restrict__ w,
                        T* __restrict__ y, float* __restrict__ rstd, int rows,
                        int D, int tpr, float eps) {
  __shared__ float red[2][kMaxThreads / 32];
  const int per_block = blockDim.x / tpr;
  const int t = threadIdx.x % tpr;
  const float inv_d = 1.f / static_cast<float>(D);
  int parity = 0;
  for (int64_t row = int64_t(blockIdx.x) * per_block + threadIdx.x / tpr;
       row < rows; row += int64_t(gridDim.x) * per_block, parity ^= 1) {
    const T* xr = x + row * D;
    T* yr = y + row * D;
    float ss = 0.f;
    float v[CPT][VEC];
    if constexpr (VEC == 1) {
      for (int i = t; i < D; i += tpr) {
        const float a = to_float(xr[i]);
        ss += a * a;
      }
    } else {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = (t + c * tpr) * VEC;
        if (col < D) {
          load(xr + col, v[c]);
#pragma unroll
          for (int j = 0; j < VEC; ++j) ss += v[c][j] * v[c][j];
        }
      }
    }
    // mean, then + eps, each rounded, as the plain path's two ops
    const float r = rsqrtf(__fadd_rn(__fmul_rn(row_sum(ss, tpr, red[parity]), inv_d), eps));
    if (rstd != nullptr && t == 0) rstd[row] = r;
    if constexpr (VEC == 1) {
      for (int i = t; i < D; i += tpr) {
        float wi[1];
        load_weight<WM>(w, i, wi);
        const float o[1] = {to_float(xr[i]) * r * wi[0]};
        store(yr + i, o);
      }
    } else {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = (t + c * tpr) * VEC;
        if (col < D) {
          float wv[VEC], o[VEC];
          load_weight<WM>(w, col, wv);
#pragma unroll
          for (int j = 0; j < VEC; ++j) o[j] = v[c][j] * r * wv[j];
          store(yr + col, o);
        }
      }
    }
  }
}

// dx (where dx is not null) and, where `part` is not null, this row
// group's partial sums of g * xh, in row `blockIdx.x * per_block + group`
// of part (D floats a row). Layouts as the forward's.
template <typename T, int WM, int VEC, int CPT>
__global__ void __launch_bounds__(kMaxThreads)
    rms_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        const void* __restrict__ w,
                        const float* __restrict__ rstd, T* __restrict__ dx,
                        float* __restrict__ part, int rows, int D, int tpr) {
  __shared__ float red[2][kMaxThreads / 32];
  const int per_block = blockDim.x / tpr;
  const int t = threadIdx.x % tpr;
  const float inv_d = 1.f / static_cast<float>(D);
  float* pr = part == nullptr
                  ? nullptr
                  : part + (int64_t(blockIdx.x) * per_block + threadIdx.x / tpr) * D;
  float acc[CPT][VEC];
#pragma unroll
  for (int c = 0; c < CPT; ++c)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[c][j] = 0.f;
  if constexpr (VEC == 1) {
    if (pr != nullptr)
      for (int i = t; i < D; i += tpr) pr[i] = 0.f;
  }
  int parity = 0;
  for (int64_t row = int64_t(blockIdx.x) * per_block + threadIdx.x / tpr;
       row < rows; row += int64_t(gridDim.x) * per_block, parity ^= 1) {
    const T* xr = x + row * D;
    const T* gr = g + row * D;
    const float r = rstd[row];
    float dot = 0.f;
    float xh[CPT][VEC], gv[CPT][VEC];
    if constexpr (VEC == 1) {
      for (int i = t; i < D; i += tpr) {
        float wi[1];
        load_weight<WM>(w, i, wi);
        dot += to_float(gr[i]) * wi[0] * (to_float(xr[i]) * r);
      }
    } else {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = (t + c * tpr) * VEC;
        if (col < D) {
          float wv[VEC];
          load(xr + col, xh[c]);
          load(gr + col, gv[c]);
          load_weight<WM>(w, col, wv);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            xh[c][j] *= r;
            dot += gv[c][j] * wv[j] * xh[c][j];
          }
        }
      }
    }
    const float mean = row_sum(dot, tpr, red[parity]) * inv_d;
    if constexpr (VEC == 1) {
      for (int i = t; i < D; i += tpr) {
        float wi[1];
        load_weight<WM>(w, i, wi);
        const float xi = to_float(xr[i]) * r, gi = to_float(gr[i]);
        if (dx != nullptr) {
          const float o[1] = {r * (gi * wi[0] - xi * mean)};
          store(dx + row * D + i, o);
        }
        if (pr != nullptr) pr[i] += gi * xi;
      }
    } else {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = (t + c * tpr) * VEC;
        if (col < D) {
          float wv[VEC], o[VEC];
          load_weight<WM>(w, col, wv);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            o[j] = r * (gv[c][j] * wv[j] - xh[c][j] * mean);
            acc[c][j] += gv[c][j] * xh[c][j];
          }
          if (dx != nullptr) store(dx + row * D + col, o);
        }
      }
    }
  }
  if constexpr (VEC > 1) {
    if (pr != nullptr) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = (t + c * tpr) * VEC;
        if (col < D) store(pr + col, acc[c]);
      }
    }
  }
}

// dw[col] = the sum of part[0..P)[col] in a fixed order: 8 threads a
// column each add every 8th row in turn, then one adds their 8 sums.
template <typename W>
__global__ void __launch_bounds__(32 * kSumRows)
    rms_norm_dw_kernel(const float* __restrict__ part, int P, int D,
                       W* __restrict__ dw) {
  __shared__ float sums[kSumRows][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (col < D) {
#pragma unroll 4
    for (int p = threadIdx.y; p < P; p += kSumRows) s += part[int64_t(p) * D + col];
  }
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < D) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kSumRows; ++i) total += sums[i][threadIdx.x];
    dw[col] = from_float<W>(total);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Layout {
  int vec;      // values a chunk: 16 / sizeof(x), or 1
  int cpt;      // chunks a thread, at most
  int tpr;      // threads a row
  int threads;  // threads a block
};

int round_up(int n, int m) { return (n + m - 1) / m * m; }

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The layout of a row of D values of `elem` bytes; `aligned`: every
// pointer the kernel reads or writes by rows is 16-byte aligned;
// `min_cpt`: chunks a thread at least in the block layout.
Layout choose_layout(int D, int elem, bool aligned, int min_cpt) {
  const int vec = 16 / elem;
  if (aligned && D % vec == 0) {
    const int chunks = D / vec;
    if (chunks <= kMaxChunks * 32) {
      int cpt = 1;
      while (cpt * 32 < chunks) cpt *= 2;
      return {vec, cpt, 32, kWarpBlock};
    }
    for (int cpt = min_cpt; cpt <= kMaxChunks; cpt *= 2) {
      if (chunks <= cpt * kMaxThreads) {
        const int threads = round_up((chunks + cpt - 1) / cpt, 32);
        return {vec, cpt, threads, threads};
      }
    }
  }
  if (D <= kScalarWarpMaxD) return {1, 1, 32, kWarpBlock};
  return {1, 1, kMaxThreads, kMaxThreads};
}

// Calls f.run<T, WM, VEC, CPT>() for the instance of the codes and layout.
template <typename T, int WM, typename F>
int by_layout(const Layout& l, const F& f) {
  constexpr int kVec = 16 / sizeof(T);
  if (l.vec == 1) return f.template run<T, WM, 1, 1>();
  switch (l.cpt) {
    case 1: return f.template run<T, WM, kVec, 1>();
    case 2: return f.template run<T, WM, kVec, 2>();
    case 4: return f.template run<T, WM, kVec, 4>();
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename F>
int by_weight(int w_mode, const Layout& l, const F& f) {
  switch (w_mode) {
    case kNone: return by_layout<T, kNone>(l, f);
    case kF32: return by_layout<T, kF32>(l, f);
    case kBF16: return by_layout<T, kBF16>(l, f);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

bool valid(int x_dtype, int w_mode, int rows, int D) {
  return (x_dtype == 0 || x_dtype == 1) && w_mode >= kNone && w_mode <= kBF16 &&
         rows >= 1 && D >= 1;
}

// f.l set from D and the pointers, then f run for the codes; an unknown
// code or a D or row count out of range is cudaErrorInvalidValue.
template <typename F>
int dispatch(int x_dtype, int w_mode, int rows, int D, int min_cpt,
             std::initializer_list<const void*> ptrs, F& f) {
  if (!valid(x_dtype, w_mode, rows, D)) return static_cast<int>(cudaErrorInvalidValue);
  bool aligned = true;
  for (const void* p : ptrs) aligned = aligned && (p == nullptr || aligned16(p));
  if (x_dtype == 0) {
    f.l = choose_layout(D, sizeof(float), aligned, min_cpt);
    return by_weight<float>(w_mode, f.l, f);
  }
  if (x_dtype == 1) {
    f.l = choose_layout(D, sizeof(__nv_bfloat16), aligned, min_cpt);
    return by_weight<__nv_bfloat16>(w_mode, f.l, f);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int row_groups(int rows, const Layout& l) {
  const int per_block = l.threads / l.tpr;
  return (rows + per_block - 1) / per_block;
}

struct Forward {
  const void* x;
  const void* w;
  void* y;
  float* rstd;
  int rows, D;
  float eps;
  cudaStream_t stream;
  Layout l;

  template <typename T, int WM, int VEC, int CPT>
  int run() const {
    rms_norm_fwd_kernel<T, WM, VEC, CPT><<<row_groups(rows, l), l.threads, 0, stream>>>(
        static_cast<const T*>(x), w, static_cast<T*>(y), rstd, rows, D, l.tpr, eps);
    return static_cast<int>(cudaGetLastError());
  }
};

// The blocks of the backward where it writes partial sums: every row group
// while they fit on the card at once, else as many blocks as the card
// holds at once (each then visits several row groups).
struct PartialBlocks {
  int rows;
  Layout l;

  template <typename T, int WM, int VEC, int CPT>
  int run() const {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, rms_norm_bwd_kernel<T, WM, VEC, CPT>, l.threads, 0);
    if (err != cudaSuccess) return -static_cast<int>(err);
    const int resident = sms * (per_sm > 0 ? per_sm : 1);
    const int groups = row_groups(rows, l);
    return groups < resident ? groups : resident;
  }
};

struct Backward {
  const void *x, *g, *w;
  const float* rstd;
  void* dx;
  float* part;
  void* dw;
  int rows, D, part_rows;
  cudaStream_t stream;
  Layout l;

  template <typename T, int WM, int VEC, int CPT>
  int run() const {
    const int per_block = l.threads / l.tpr;
    if (part != nullptr && (part_rows < per_block || part_rows % per_block))
      return static_cast<int>(cudaErrorInvalidValue);
    const int grid = part != nullptr ? part_rows / per_block : row_groups(rows, l);
    rms_norm_bwd_kernel<T, WM, VEC, CPT><<<grid, l.threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), w, rstd,
        static_cast<T*>(dx), part, rows, D, l.tpr);
    if constexpr (WM != kNone) {
      if (part != nullptr) {
        using W = typename std::conditional<WM == kF32, float, __nv_bfloat16>::type;
        rms_norm_dw_kernel<W><<<(D + 31) / 32, dim3(32, kSumRows), 0, stream>>>(
            part, part_rows, D, static_cast<W*>(dw));
      }
    }
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// y (rows, D) in x's type, and r (rows,) fp32 where rstd is not null, of x
// (rows, D) and the optional weight w (D,).
extern "C" int rms_norm_fwd(const void* x, const void* w, void* y, float* rstd,
                            int rows, int D, int x_dtype, int w_mode, float eps,
                            void* stream) {
  Forward f{x, w, y, rstd, rows, D, eps, static_cast<cudaStream_t>(stream), {}};
  return dispatch(x_dtype, w_mode, rows, D, kFwdMinChunks, {x, y, w}, f);
}

// The rows of partial sums (part, (rows of it, D) fp32) that rms_norm_bwd
// writes for dw with these arguments, or minus a CUDA error.
extern "C" int rms_norm_bwd_partial_rows(const void* x, const void* g,
                                         const void* w, const void* dx,
                                         int rows, int D, int x_dtype,
                                         int w_mode) {
  if (!valid(x_dtype, w_mode, rows, D)) return -static_cast<int>(cudaErrorInvalidValue);
  PartialBlocks f{rows, {}};
  const int blocks = dispatch(x_dtype, w_mode, rows, D, kBwdMinChunks, {x, g, dx, w}, f);
  return blocks < 0 ? blocks : blocks * (f.l.threads / f.l.tpr);
}

// dx (rows, D) in x's type where dx is not null, and, where part is not
// null, dw (D,) in w's type through part (part_rows, D) fp32 scratch
// (part_rows from rms_norm_bwd_partial_rows), of x (rows, D), the upstream
// gradient g (rows, D) in x's type, the weight w (or null) and the
// forward's r.
extern "C" int rms_norm_bwd(const void* x, const void* g, const void* w,
                            const float* rstd, void* dx, float* part, void* dw,
                            int rows, int D, int part_rows, int x_dtype,
                            int w_mode, void* stream) {
  if (part != nullptr && (w == nullptr || dw == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Backward f{x, g, w, rstd, dx, part, dw, rows, D, part_rows,
             static_cast<cudaStream_t>(stream), {}};
  return dispatch(x_dtype, w_mode, rows, D, kBwdMinChunks, {x, g, dx, w}, f);
}
