"""Int8 W8A8 projection: the Hopper kernels' wrappers and their plain
versions.

Replaces `quant_matmul` (f_lite_tpu/quant.py:52), which XLA lowered (no
Pallas kernel): the per-token activation quantization fused into one pass
(`quantize_rows`) and the int8 dot with its dequant in the epilogue
(`int8_gemm_dequant`), both in `csrc/int8_gemm.cu`.

What they compute, for x (M, K) and a weight quantized per output row,
w8 (N, K) int8 and scale (N,) fp32:
- quantize_rows: sx = max|x| / 127 over each row in fp32 (1 where that is
  0), x8 = clip(round(x / sx), -127, 127), rounding half to even;
- quantize_rows_given / row_amax: the same with each row's amax given, and
  the amax alone: a row-parallel layer under tensor parallelism holds K / tp
  of each row, takes the ranks' maximum of its `row_amax` and quantizes
  with it, so sx is the whole row's, as under JAX's SPMD;
- int8_gemm_dequant: acc = x8 @ w8^T in int32, then
  y = ((float(acc) * sx[:, None]) * scale).to(out_dtype), then
  y + bias.to(out_dtype) in out_dtype: the order of `quant_matmul` and
  `QuantDense` (f_lite_tpu/models/dit.py:155-160).
The kernels compute exactly that arithmetic: their outputs equal the plain
versions' bit for bit.

Bound on an H100 SXM (1,979 TOP/s int8 dense, 3.35 TB/s): the quantize
pass by bytes (x read, x8 written), the product by int8 operations at the
serving shapes (2*M*N*K).

The product kernel is persistent: it launches min(tiles, SMs) blocks, and
each walks its output tiles in the order of `tile_schedule` (grouped
raster, `tile_coords`), a pure function the CPU tests check. It has two
designs, and `gemm_design` picks one from K: ping-pong 128 x 128 tiles
below COOPERATIVE_MIN_K, a cooperative 128 x 256 tile from it.

On a CPU tensor the wrappers compute the plain versions; on a CUDA tensor
they launch the kernels or raise. The plain product is exact int32 on the
CPU and float64 on the card (exact while 127^2 * K < 2^53; CUDA has no
integer matmul). `QUANTIZE_LAUNCHES` (every entry of the quantize kernel)
and `GEMM_LAUNCHES` count kernel launches (counters of `utils/trace.py`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from f_lite_tpu_torch.ops.cuda.build import load
from f_lite_tpu_torch.utils.trace import counter

QUANTIZE_LAUNCHES = counter("int8_quantize")  # quantize_rows, _given, row_amax
GEMM_LAUNCHES = counter("int8_gemm")          # int8_gemm_dequant (and its int32 mode)

_IN_CODES = {torch.float32: 0, torch.bfloat16: 1}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
# the product kernel's designs (`design` of its C entry) and their tile
# widths (kBN of `Design` in csrc/int8_gemm.cu); its tile rows and raster
# group in m-tiles (kBM, kGroupM)
PINGPONG, COOPERATIVE = 0, 1
BLOCK_N = {PINGPONG: 128, COOPERATIVE: 256}
BLOCK_M, GROUP_M = 128, 8
# K from which the cooperative tile is faster (`tools/int8_tiles.py
# --k-sweep` on an H100: ping-pong leads at K 2560, the cooperative tile at
# 5120; the times cross near 3500)
COOPERATIVE_MIN_K = 4096
# the kernels' own error codes (kErr* in csrc/int8_gemm.cu); any other
# non-zero code is a cudaError_t
LAUNCH_ERRORS = {
    10001: "tensor map encode failed (cuTensorMapEncodeTiled)",
    10003: "x, x8, w8 or the output not 16-byte aligned",
}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def quantize_rows_plain(x: torch.Tensor):
    """(x8 int8, sx fp32): dynamic per-row int8 quantization of x (..., K),
    computed in fp32 with true division (`quant_matmul`'s first half). The
    divisor 127 is a tensor: on the card PyTorch divides by a Python
    scalar as a product with its reciprocal, which is not always the
    correctly rounded quotient that JAX and the kernel compute."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    sx = amax / torch.full_like(amax, 127.0)
    sx = torch.where(sx == 0, torch.ones_like(sx), sx)
    x8 = torch.clamp(torch.round(xf / sx[..., None]), -127, 127)
    return x8.to(torch.int8), sx


def row_amax_plain(x: torch.Tensor) -> torch.Tensor:
    """amax (...,) fp32: max |x| over x's last dim."""
    return x.float().abs().amax(dim=-1)


def quantize_rows_given_plain(x: torch.Tensor, amax: torch.Tensor):
    """`quantize_rows_plain` with each row's amax given (its arithmetic
    from the amax on): (x8 int8, sx fp32)."""
    amax = amax.float()
    sx = amax / torch.full_like(amax, 127.0)
    sx = torch.where(sx == 0, torch.ones_like(sx), sx)
    x8 = torch.clamp(torch.round(x.float() / sx[..., None]), -127, 127)
    return x8.to(torch.int8), sx


def int8_matmul_plain(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """acc = x8 (M, K) @ w8 (N, K)^T in int32, exact: integer on the CPU,
    float64 on the card."""
    if x8.device.type == "cpu":
        return x8.int() @ w8.int().T
    return (x8.double() @ w8.double().T).to(torch.int32)


def int8_linear_plain(x8, sx, w8, scale, bias=None, out_dtype=torch.bfloat16):
    """y = ((float(x8 @ w8^T) * sx) * scale).to(out_dtype) (+ bias in
    out_dtype), for x8 (M, K), sx (M,), w8 (N, K), scale (N,)."""
    acc = int8_matmul_plain(x8, w8)
    y = ((acc.float() * sx.float()[:, None]) * scale.float()).to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)
    return y


# ---------------------------------------------------------------------------
# the product kernel's tile order
# ---------------------------------------------------------------------------

def gemm_design(k: int) -> int:
    """The product kernel's design for depth K: PINGPONG or COOPERATIVE."""
    return COOPERATIVE if k >= COOPERATIVE_MIN_K else PINGPONG


def tile_coords(u: int, tiles_m: int, tiles_n: int, group: int = GROUP_M):
    """(m-tile, n-tile) of linear work index u over a tiles_m x tiles_n
    grid: groups of `group` m-tiles (the last group may be shorter), the
    m-tiles fastest inside a group, so that the blocks that run at one time
    share the weight's n-tiles in L2. The kernel's `tile_coords` computes
    the same."""
    per_group = group * tiles_n
    g, r = divmod(u, per_group)
    first = g * group
    size = min(tiles_m - first, group)
    return first + r % size, r // size


def tile_schedule(m: int, n: int, num_sms: int, block_n: int):
    """The output tiles [(m-tile, n-tile), ...] that each block of the
    persistent product kernel computes, in its order, for tiles of BLOCK_M
    x `block_n`: the grid has min(tiles, num_sms) blocks, block b taking
    the tiles b, b + blocks, ... of the grouped raster order
    (`tile_coords`)."""
    tiles_m, tiles_n = -(-m // BLOCK_M), -(-n // block_n)
    tiles = tiles_m * tiles_n
    blocks = min(tiles, num_sms)
    return [[tile_coords(u, tiles_m, tiles_n) for u in range(b, tiles, blocks)]
            for b in range(blocks)]


@functools.cache
def num_sms(index: int) -> int:
    """The SM count of CUDA device `index` (the persistent grid's size)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


# ---------------------------------------------------------------------------
# kernel launches (CUDA tensors)
# ---------------------------------------------------------------------------

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _entry(fn_name: str, n_ptrs: int, n_ints: int):
    """A C entry point `fn(<n_ptrs pointers>, <n_ints ints>, stream)` of
    csrc/int8_gemm.cu (builds the library on first use)."""
    fn = getattr(load("int8_gemm"), fn_name)
    fn.restype = _INT
    fn.argtypes = [_PTR] * n_ptrs + [_INT] * n_ints + [_PTR]
    return fn


def _call(fn_name, ptrs, ints, device):
    fn = _entry(fn_name, len(ptrs), len(ints))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*ptrs, *ints, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: "
                           f"{LAUNCH_ERRORS.get(err, f'CUDA error {err}')}")


def _check_matrix(name, t, dtypes, device=None):
    if t.ndim != 2:
        raise ValueError(f"int8_gemm: {name} must be 2-D, got {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"int8_gemm: {name} is {t.dtype}; the kernel takes "
                        f"{', '.join(map(str, dtypes))}")
    if not t.is_contiguous():
        raise ValueError(f"int8_gemm: {name} must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"int8_gemm: {name} on {t.device}, expected {device}")
    if t.data_ptr() % 16:
        raise ValueError(f"int8_gemm: {name} is not 16-byte aligned (TMA)")


def _check_k(k: int) -> None:
    if k == 0 or k % 16:
        raise ValueError(f"int8_gemm: K = {k}; the kernels take a positive "
                         "multiple of 16")


def quantize_rows(x: torch.Tensor):
    """(x8 (M, K) int8, sx (M,) fp32) of x (M, K): `quantize_rows_plain` on
    the CPU; on the card the quantize kernel, which takes contiguous,
    16-byte aligned bf16 or fp32 x with K a multiple of 16."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"int8_gemm: unsupported device {x.device}")
    _check_matrix("x", x, tuple(_IN_CODES))
    m, k = x.shape
    _check_k(k)
    if m == 0:
        raise ValueError("int8_gemm: x has no rows")
    x8 = torch.empty((m, k), device=x.device, dtype=torch.int8)
    sx = torch.empty((m,), device=x.device, dtype=torch.float32)
    _call("quantize_rows", (x.data_ptr(), x8.data_ptr(), sx.data_ptr()),
          (m, k, _IN_CODES[x.dtype]), x.device)
    QUANTIZE_LAUNCHES.count += 1
    return x8, sx


def _check_rows(x):
    """(M, K) of a CUDA x the quantize kernel takes."""
    if x.device.type != "cuda":
        raise ValueError(f"int8_gemm: unsupported device {x.device}")
    _check_matrix("x", x, tuple(_IN_CODES))
    m, k = x.shape
    _check_k(k)
    if m == 0:
        raise ValueError("int8_gemm: x has no rows")
    return m, k


def quantize_rows_given(x: torch.Tensor, amax: torch.Tensor):
    """(x8 (M, K) int8, sx (M,) fp32) of x (M, K) quantized with each row's
    amax given (amax (M,) fp32): `quantize_rows_given_plain` on the CPU,
    the quantize kernel's given-amax entry on the card. Fed
    `row_amax(x)`, it equals `quantize_rows(x)` bit for bit."""
    if x.device.type == "cpu":
        return quantize_rows_given_plain(x, amax)
    m, k = _check_rows(x)
    if amax.shape != (m,) or amax.dtype != torch.float32 \
            or amax.device != x.device or not amax.is_contiguous():
        raise ValueError(f"int8_gemm: amax must be contiguous ({m},) float32 on "
                         f"{x.device}, got {tuple(amax.shape)} {amax.dtype}")
    x8 = torch.empty((m, k), device=x.device, dtype=torch.int8)
    sx = torch.empty((m,), device=x.device, dtype=torch.float32)
    _call("quantize_rows_given",
          (x.data_ptr(), amax.data_ptr(), x8.data_ptr(), sx.data_ptr()),
          (m, k, _IN_CODES[x.dtype]), x.device)
    QUANTIZE_LAUNCHES.count += 1
    return x8, sx


def row_amax(x: torch.Tensor) -> torch.Tensor:
    """amax (M,) fp32 = max |x| over each row of x (M, K): `row_amax_plain`
    on the CPU, the quantize kernel's amax entry on the card."""
    if x.device.type == "cpu":
        return row_amax_plain(x)
    m, k = _check_rows(x)
    amax = torch.empty((m,), device=x.device, dtype=torch.float32)
    _call("row_amax", (x.data_ptr(), amax.data_ptr()), (m, k, _IN_CODES[x.dtype]),
          x.device)
    QUANTIZE_LAUNCHES.count += 1
    return amax


def _gemm(x8, sx, w8, scale, bias, out_dtype):
    """Launch the product kernel with output type `out_dtype` (fp32, bf16,
    or int32 for the accumulators) on checked CUDA tensors."""
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"int8_gemm: output dtype {out_dtype}; the kernel "
                        "writes float32, bfloat16 or the int32 accumulators")
    _check_matrix("x8", x8, (torch.int8,))
    _check_matrix("w8", w8, (torch.int8,), x8.device)
    (m, k), (n, kw) = x8.shape, w8.shape
    if kw != k:
        raise ValueError(f"int8_gemm: x8 {tuple(x8.shape)} and w8 "
                         f"{tuple(w8.shape)} differ in K")
    _check_k(k)
    if m == 0 or n == 0 or n % 8:
        raise ValueError(f"int8_gemm: M = {m}, N = {n}; the kernel takes "
                         "M > 0 and N a positive multiple of 8")
    vectors = {"sx": (sx, m), "scale": (scale, n)}
    if bias is not None:
        bias = bias.to(out_dtype).contiguous()
        vectors["bias"] = (bias, n)
    for name, (v, size) in vectors.items():
        want = out_dtype if name == "bias" else torch.float32
        if v.shape != (size,) or v.dtype != want or v.device != x8.device:
            raise ValueError(f"int8_gemm: {name} must be ({size},) {want} on "
                             f"{x8.device}, got {tuple(v.shape)} {v.dtype} "
                             f"on {v.device}")
        if not v.is_contiguous():
            raise ValueError(f"int8_gemm: {name} must be contiguous")
    out = torch.empty((m, n), device=x8.device, dtype=out_dtype)
    _call("int8_gemm_dequant",
          (x8.data_ptr(), sx.data_ptr(), w8.data_ptr(), scale.data_ptr(),
           None if bias is None else bias.data_ptr(), out.data_ptr()),
          (m, n, k, _OUT_CODES[out_dtype], num_sms(out.device.index),
           gemm_design(k)), x8.device)
    GEMM_LAUNCHES.count += 1
    return out


def int8_gemm_dequant(x8, sx, w8, scale, bias=None, out_dtype=torch.bfloat16):
    """y (M, N) in out_dtype (fp32 or bf16): `int8_linear_plain` on the CPU;
    on the card the product kernel with the dequant (and the bias) in its
    epilogue."""
    if x8.device.type == "cpu":
        return int8_linear_plain(x8, sx, w8, scale, bias, out_dtype)
    if x8.device.type != "cuda":
        raise ValueError(f"int8_gemm: unsupported device {x8.device}")
    if out_dtype == torch.int32:
        raise TypeError("int8_gemm_dequant: out_dtype int32 is "
                        "`int8_gemm_int32`'s")
    return _gemm(x8, sx, w8, scale, bias, out_dtype)


def int8_gemm_int32(x8, w8):
    """The int32 accumulators x8 @ w8^T (tests): `int8_matmul_plain` on the
    CPU, the product kernel's int32 mode on the card."""
    if x8.device.type == "cpu":
        return int8_matmul_plain(x8, w8)
    m, n = x8.shape[0], w8.shape[0]
    ones = torch.ones((max(m, n),), device=x8.device, dtype=torch.float32)
    return _gemm(x8, ones[:m], w8, ones[:n], None, torch.int32)
