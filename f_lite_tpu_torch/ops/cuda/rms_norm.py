"""RMSNorm, forward and backward: the Hopper kernel's wrappers.

Replaces no TPU kernel: XLA fused the JAX package's plain `rms_norm`
(f_lite_tpu/ops/norms.py) on the TPU, and `csrc/rms_norm.cu` is that one
pass over the rows on the card. Its plain twins are in `ops/norms.py`:
`rms_norm_plain` (the forward, the CPU path) and `rms_norm_bwd_plain` (the
backward formula, for the tests).

What it computes, for x (..., D) bf16 or fp32 and an optional weight (D,)
fp32 or bf16: r = rsqrt(mean(x^2) + eps) a row and y = (x * r) * w in fp32,
rounded once to x's type; the backward dx = r * (g w - xh mean(g w xh)) with
xh = x r, and dw = sum over rows of g xh, summed in a fixed order (no
atomics: it repeats bit for bit). dx comes back in x's type, dw in w's.

Layouts (`kernel_input`): a dense x whose last stride is 1 (a transposed
view such as the cross-attention's q) is taken as it lies in memory, and
y is `torch.empty_like(x)`, with x's strides, as the plain path's; the
backward brings the upstream gradient into x's layout. Any other x (the
cross-attention's k, a slice of the key-value product; the head's tokens
without the registers) is made contiguous first, and y with it: the
attention takes its k contiguous anyway.

Bound on an H100 SXM (3.35 TB/s): bytes, 2 N sizeof(x) a forward, 3 N
sizeof(x) a backward. On a CUDA tensor `rms_norm` launches the kernels or
raises; no kernel runs on the CPU. `excess` and `bwd_scales` hold a kernel
result to its twin (the card tests and `chip_smoke.py`). `LAUNCHES` counts forward launches
and `BWD_LAUNCHES` backward calls (each the dx kernel and, where the weight
needs a gradient, its sum): counters `rms_norm` and `rms_norm_bwd` of
`utils/trace.py`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from f_lite_tpu_torch.ops.cuda.build import load
from f_lite_tpu_torch.utils.trace import counter

LAUNCHES = counter("rms_norm")          # the forward kernel
BWD_LAUNCHES = counter("rms_norm_bwd")  # backward calls

_X_CODES = {torch.float32: 0, torch.bfloat16: 1}
_W_CODES = {torch.float32: 1, torch.bfloat16: 2}  # 0: no weight
_MAX_ROWS = 2**31 - 1

_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _entry(name: str):
    """A C entry point of csrc/rms_norm.cu (builds the library on first
    use), with its argument types."""
    fn = getattr(load("rms_norm"), name)
    fn.restype = _INT
    fn.argtypes = {
        "rms_norm_fwd": [_PTR] * 4 + [_INT] * 4 + [_FLOAT, _PTR],
        "rms_norm_bwd_partial_rows": [_PTR] * 4 + [_INT] * 4,
        "rms_norm_bwd": [_PTR] * 7 + [_INT] * 5 + [_PTR],
    }[name]
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def dense_rows(x: torch.Tensor) -> bool:
    """Whether x's elements fill x.numel() places of memory from
    x.data_ptr(), with its last dim contiguous: then its rows of the last
    dim lie one after another in memory, in some order of the other dims,
    and `torch.empty_like(x)` lays them out the same."""
    if x.dim() == 0 or (x.stride(-1) != 1 and x.shape[-1] != 1):
        return False
    expected = 1
    for stride, size in sorted((st, s) for s, st in zip(x.shape, x.stride()) if s != 1):
        if stride != expected:
            return False
        expected *= size
    return True


def kernel_input(x: torch.Tensor) -> torch.Tensor:
    """x as the kernel reads it, its rows one after another from its data
    pointer: x itself where they lie so (`dense_rows`), else a contiguous
    copy."""
    return x if dense_rows(x) else x.contiguous()


def _like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """t in ref's memory layout (ref dense, t of ref's shape): t itself
    where it already is, else a copy into `torch.empty_like(ref)`."""
    same = dense_rows(t) and all(
        a == b for a, b, s in zip(t.stride(), ref.stride(), ref.shape) if s != 1)
    return t if same else torch.empty_like(ref).copy_(t)


def _check(x: torch.Tensor, weight: torch.Tensor | None) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm: the kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in _X_CODES:
        raise TypeError(f"rms_norm: x is {x.dtype}; the kernel takes float32 or bfloat16")
    if x.numel() // max(x.shape[-1], 1) > _MAX_ROWS:
        raise ValueError(f"rms_norm: more than {_MAX_ROWS} rows")
    if weight is None:
        return
    if weight.dtype not in _W_CODES:
        raise TypeError(f"rms_norm: the weight is {weight.dtype}; the kernel takes "
                        "float32 or bfloat16")
    if weight.shape != x.shape[-1:]:
        raise ValueError(f"rms_norm: weight {tuple(weight.shape)} for rows of "
                         f"{x.shape[-1]}")
    if weight.device != x.device:
        raise ValueError(f"rms_norm: weight on {weight.device}, x on {x.device}")


def _call(name, args, device):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _entry(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def rms_norm_fwd(x: torch.Tensor, weight: torch.Tensor | None = None, *,
                 eps: float = 1e-6, with_rstd: bool = False):
    """(y, r): y = rms_norm(x, weight) in x's type, laid out as
    `kernel_input(x)`, r (rows,) fp32 the rows' rsqrt(mean(x^2) + eps) in
    the kernel's order of rows, or None without `with_rstd`. CUDA tensors
    only."""
    _check(x, weight)
    x = kernel_input(x)
    w = None if weight is None else weight.contiguous()
    y = torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    rstd = (torch.empty(rows, device=x.device, dtype=torch.float32)
            if with_rstd else None)
    if rows == 0:
        return y, rstd
    _call("rms_norm_fwd",
          (_ptr(x), _ptr(w), _ptr(y), _ptr(rstd), rows, d, _X_CODES[x.dtype],
           0 if w is None else _W_CODES[w.dtype], float(eps)), x.device)
    LAUNCHES.count += 1
    return y, rstd


def rms_norm_bwd(x: torch.Tensor, weight: torch.Tensor | None,
                 rstd: torch.Tensor, g: torch.Tensor, *, needs_dx: bool = True,
                 needs_dw: bool = True):
    """(dx, dw) of y = rms_norm(x, weight) for the upstream gradient g, from
    the forward's r: dx in x's type, laid out as the forward's y (None
    without `needs_dx`), dw in the weight's type (None without a weight or
    `needs_dw`). x as the forward was given it; CUDA tensors only."""
    _check(x, weight)
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"rms_norm_bwd: g {tuple(g.shape)} {g.dtype} does not "
                         f"match x {tuple(x.shape)} {x.dtype}")
    x = kernel_input(x)
    g = _like(g, x)
    w = None if weight is None else weight.contiguous()
    needs_dw = needs_dw and w is not None
    dx = torch.empty_like(x) if needs_dx else None
    dw = torch.empty_like(w) if needs_dw else None
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows == 0:
        if dw is not None:
            dw.zero_()
        return dx, dw
    codes = (_X_CODES[x.dtype], 0 if w is None else _W_CODES[w.dtype])
    part, part_rows = None, 0
    if needs_dw:
        with torch.cuda.device(x.device):
            part_rows = _entry("rms_norm_bwd_partial_rows")(
                _ptr(x), _ptr(g), _ptr(w), _ptr(dx), rows, d, *codes)
        if part_rows <= 0:
            raise RuntimeError(f"rms_norm_bwd: CUDA error {-part_rows}")
        part = torch.empty((part_rows, d), device=x.device, dtype=torch.float32)
    _call("rms_norm_bwd",
          (_ptr(x), _ptr(g), _ptr(w), _ptr(rstd), _ptr(dx), _ptr(part), _ptr(dw),
           rows, d, part_rows, *codes), x.device)
    BWD_LAUNCHES.count += 1
    return dx, dw


def excess(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor) -> float:
    """How far a kernel result `got` lies beyond its bound from its plain
    twin `want` (both in one dtype; 0 or less: within). They compute the
    same fp32 formula and round once, and differ only in the order of the
    row's (or the rows') sums. fp32: 1e-5 of `scale`, the size of the terms
    the value is made of (|want| itself where nothing cancels): a few fp32
    ulps of the terms plus the sums' reordering (about sqrt(n) 2^-24 of
    them) lie far below. bf16: one bf16 ulp of the larger of the two values
    (two fp32 values that close round to neighbouring bf16 values at most),
    plus 2^-16 of `scale` for the fp32 difference before the rounding,
    which matters only where the terms cancel."""
    if got.dtype == torch.float32:
        bound = 1e-5 * scale
    else:
        top = torch.maximum(got.float().abs(), want.float().abs())
        _, e = torch.frexp(top.clamp_min(torch.finfo(torch.bfloat16).tiny))
        bound = torch.ldexp(torch.ones_like(top), e - 8) + 2**-16 * scale
    return float(((got.detach().float() - want.float()).abs() - bound).max())


def bwd_scales(x: torch.Tensor, weight: torch.Tensor | None, g: torch.Tensor):
    """`excess`'s scales for dx and dw (None without a weight): the sizes
    of the terms each is made of, r (|g w| + |xh| mean|g w xh|) and the
    sum over rows of |g xh|."""
    x32, g32 = x.float(), g.float()
    r = torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + 1e-6)
    xh = x32 * r
    gw = g32 if weight is None else g32 * weight.float()
    dx = r * (gw.abs() + xh.abs() * (gw * xh).abs().mean(-1, keepdim=True))
    dw = None if weight is None else (g32 * xh).abs().reshape(-1, x.shape[-1]).sum(0)
    return dx, dw


class _RMSNorm(torch.autograd.Function):
    """Differentiable RMSNorm on the kernels: the forward saves x as the
    kernel read it (x itself, or the copy `kernel_input` made) and r; the
    backward launches the backward kernel."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        x = kernel_input(x)
        y, rstd = rms_norm_fwd(x, weight, eps=eps, with_rstd=True)
        ctx.save_for_backward(x, weight, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, rstd = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, rstd, g, needs_dx=ctx.needs_input_grad[0],
                              needs_dw=ctx.needs_input_grad[1])
        return dx, dw, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None = None, *,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS-normalise x's last dim on the card, scaled by `weight` where one
    is given. Where a gradient is needed (grad mode on and x or the weight
    requiring one) the call goes through `_RMSNorm`, which keeps r for the
    backward kernel; otherwise the forward runs alone."""
    if torch.is_grad_enabled() and (
            x.requires_grad or (weight is not None and weight.requires_grad)):
        return _RMSNorm.apply(x, weight, float(eps))
    return rms_norm_fwd(x, weight, eps=eps)[0]
