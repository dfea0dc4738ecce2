"""Flash-attention forward: the Hopper kernel's wrapper and its plain version.

Replaces the TPU kernel `_fa_fwd_kernel` (launcher `_flash_forward`,
wrapper `flash_attention`) in `f_lite_tpu/ops/pallas/flash_attention.py`.

What it computes: O = softmax(scale * Q K^T, keys j >= kv_lens[b] masked) V
for q (B, H, Lq, D) and k, v (B, H, Lk, D), with fp32 softmax statistics,
one division by the row sum at the end, and a zero row where kv_len == 0.

Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM): 4*B*H*Lq*Lk*D
flops against (q + k + v + o) bytes. Self-attention at the 7B serving shape
(B=2 H=10 L=4112 D=256) is operation-bound at 0.35 ms; cross-attention over
128 padded text keys is byte-bound (q and o, about 25 us).

Design (`csrc/flash_attention_fwd.cu`): bf16 runs on the tensor cores with
mma.sync m16n8k16, 64 query rows per block and key tiles of 64 rows
streamed through shared memory with cp.async up to kv_len only; fp32 (the
parity type) is a plain FMA kernel. D is 64 (the trained fixture) or 256
(7B/10B); other head dims and dtypes raise.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises. `LAUNCHES.count` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from f_lite_tpu_torch.ops.cuda.build import load

HEAD_DIMS = (64, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
FP32_ATOL = 1e-5
BF16_RMS_FRACTION = 0.05


def tolerance(ref: torch.Tensor, dtype: torch.dtype) -> float:
    """The largest abs error allowed between the kernel's output in `dtype`
    and the plain version's fp32 result `ref` on the same inputs.

    fp32: the same arithmetic in another summation order. bf16: the kernel
    rounds P and its output to bf16 (2^-9 relative each), so its error
    scales with the output: 5% of the reference's rms. A softmax scale 2%
    off, or one key too many or too few, lands well above it
    (tests/test_torch_flash_attention.py holds it to that)."""
    if dtype == torch.float32:
        return FP32_ATOL
    if dtype == torch.bfloat16:
        return BF16_RMS_FRACTION * float(ref.float().square().mean().sqrt())
    raise TypeError(f"no tolerance for {dtype}")


class LaunchCounter:
    """A plain count of kernel launches, reset by whoever reads it."""

    def __init__(self):
        self.count = 0

    def reset(self) -> None:
        self.count = 0


LAUNCHES = LaunchCounter()


def _lengths(kv_lens, b, lk, device):
    if kv_lens is None:
        return None
    lens = torch.as_tensor(kv_lens, device=device)
    if lens.shape != (b,):
        raise ValueError(f"kv_lens must have shape ({b},), got {tuple(lens.shape)}")
    return lens.to(torch.int32).clamp(0, lk).contiguous()


def flash_attention_plain(q, k, v, kv_lens=None, *, scale=None):
    """The plain PyTorch version: fp32 logits, key mask, softmax, P V, and
    zero rows where kv_len == 0. Output in q's dtype."""
    b, _, _, d = q.shape
    lk = k.shape[2]
    if scale is None:
        scale = d**-0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    lens = _lengths(kv_lens, b, lk, q.device)
    if lens is not None:
        key_ok = torch.arange(lk, device=q.device)[None, :] < lens[:, None]
        logits = logits.masked_fill(~key_ok[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    if lens is not None:
        # softmax over an all -inf row is NaN; such rows attend nothing
        probs = torch.where((lens > 0)[:, None, None, None], probs, 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
    return out.to(q.dtype)


@functools.cache
def _library():
    """The C entry point (builds the kernel on first use)."""
    fn = load("flash_attention_fwd").flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    return fn


def flash_attention(q, k, v, kv_lens=None, *, scale=None):
    """Flash attention. q (B,H,Lq,D); k, v (B,H,Lk,D); kv_lens (B,) ints,
    the number of real keys of each batch row (None: all Lk are real).

    CPU tensors take `flash_attention_plain`. CUDA tensors launch the
    Hopper kernel; q, k and v are made contiguous first (the DiT hands
    over head-transposed views)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_lens, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q, k, v must be (B, H, L, D)")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if k.shape != (b, h, lk, d) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} do not match"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
            "the kernel takes float32 or bfloat16"
        )
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if lq == 0 or lk == 0:
        raise ValueError("flash_attention: empty query or key sequence")
    if scale is None:
        scale = d**-0.5
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lens = _lengths(kv_lens, b, lk, q.device)
    out = torch.empty_like(q)
    fn = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if lens is None else lens.data_ptr(), out.data_ptr(),
            b, h, lq, lk, d, float(scale), _DTYPE_CODES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
    LAUNCHES.count += 1
    return out
