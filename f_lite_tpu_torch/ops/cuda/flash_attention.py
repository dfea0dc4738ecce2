"""Flash attention, forward and backward: the Hopper kernels' wrappers and
their plain versions.

Replaces the TPU kernels of `f_lite_tpu/ops/pallas/flash_attention.py`:
`_fa_fwd_kernel` (launcher `_flash_forward`), `_dq_kernel` and
`_dkv_kernel` (launcher `_flash_backward`), and their `jax.custom_vjp`
(`_flash_fwd_vjp` / `_flash_bwd_vjp`), which becomes a
`torch.autograd.Function`.

What it computes: O = softmax(scale * Q K^T, keys j >= kv_lens[b] masked) V
for q (B, H, Lq, D) and k, v (B, H, Lk, D), with fp32 softmax statistics,
one division by the row sum at the end, and a zero row where kv_len == 0.
Under grad mode the forward also returns the fp32 row log-sum-exp lse
(B, H, Lq) (LSE_EMPTY where kv_len == 0), and the backward computes
D = rowsum(dO * O) in fp32 once, then dq (dq kernel) and dk, dv (dkv
kernel) from P = exp(scale * Q K^T - lse) recomputed tile by tile.

Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM): 4*B*H*Lq*Lk*D
flops forward, 14*B*H*Lq*Lk*D for the two backward kernels (dq 3 products,
dkv 4), against the bytes of q, k, v, o (and dO, lse, D, dq, dk, dv).
Self-attention at the 7B shapes is operation-bound; cross-attention over
128 padded text keys is byte-bound.

Design: the bf16 kernels are warp-specialised for Hopper: a producer
warpgroup loads tiles by TMA through a ring of mbarrier-guarded stages and
consumer warpgroups run the products on wgmma, with tensor maps encoded at
each launch (so q, k, v and dO must be 16-byte aligned). The forward
(`csrc/flash_attention_fwd.cu`) streams K and V past 128 query rows; the dq
kernel (`csrc/flash_attention_bwd.cu`) does the same for Q and dO, and the
dkv kernel streams Q, dO, lse and delta past resident K and V. Every kernel
visits keys up to kv_len only; fp32 (the parity type) is plain FMA.

The kernels are compiled for head dims 64 (the trained fixture) and 256
(7B/10B). Any other D up to 256 is zero-padded along D to the next of them
(`padded_head_dim`) and the outputs sliced back: zero columns add nothing
to Q K^T (so lse and P are unchanged), nothing to delta = rowsum(dO * O),
and give zero output and gradient columns. The softmax scale comes from the
true D. D > 256 and other dtypes raise. The bf16 backward kernels read lse
and delta with rows padded to a multiple of `STAT_ROWS` (`pad_stat_rows`),
so that each tile of them is one aligned bulk copy.

On a CPU tensor the wrappers compute the plain versions; on a CUDA tensor
they launch the kernels or raise. `LAUNCHES`, `DQ_LAUNCHES` and
`DKV_LAUNCHES` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from f_lite_tpu_torch.ops.cuda.build import load

HEAD_DIMS = (64, 256)  # the compiled instances; other D are padded up
STAT_ROWS = 128  # the bf16 backward's lse / delta rows: a multiple of this
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
FP32_ATOL = 1e-5
BF16_RMS_FRACTION = 0.05
# lse of a row that saw no key: the TPU kernel's running-max start value
# (-0.7 * float32 max) plus log(1)
LSE_EMPTY = -0.7 * float(torch.finfo(torch.float32).max)


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


def grad_tolerance(ref: torch.Tensor, dtype: torch.dtype) -> float:
    """The largest abs error allowed between a backward kernel's gradient in
    `dtype` and the plain version's fp32 gradient `ref` on the same inputs.

    fp32: 1e-5 of the reference's largest magnitude, since each gradient
    sums up to Lq or Lk products in another order. bf16: 5% of the
    reference's rms, as for the forward. The plain version rounds P and dS
    to bf16 where the kernels (and the TPU kernels) do: that rounding alone
    moves a gradient's largest errors to the size of the bar, so the bar
    holds the kernel to the specified arithmetic, not to unrounded fp32."""
    if dtype == torch.float32:
        return FP32_ATOL * float(ref.abs().max())
    return tolerance(ref, dtype)


class LaunchCounter:
    """A plain count of kernel launches, reset by whoever reads it."""

    def __init__(self):
        self.count = 0

    def reset(self) -> None:
        self.count = 0


LAUNCHES = LaunchCounter()      # the forward kernel
DQ_LAUNCHES = LaunchCounter()   # the dq kernel
DKV_LAUNCHES = LaunchCounter()  # the dkv kernel


def padded_head_dim(d: int) -> int:
    """The compiled head dim a D runs at on the card: 64 for D <= 64, 256
    for 64 < D <= 256. Larger D raise ValueError."""
    if not 0 < d <= HEAD_DIMS[-1]:
        raise ValueError(f"flash_attention: head dim {d} not in 1..{HEAD_DIMS[-1]}")
    return next(n for n in HEAD_DIMS if d <= n)


def pad_head_dim(x: torch.Tensor) -> torch.Tensor:
    """x zero-padded along its last dim to `padded_head_dim`, contiguous
    (x itself when it already is)."""
    d = x.shape[-1]
    d_pad = padded_head_dim(d)
    if d != d_pad:
        x = torch.nn.functional.pad(x, (0, d_pad - d))
    return x.contiguous()


def pad_stat_rows(x: torch.Tensor) -> torch.Tensor:
    """An fp32 (B, H, Lq) lse or delta zero-padded to a multiple of
    STAT_ROWS rows, contiguous. The pad rows are never read as real rows:
    their q and dO rows are zero-filled and P is selected to 0 there."""
    pad = -x.shape[-1] % STAT_ROWS
    return torch.nn.functional.pad(x.float(), (0, pad)).contiguous()


def _lengths(kv_lens, b, lk, device):
    if kv_lens is None:
        return None
    lens = torch.as_tensor(kv_lens, device=device)
    if lens.shape != (b,):
        raise ValueError(f"kv_lens must have shape ({b},), got {tuple(lens.shape)}")
    return lens.to(torch.int32).clamp(0, lk).contiguous()


def _key_mask(lens, lk, device):
    """(B, 1, 1, Lk) bool, True at real keys; None when every key is."""
    if lens is None:
        return None
    return (torch.arange(lk, device=device)[None, :] < lens[:, None])[:, None, None, :]


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
        logits = logits.masked_fill(~_key_mask(lens, lk, q.device), float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    if lens is not None:
        # softmax over an all -inf row is NaN; such rows attend nothing
        probs = torch.where((lens > 0)[:, None, None, None], probs, 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
    return out.to(q.dtype)


def flash_attention_lse_plain(q, k, kv_lens=None, *, scale=None):
    """The plain version of the forward's lse output: fp32 (B, H, Lq)
    log-sum-exp of the masked scaled logits, LSE_EMPTY where kv_len == 0."""
    b, _, _, d = q.shape
    lk = k.shape[2]
    if scale is None:
        scale = d**-0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    lens = _lengths(kv_lens, b, lk, q.device)
    if lens is None:
        return torch.logsumexp(logits, dim=-1)
    logits = logits.masked_fill(~_key_mask(lens, lk, q.device), float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    return torch.where((lens > 0)[:, None, None], lse, LSE_EMPTY)


def flash_attention_bwd_plain(q, k, v, dout, lse, delta, kv_lens=None, *,
                              scale=None, out_dtype=None):
    """The plain version of both backward kernels, the same recompute math
    in fp32: P = exp(scale * Q K^T - lse), selected to 0 at masked keys;
    dv = P^T dO; dS = P * (dO V^T - delta); dq = scale * dS K;
    dk = scale * dS^T Q. `delta` (B, H, Lq) is rowsum(dO * O) in fp32.
    As in the kernels and the TPU kernels, P is rounded to dO's dtype
    before P^T dO and dS to q's dtype before the dq and dk products (a no-op
    for fp32 inputs). Returns (dq, dk, dv) in `out_dtype`, else in the
    dtypes of q, k, v."""
    b, _, _, d = q.shape
    lk = k.shape[2]
    if scale is None:
        scale = d**-0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse.float()[..., None])
    lens = _lengths(kv_lens, b, lk, q.device)
    if lens is not None:
        # a select, never a product: exp overflows to inf where lse is
        # LSE_EMPTY (kv_len == 0)
        p = torch.where(_key_mask(lens, lk, q.device), p, 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dout.dtype).float(), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = (p * (dp - delta.float()[..., None])).to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    return (dq.to(out_dtype or q.dtype), dk.to(out_dtype or k.dtype),
            dv.to(out_dtype or v.dtype))


def attention_delta(out, dout):
    """D = rowsum(dO * O) in fp32, (B, H, Lq): computed once outside the
    backward kernels, as `_flash_bwd_vjp` does outside Pallas."""
    return (dout.float() * out.float()).sum(-1)


# ---------------------------------------------------------------------------
# kernel launches (CUDA tensors)
# ---------------------------------------------------------------------------

_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _entry(lib_name: str, fn_name: str, n_ptrs: int):
    """A C entry point `fn(<n_ptrs pointers>, B, H, Lq, Lk, D, scale, dtype,
    stream)` (builds its library on first use)."""
    fn = getattr(load(lib_name), fn_name)
    fn.restype = _INT
    fn.argtypes = [_PTR] * n_ptrs + [_INT] * 5 + [_FLOAT, _INT, _PTR]
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_cuda(q, k, v):
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
    padded_head_dim(d)
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
            "the kernel takes float32 or bfloat16"
        )
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if lq == 0 or lk == 0:
        raise ValueError("flash_attention: empty query or key sequence")


# the kernels' own error codes (kErr* in csrc/flash_attention_fwd.cu and
# csrc/flash_attention_bwd.cu); any other non-zero code is a cudaError_t
LAUNCH_ERRORS = {
    10001: "tensor map encode failed (cuTensorMapEncodeTiled)",
    10002: "the kernel's registers do not fit its warpgroups' split",
    10003: "q, k, v, dO, lse or delta not 16-byte aligned",
}


def _launch(fn_name, lib_name, ptrs, q, k, scale):
    """Launch entry point `fn_name` of `csrc/<lib_name>.cu` on q's stream."""
    b, h, lq, d = q.shape
    fn = _entry(lib_name, fn_name, len(ptrs))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*ptrs, b, h, lq, k.shape[2], d, float(scale),
                 _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: "
                           f"{LAUNCH_ERRORS.get(err, f'CUDA error {err}')}")


def check_aligned(*tensors) -> None:
    """Raise ValueError unless every tensor's data starts 16-byte aligned:
    TMA reads q, k, v (and the backward's dO) from their base addresses. A
    view at an odd storage offset is refused, never copied."""
    for name, t in zip(("q", "k", "v", "dO"), tensors):
        if t.data_ptr() % 16:
            raise ValueError(
                f"flash_attention: {name} at address {t.data_ptr():#x} is not "
                "16-byte aligned (storage offset "
                f"{t.storage_offset()}); TMA needs 16-byte alignment")


def _forward_kernel(q, k, v, lens, scale, with_lse: bool):
    """Launch the forward kernel on contiguous, 16-byte aligned CUDA q, k,
    v, padded along D to a compiled head dim and sliced back: (out, lse or
    None). `scale` is already the true D's."""
    d = q.shape[-1]
    q, k, v = pad_head_dim(q), pad_head_dim(k), pad_head_dim(v)
    check_aligned(q, k, v)
    out = torch.empty_like(q)
    lse = (torch.empty(q.shape[:3], device=q.device, dtype=torch.float32)
           if with_lse else None)
    _launch("flash_attention_fwd", "flash_attention_fwd",
            (_ptr(q), _ptr(k), _ptr(v), _ptr(lens), _ptr(out), _ptr(lse)),
            q, k, scale)
    LAUNCHES.count += 1
    return out[..., :d], lse


def flash_attention_fwd_lse(q, k, v, kv_lens=None, *, scale=None):
    """(out, lse): the forward with its fp32 (B, H, Lq) row log-sum-exp.
    CPU tensors take the plain versions; CUDA tensors launch the forward
    kernel with its lse output."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return (flash_attention_plain(q, k, v, kv_lens, scale=scale),
                flash_attention_lse_plain(q, k, kv_lens, scale=scale))
    _check_cuda(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lens = _lengths(kv_lens, q.shape[0], k.shape[2], q.device)
    return _forward_kernel(q, k, v, lens, scale, with_lse=True)


def _bwd_inputs(q, k, v, dout, lse, delta, kv_lens, scale):
    """Checked, contiguous inputs of the backward kernels (CUDA tensors):
    (q, k, v, dO padded along D to a compiled head dim, lse, delta (in
    bf16 padded to a multiple of STAT_ROWS rows), kv_lens), and the scale,
    from the true D."""
    _check_cuda(q, k, v)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(
            f"flash_attention_bwd: dout {tuple(dout.shape)} {dout.dtype} "
            f"does not match q {tuple(q.shape)} {q.dtype}")
    if lse.shape != q.shape[:3] or delta.shape != q.shape[:3]:
        raise ValueError("flash_attention_bwd: lse and delta must be (B, H, Lq)")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    lens = _lengths(kv_lens, q.shape[0], k.shape[2], q.device)
    q, k, v, dout = (pad_head_dim(x) for x in (q, k, v, dout))
    check_aligned(q, k, v, dout)
    if q.dtype == torch.bfloat16:
        lse, delta = pad_stat_rows(lse), pad_stat_rows(delta)
    else:
        lse, delta = lse.float().contiguous(), delta.float().contiguous()
    return (q, k, v, dout, lse, delta, lens), scale


def _dq_kernel(ins, scale, d):
    dq = torch.empty_like(ins[0])
    _launch("flash_attention_bwd_dq", "flash_attention_bwd",
            tuple(map(_ptr, ins + (dq,))), ins[0], ins[1], scale)
    DQ_LAUNCHES.count += 1
    return dq[..., :d]


def _dkv_kernel(ins, scale, d):
    dk = torch.empty_like(ins[1])
    dv = torch.empty_like(ins[2])
    _launch("flash_attention_bwd_dkv", "flash_attention_bwd",
            tuple(map(_ptr, ins + (dk, dv))), ins[0], ins[1], scale)
    DKV_LAUNCHES.count += 1
    return dk[..., :d], dv[..., :d]


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, kv_lens=None, *,
                           scale=None):
    """dq from the dq kernel (CUDA tensors; see `flash_attention_bwd`)."""
    return _dq_kernel(*_bwd_inputs(q, k, v, dout, lse, delta, kv_lens, scale),
                      q.shape[-1])


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, kv_lens=None, *,
                            scale=None):
    """(dk, dv) from the dkv kernel (CUDA tensors; see
    `flash_attention_bwd`)."""
    return _dkv_kernel(*_bwd_inputs(q, k, v, dout, lse, delta, kv_lens, scale),
                       q.shape[-1])


def flash_attention_bwd(q, k, v, dout, lse, delta, kv_lens=None, *,
                        scale=None):
    """Gradients (dq, dk, dv) of flash attention from the forward's lse and
    delta = rowsum(dO * O). CPU tensors take `flash_attention_bwd_plain`;
    CUDA tensors launch the dq kernel, then the dkv kernel."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, dout, lse, delta, kv_lens,
                                         scale=scale)
    ins, scale = _bwd_inputs(q, k, v, dout, lse, delta, kv_lens, scale)
    return (_dq_kernel(ins, scale, q.shape[-1]),
            *_dkv_kernel(ins, scale, q.shape[-1]))


class _FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the counterpart of the
    `jax.custom_vjp` `_flash_attention`): the forward saves q, k, v,
    kv_lens, O and lse; the backward computes D = rowsum(dO * O) once and
    launches the dq and dkv kernels (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, lens, scale):
        out, lse = flash_attention_fwd_lse(q, k, v, lens, scale=scale)
        ctx.save_for_backward(q, k, v, lens, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lens, out, lse = ctx.saved_tensors
        # dO arrives as a transposed view (out.transpose(1, 2).reshape(...)
        # in the DiT); the kernels take contiguous rows
        dout = dout.contiguous()
        delta = attention_delta(out, dout)
        dq, dk, dv = flash_attention_bwd(q, k, v, dout, lse, delta, lens,
                                         scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, kv_lens=None, *, scale=None):
    """Flash attention. q (B,H,Lq,D); k, v (B,H,Lk,D); kv_lens (B,) ints,
    the number of real keys of each batch row (None: all Lk are real).

    CPU tensors take `flash_attention_plain`. CUDA tensors launch the Hopper
    kernel; q, k and v are made contiguous first (the DiT hands over
    head-transposed views). When a gradient is needed (grad mode on and q,
    k or v requiring one) the call goes through `_FlashAttention`: the
    forward kernel also writes lse, and the backward launches the dq and
    dkv kernels. Otherwise the LSE-free forward runs alone."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    on_cpu = q.device.type == "cpu"
    if not on_cpu:
        _check_cuda(q, k, v)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lens = _lengths(kv_lens, q.shape[0], k.shape[2], q.device)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, lens, float(scale))
    if on_cpu:
        return flash_attention_plain(q, k, v, lens, scale=scale)
    return _forward_kernel(q, k, v, lens, scale, with_lse=False)[0]
