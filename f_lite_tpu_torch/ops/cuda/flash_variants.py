"""The perf lab's forward variants of flash attention: the Hopper kernel's
wrapper and its plain version.

Replaces the TPU kernel `_kernel` of `tools/flash_variants.py` (launcher
`flash_fwd`): the online-softmax forward over every key (no kv_lens), q
(B, H, Lq, D) and k, v (B, H, Lk, D), in the tool's layout, with four
choices:
- `prescale`: q * scale is rounded to q's dtype outside the kernel, where
  otherwise the kernel scales the fp32 logits;
- `use_exp2`: q * scale * log2(e) likewise, and every exp is exp2 (implies
  `prescale`);
- `condmask`: the key mask runs only on the tile that straddles Lk (same
  result);
- `alpha_bf16`: the rescale factor's argument and result are rounded to
  bf16.
Rounding points of the source, kept by the kernel and the plain version:
the exp argument s - m_next is rounded to bf16 and p to bf16 (exp in fp32
of the rounded argument); p is zero at masked keys; l == 0 gives 1/l = 1.
The result depends on `block_k` (the tile the running max moves by), not on
`block_q`.

The kernel (`csrc/flash_attention_variants.cu`, the serving forward's
TMA + wgmma mainloop with the lab's softmax policy) takes bf16, the block
pairs `blocks(d)` and the flag sets of `VARIANTS`. Any head dim up to 256 runs: q (prescaled first, with
the true D's scale), k and v are zero-padded along D to the next compiled
head dim (64 or 256, `flash_attention.padded_head_dim`) and the output is
sliced back; zero columns change neither Q K^T nor the first D columns of
P V. TMA reads q, k, v from their base addresses, so they must be 16-byte
aligned. On a CUDA tensor anything else raises. On a CPU tensor the
wrapper computes `flash_fwd_plain` at the true D. `LAUNCHES` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from f_lite_tpu_torch.ops.cuda import flash_attention as fa
from f_lite_tpu_torch.ops.cuda.build import load

LOG2E = 1.4426950408889634
# the TPU kernel's running-max start value (-0.7 * float32 max)
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
# the compiled (block_q, block_k) pairs of each compiled head dim: 128
# query rows a block (the mainloop's two consumer warpgroups), and key
# tiles around the serving forward's (80 at D = 256, 32 at D = 64)
BLOCKS = {256: ((128, 48), (128, 64), (128, 80)),
          64: ((128, 32), (128, 64), (128, 128))}
# the serving forward's pair (csrc/flash_attention_fwd.cu)
SERVING_BLOCKS = {256: (128, 80), 64: (128, 32)}
# the lab's rows, as tools/flash_variants.py main() runs them
VARIANTS = {
    "base": dict(),
    "prescale": dict(prescale=True),
    "exp2": dict(prescale=True, use_exp2=True),
    "condmask": dict(prescale=True, use_exp2=True, condmask=True),
    "condmask-e": dict(condmask=True),
    "alphabf16": dict(prescale=True, alpha_bf16=True),
    "all": dict(prescale=True, use_exp2=True, condmask=True, alpha_bf16=True),
}

# (variant, twin): the twin lacks one flag of the variant. condmask changes
# no number and is held to bitwise equality instead; prescale changes none
# at D 64 or 256, whose scale is a power of two (a prescale branch that did
# nothing would scale twice, far outside the kernel-against-plain check)
FLAG_TWINS = (("exp2", "prescale"), ("alphabf16", "prescale"),
              ("all", "condmask"))
# the largest |flag_step - 1| a kernel's flag branch may show
FLAG_STEP_TOLERANCE = 0.25

LAUNCHES = fa.LaunchCounter()


def flag_step(got: torch.Tensor, own: torch.Tensor, twin: torch.Tensor) -> float:
    """How far `got` lies from `twin` towards `own`, two plain results that
    differ by one flag: the least-squares c of got - twin = c (own - twin) +
    noise. 1 when the kernel's branch for that flag rounds as named, 0 when
    it does nothing. Rounding noise that does not follow own - twin averages
    out over the elements, so c resolves a flag whose effect is smaller than
    the tolerance of the kernel-against-plain check."""
    d = (own.double() - twin.double()).flatten()
    dd = float(d @ d)
    if dd == 0.0:
        raise ValueError("flag_step: the two plain results are equal")
    return float((got.double() - twin.double()).flatten() @ d) / dd


def _flags(prescale=False, use_exp2=False, condmask=False, alpha_bf16=False) -> int:
    """The kernel's flag bits (csrc/flash_attention_variants.cu)."""
    prescale = prescale or use_exp2
    return (1 * prescale) | (2 * use_exp2) | (4 * condmask) | (8 * alpha_bf16)


COMPILED_FLAGS = frozenset(_flags(**kw) for kw in VARIANTS.values())


def blocks(d: int) -> tuple:
    """The compiled (block_q, block_k) pairs a head dim `d` runs at on the
    card: those of `padded_head_dim(d)`. D > 256 raises ValueError."""
    return BLOCKS[fa.padded_head_dim(d)]


def prescale_q(q: torch.Tensor, scale: float, use_exp2: bool) -> torch.Tensor:
    """q * scale (* log2 e under exp2) in fp32, rounded to q's dtype: what
    the tool does outside the kernel."""
    return (q.float() * (scale * (LOG2E if use_exp2 else 1.0))).to(q.dtype)


def flash_fwd_plain(q, k, v, *, scale=None, block_k=64, prescale=False,
                    use_exp2=False, condmask=False, alpha_bf16=False,
                    out_dtype=None):
    """The plain version: the kernel's online softmax over key tiles of
    `block_k`, with its rounding points, in fp32 on the inputs' dtype (q is
    prescaled in q's dtype). Output in `out_dtype`, else q's dtype.
    `condmask` masks fewer tiles and gives the same numbers; a ragged last
    tile is sliced, which is the same as the kernel's select (its masked p
    are exactly 0)."""
    del condmask
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if scale is None:
        scale = d**-0.5
    if prescale or use_exp2:
        q = prescale_q(q, scale, use_exp2)
        prescale = True
    exp = torch.exp2 if use_exp2 else torch.exp
    qf = q.float()
    m = torch.full((b, h, lq, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, lq, 1), device=q.device)
    acc = torch.zeros((b, h, lq, d), device=q.device)
    for k0 in range(0, lk, block_k):
        s = qf @ k[:, :, k0:k0 + block_k].float().transpose(-1, -2)
        if not prescale:
            s = s * scale
        m_next = torch.maximum(m, s.amax(-1, keepdim=True))
        p = exp((s - m_next).bfloat16().float()).bfloat16().float()
        if alpha_bf16:
            alpha = exp((m - m_next).bfloat16().float()).bfloat16().float()
        else:
            alpha = exp(m - m_next)
        l = p.sum(-1, keepdim=True) + alpha * l
        acc = acc * alpha + p @ v[:, :, k0:k0 + block_k].float()
        m = m_next
    l_inv = torch.where(l == 0.0, 1.0, 1.0 / l)
    return (acc * l_inv).to(out_dtype or q.dtype)


_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def bind(lib: ctypes.CDLL):
    """The typed entry point `flash_attention_variants(q, k, v, o, B, H, Lq,
    Lk, D, scale, block_q, block_k, flags, stream)` of a loaded library of
    csrc/flash_attention_variants.cu (this checkout's or another's)."""
    fn = lib.flash_attention_variants
    fn.restype = _INT
    fn.argtypes = [_PTR] * 4 + [_INT] * 5 + [_FLOAT] + [_INT] * 3 + [_PTR]
    return fn


@functools.cache
def _entry():
    """This checkout's entry point (builds its library on first use)."""
    return bind(load("flash_attention_variants"))


def _check_cuda(q, k, v, block_q, block_k, flags):
    """Raise unless the kernel takes these arguments: shapes, head dim (up
    to 256), dtype, a block pair of `blocks(d)`, a flag set of the lab's,
    then a CUDA device."""
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError("flash_fwd: q, k, v must be (B, H, L, D)")
    b, h, _, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"flash_fwd: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         "do not match")
    pairs = blocks(d)
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise TypeError(f"flash_fwd: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        "the kernel takes bfloat16")
    if (block_q, block_k) not in pairs:
        raise ValueError(f"flash_fwd: blocks ({block_q}, {block_k}) not in "
                         f"{pairs} (head dim {d})")
    if flags not in COMPILED_FLAGS:
        raise ValueError(f"flash_fwd: flag set {flags} is none of the lab's "
                         f"variants {sorted(VARIANTS)}")
    if q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError("flash_fwd: empty query or key sequence")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("flash_fwd: q, k, v on different devices")
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")


def flash_fwd(q, k, v, *, scale=None, block_q=128, block_k=64, prescale=False,
              use_exp2=False, condmask=False, alpha_bf16=False):
    """The lab's forward (see the module docstring). CPU tensors take
    `flash_fwd_plain`; CUDA tensors launch the Hopper kernel or raise."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    kw = dict(prescale=prescale, use_exp2=use_exp2, condmask=condmask,
              alpha_bf16=alpha_bf16)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale=scale, block_k=block_k, **kw)
    flags = _flags(**kw)
    _check_cuda(q, k, v, block_q, block_k, flags)
    d = q.shape[-1]
    if flags & 1:
        q = prescale_q(q, scale, use_exp2)
    q, k, v = fa.pad_head_dim(q), fa.pad_head_dim(k), fa.pad_head_dim(v)
    fa.check_aligned(q, k, v)
    out = torch.empty_like(q)
    b, h, lq, d_pad = q.shape
    fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
                 lq, k.shape[2], d_pad, float(scale), block_q, block_k, flags,
                 stream)
    if err != 0:
        raise RuntimeError("flash_attention_variants launch failed: "
                           f"{fa.LAUNCH_ERRORS.get(err, f'CUDA error {err}')}")
    LAUNCHES.count += 1
    return out[..., :d]
