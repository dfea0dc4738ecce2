"""RMS normalisation (counterpart of `f_lite_tpu/ops/norms.py`).

Statistics in fp32 with eps 1e-6, result cast back to the input dtype. On
the card `rms_norm` runs the hand-written kernel (`ops/cuda/rms_norm.py`,
`csrc/rms_norm.cu`), forward and backward; on the CPU its plain twin
`rms_norm_plain` under autograd.
"""

from __future__ import annotations

import torch

from f_lite_tpu_torch.ops.cuda import rms_norm as cuda_rms_norm
from f_lite_tpu_torch.utils.trace import span


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor | None = None, *,
                   eps: float = 1e-6) -> torch.Tensor:
    """RMS-normalise the last axis in fp32, optionally scaling by `weight`:
    r = rsqrt(mean(x^2) + eps), y = (x r) w, rounded once to x's dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


def rms_norm_bwd_plain(x: torch.Tensor, weight: torch.Tensor | None,
                       g: torch.Tensor, *, eps: float = 1e-6):
    """(dx, dw) of `rms_norm_plain(x, weight)` for the upstream gradient g,
    by the backward kernel's formula in fp32 (float64 stays float64): with
    xh = x r, dx = r (g w - xh mean(g w xh)) in x's dtype and dw = the sum
    over rows of g xh in the weight's dtype (None without a weight)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    x32, g32 = x.to(acc), g.to(acc)
    r = torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps)
    xh = x32 * r
    gw = g32 if weight is None else g32 * weight.to(acc)
    dx = r * (gw - xh * (gw * xh).mean(-1, keepdim=True))
    dw = None
    if weight is not None:
        dw = (g32 * xh).reshape(-1, x.shape[-1]).sum(0).to(weight.dtype)
    return dx.to(x.dtype), dw


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None = None, *,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS-normalise the last axis in fp32, optionally scaling by `weight`
    (span `op.rms_norm`): `rms_norm_plain` on a CPU tensor, the kernel on a
    CUDA tensor (any other device raises)."""
    with span("op.rms_norm"):
        if x.device.type == "cpu":
            return rms_norm_plain(x, weight, eps=eps)
        return cuda_rms_norm.rms_norm(x, weight, eps=eps)


def qk_norm(q, k, *, q_weight=None, k_weight=None, eps: float = 1e-6):
    """Independently RMS-normalise q and k over head_dim (QK-norm)."""
    return rms_norm(q, q_weight, eps=eps), rms_norm(k, k_weight, eps=eps)
