"""RMS normalisation (counterpart of `f_lite_tpu/ops/norms.py`).

Statistics in fp32 with eps 1e-6, result cast back to the input dtype.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None = None, *,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS-normalise the last axis in fp32, optionally scaling by `weight`."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


def qk_norm(q, k, *, q_weight=None, k_weight=None, eps: float = 1e-6):
    """Independently RMS-normalise q and k over head_dim (QK-norm)."""
    return rms_norm(q, q_weight, eps=eps), rms_norm(k, k_weight, eps=eps)
