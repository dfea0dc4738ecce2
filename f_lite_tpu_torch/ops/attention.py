"""Multi-head attention (counterpart of `f_lite_tpu/ops/attention.py`).

Layout: q (B, H, Lq, D); k, v (B, H, Lk, D); kv_mask (B, Lk) bool, True =
real key. Softmax statistics are fp32 on every path.

`attention()` takes a prefix-form (right-padded) mask, turns it into
per-batch key counts and calls the flash-attention wrapper: on a CUDA
tensor that launches the Hopper kernel, on a CPU tensor it computes the
kernel's plain version. Arbitrary masks go through `compact_context` first:
attention is invariant to a permutation of its key/value pairs, so moving
the real tokens to the front is exact.
"""

from __future__ import annotations

import torch

from f_lite_tpu_torch.ops.cuda.flash_attention import flash_attention

_NEG_INF = -1e30


def attention_plain(q, k, v, *, kv_mask=None, scale=None):
    """Masked attention with fp32 softmax, any mask (the counterpart of
    `attention_xla`). A row whose keys are all masked averages every value,
    as `attention_xla` does."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if kv_mask is not None:
        logits = torch.where(kv_mask[:, None, None, :], logits,
                             logits.new_tensor(_NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(q.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def compact_context(context: torch.Tensor, mask: torch.Tensor):
    """Stably permute real tokens to the front: any mask -> prefix form.

    context (B, S, C); mask (B, S) bool. Right-padded masks reduce to the
    identity permutation."""
    order = torch.argsort((~mask).to(torch.int8), dim=-1, stable=True)
    context = torch.take_along_dim(context, order[..., None], dim=1)
    mask = torch.take_along_dim(mask, order, dim=-1)
    return context, mask


def attention(q, k, v, *, kv_mask=None, scale=None):
    """Flash attention with a prefix-form `kv_mask` (see module docstring)."""
    kv_lens = None if kv_mask is None else kv_mask.sum(-1, dtype=torch.int32)
    return flash_attention(q, k, v, kv_lens, scale=scale)
