"""Attention heads zero-padded at load (own copy of `pad_head_params`,
`_head_dense` and `_proj_padded` of `f_lite_tpu/convert/torch_to_jax.py`),
on the port's state dict in the reference key names.

Padding is exact in math (`DiTConfig.padded_heads`): a padded head's q, k
and v rows (and bias) are zero, so its attention output is zero, and its
`proj` input columns are zero, so it adds nothing. In bits it is not: a
`proj` product over K = padded heads x head_dim sums extra zeros, which a
GEMM may split differently. An int8 layer's padded rows quantize to w8 0
and scale 1, as `quantize_weight` gives a zero row.

- fused weight (prod(split) * H * D, in)  -> (prod(split) * Hp * D, in),
  the zero heads appended after each of the split's H heads; its bias
  (prod(split) * H * D) likewise (`qkv`: split 3, `context_kv`: 2, `q`: 1);
- attention out-projection (hidden, H * D) -> (hidden, Hp * D), zero
  input columns appended.
`unpad_head_state` is the inverse, for `save_pretrained`, which writes the
unpadded layout.
"""

from __future__ import annotations

import dataclasses

import torch

_SPLITS = {"qkv": 3, "q": 1, "context_kv": 2}
_ATTENTIONS = ("self_attn", "cross_attn")


def _role(key: str):
    """("heads", split) for a fused projection's tensor, ("proj", None) for
    an attention out-projection's weight, else None."""
    parts = key.split(".")
    if len(parts) < 3 or parts[-3] not in _ATTENTIONS:
        return None
    layer, leaf = parts[-2], parts[-1]
    if layer in _SPLITS and leaf in ("weight", "bias", "w8", "scale"):
        return "heads", _SPLITS[layer]
    if layer == "proj" and leaf in ("weight", "w8"):
        return "proj", None
    return None


def _resize_heads(t: torch.Tensor, split: int, heads: int, to: int, fill: float):
    """t's dim 0, (split, heads, D) flattened, cut or padded to `to` heads
    (padding with `fill`)."""
    d = t.shape[0] // (split * heads)
    rows = t.reshape(split, heads, d, *t.shape[1:])
    if to <= heads:
        return rows[:, :to].reshape(split * to * d, *t.shape[1:])
    pad = rows.new_full((split, to - heads, d, *t.shape[1:]), fill)
    return torch.cat([rows, pad], dim=1).reshape(split * to * d, *t.shape[1:])


def pad_head_state(sd: dict, cfg, pad_to: int) -> dict:
    """The DiT state dict `sd` (at `cfg.compute_heads` heads, float or int8)
    with its attention zero-padded to `pad_to` heads."""
    heads, d = cfg.compute_heads, cfg.head_dim
    if pad_to < heads:
        raise ValueError(f"pad_heads_to {pad_to} < the {heads} heads held")
    out = {}
    for key, t in sd.items():
        role = _role(key)
        if role is None or pad_to == heads:
            out[key] = t
        elif role[0] == "heads":
            out[key] = _resize_heads(t, role[1], heads, pad_to,
                                     1.0 if key.endswith(".scale") else 0.0)
        else:  # proj: zero input columns
            pad = t.new_zeros((t.shape[0], (pad_to - heads) * d))
            out[key] = torch.cat([t, pad], dim=1)
    return out


def unpad_head_state(sd: dict, cfg) -> dict:
    """The inverse of `pad_head_state` for a DiT of `cfg` (padded heads
    sliced off; they must be the zeros of padding)."""
    heads, d = cfg.num_heads, cfg.head_dim
    padded = cfg.compute_heads
    out = {}
    for key, t in sd.items():
        role = _role(key)
        if role is None or padded == heads:
            out[key] = t
            continue
        if role[0] == "heads":
            cut = _resize_heads(t, role[1], padded, heads, 0.0)
            rest = t.reshape(role[1], padded, -1)[:, heads:]
        else:
            cut, rest = t[:, :heads * d], t[:, heads * d:]
        if not key.endswith(".scale") and rest.ne(0).any():
            raise ValueError(f"{key}: padded heads past {heads} are not zero")
        out[key] = cut.contiguous()
    return out


@torch.no_grad()
def pad_dit_heads(dit, pad_to: int):
    """A DiT like `dit` (on its device, in its dtypes, in its mode) whose
    attention computes with `pad_to` heads (`DiTConfig.padded_heads`), the
    padding zero. `dit` is left as it is."""
    from f_lite_tpu_torch.models.dit import DiT

    cfg = dataclasses.replace(dit.config, padded_heads=pad_to)
    state = pad_head_state(dit.state_dict(), dit.config, pad_to)
    with torch.device("meta"):
        padded = DiT(cfg)
    padded.load_state_dict(state, strict=True, assign=True)
    return padded.train(dit.training)
