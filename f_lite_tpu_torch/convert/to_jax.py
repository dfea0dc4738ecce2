"""The port's DiT state dict -> the JAX package's parameters: the inverse of
`convert.from_jax.state_dict_from_jax`.

Output: dot-flattened flax keys exactly as `flax_params.safetensors` stores
them (the layout `FLitePipeline.save_pretrained` writes, unrolled blocks),
as float32 numpy arrays. Layouts:
- Linear weight (out, in)                 -> Dense kernel (in, out);
- fused weight (prod(split)*H*D, in)      -> head-aligned kernel
                                             (in, *split, H, D), bias
                                             (*split, H, D);
- Conv2d weight (D, C, p, p)              -> patch-embed kernel (p*p*C, D),
                                             rows in the patches' (ki, kj, c)
                                             order.
Every step is a transpose or reshape, so the conversion is exact.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _np(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _dense(sd, name, key, out) -> None:
    out[f"{key}.kernel"] = np.ascontiguousarray(_np(sd[f"{name}.weight"]).T)
    if f"{name}.bias" in sd:
        out[f"{key}.bias"] = _np(sd[f"{name}.bias"])


def _head_dense(sd, name, key, split, cfg, out) -> None:
    h, d = cfg.num_heads, cfg.head_dim
    w = _np(sd[f"{name}.weight"])  # (prod(split)*H*D, in)
    out[f"{key}.kernel"] = np.ascontiguousarray(w.T).reshape(
        w.shape[1], *split, h, d)
    if f"{name}.bias" in sd:
        out[f"{key}.bias"] = _np(sd[f"{name}.bias"]).reshape(*split, h, d)


def state_dict_to_jax(sd: Mapping[str, torch.Tensor], cfg) -> dict[str, np.ndarray]:
    """The port's `DiT` state dict -> flat JAX DiT params (unrolled layout,
    float32)."""
    out: dict[str, np.ndarray] = {}
    _dense(sd, "context_proj", "context_proj", out)
    out["context_norm.weight"] = _np(sd["context_norm.weight"])

    w = _np(sd["patch_embed.patch_proj.weight"])  # (D, C, p, p)
    out["patch_proj.kernel"] = np.ascontiguousarray(
        w.transpose(2, 3, 1, 0).reshape(-1, w.shape[0]))
    out["patch_proj.bias"] = _np(sd["patch_embed.patch_proj.bias"])
    out["register_tokens"] = _np(sd["register_tokens"])
    if "positional_embedding" in sd:
        out["positional_embedding"] = _np(sd["positional_embedding"])

    _dense(sd, "time_embed.0", "time_embed.linear_1", out)
    _dense(sd, "time_embed.2", "time_embed.linear_2", out)
    if "adaLN_modulation.1.weight" in sd:
        _dense(sd, "adaLN_modulation.1", "adaLN_modulation.linear", out)

    for i in range(cfg.depth):
        b, j = f"blocks.{i}", f"blocks_{i}"
        out[f"{j}.norm1.weight"] = _np(sd[f"{b}.norm1.weight"])
        out[f"{j}.norm3.weight"] = _np(sd[f"{b}.norm3.weight"])
        _head_dense(sd, f"{b}.self_attn.qkv", f"{j}.self_attn.qkv", (3,), cfg, out)
        _dense(sd, f"{b}.self_attn.proj", f"{j}.self_attn.proj", out)
        if f"{b}.self_attn.lambda_v" in sd:
            out[f"{j}.self_attn.lambda_v"] = _np(sd[f"{b}.self_attn.lambda_v"])
        for name in ("gate_proj", "up_proj", "down_proj"):
            _dense(sd, f"{b}.mlp.{name}", f"{j}.mlp.{name}", out)
        if f"{b}.norm2.weight" in sd:
            out[f"{j}.norm2.weight"] = _np(sd[f"{b}.norm2.weight"])
            _head_dense(sd, f"{b}.cross_attn.q", f"{j}.cross_attn.q", (), cfg, out)
            _head_dense(sd, f"{b}.cross_attn.context_kv",
                        f"{j}.cross_attn.context_kv", (2,), cfg, out)
            _dense(sd, f"{b}.cross_attn.proj", f"{j}.cross_attn.proj", out)
        if f"{b}.adaLN_modulation.1.weight" in sd:
            _dense(sd, f"{b}.adaLN_modulation.1", f"{j}_adaLN.linear", out)

    _dense(sd, "final_modulation.1", "final_modulation.linear", out)
    if "final_norm.weight" in sd:
        out["final_norm.weight"] = _np(sd["final_norm.weight"])
    _dense(sd, "final_proj", "final_proj", out)
    return out
