"""JAX parameters -> the port's state dicts (own copy of the unrolled-layout
maps in `f_lite_tpu/convert/jax_to_torch.py`, `invert_dit_params` and
`invert_vae_params`).

Input: the dot-flattened keys exactly as `flax_params.safetensors` stores
them (e.g. `blocks_3.self_attn.qkv.kernel`), as numpy arrays. Layouts:
- Dense kernel (in, out)                 -> Linear weight (out, in);
- head-aligned kernel (in, *split, H, D) -> fused weight (prod(split)*H*D, in);
- patch-embed kernel (p*p*C, D)          -> Conv2d weight (D, C, p, p);
- Conv kernel (kh, kw, in, out)          -> Conv2d weight (out, in, kh, kw);
- GroupNorm scale/bias                   -> weight/bias.
Every step is a transpose or reshape, so the conversion is exact.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_SCAN_KEYS = ("blocks_all", "blocks_front", "blocks_rest")


def unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


def _dense(d, name, out) -> None:
    out[f"{name}.weight"] = _t(d["kernel"])
    if "bias" in d:
        out[f"{name}.bias"] = np.asarray(d["bias"])


def _head_dense(d, name, out) -> None:
    k = np.asarray(d["kernel"])  # (in, *split, H, D)
    out[f"{name}.weight"] = _t(k.reshape(k.shape[0], -1))
    if "bias" in d:
        out[f"{name}.bias"] = np.asarray(d["bias"]).reshape(-1)


def _to_torch(sd: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def state_dict_from_jax(flat_params: Mapping[str, np.ndarray],
                        cfg) -> dict[str, torch.Tensor]:
    """Flat JAX DiT params (unrolled layout) -> the port's `DiT` state dict
    (fp32; the caller casts)."""
    p = unflatten(flat_params)
    p = p.get("params", p)
    if any(k in p for k in _SCAN_KEYS):
        raise NotImplementedError(
            "scan-stacked DiT parameters are not supported by the port yet; "
            "save the checkpoint in the unrolled layout"
        )
    sd: dict[str, np.ndarray] = {}
    _dense(p["context_proj"], "context_proj", sd)
    sd["context_norm.weight"] = p["context_norm"]["weight"]

    k = np.asarray(p["patch_proj"]["kernel"])  # (p*p*C, D), (ki, kj, c) order
    ps, d_model = cfg.patch_size, k.shape[-1]
    c = k.shape[0] // (ps * ps)
    sd["patch_embed.patch_proj.weight"] = np.ascontiguousarray(
        k.reshape(ps, ps, c, d_model).transpose(3, 2, 0, 1)
    )
    sd["patch_embed.patch_proj.bias"] = p["patch_proj"]["bias"]
    sd["register_tokens"] = p["register_tokens"]
    if "positional_embedding" in p:
        sd["positional_embedding"] = p["positional_embedding"]

    _dense(p["time_embed"]["linear_1"], "time_embed.0", sd)
    _dense(p["time_embed"]["linear_2"], "time_embed.2", sd)
    if "adaLN_modulation" in p:
        _dense(p["adaLN_modulation"]["linear"], "adaLN_modulation.1", sd)

    for i in range(cfg.depth):
        blk, b = p[f"blocks_{i}"], f"blocks.{i}"
        sd[f"{b}.norm1.weight"] = blk["norm1"]["weight"]
        sd[f"{b}.norm3.weight"] = blk["norm3"]["weight"]
        sa = blk["self_attn"]
        _head_dense(sa["qkv"], f"{b}.self_attn.qkv", sd)
        _dense(sa["proj"], f"{b}.self_attn.proj", sd)
        if "lambda_v" in sa:
            sd[f"{b}.self_attn.lambda_v"] = sa["lambda_v"]
        for name in ("gate_proj", "up_proj", "down_proj"):
            _dense(blk["mlp"][name], f"{b}.mlp.{name}", sd)
        if "norm2" in blk:
            sd[f"{b}.norm2.weight"] = blk["norm2"]["weight"]
            ca = blk["cross_attn"]
            _head_dense(ca["q"], f"{b}.cross_attn.q", sd)
            _head_dense(ca["context_kv"], f"{b}.cross_attn.context_kv", sd)
            _dense(ca["proj"], f"{b}.cross_attn.proj", sd)
        if f"blocks_{i}_adaLN" in p:
            _dense(p[f"blocks_{i}_adaLN"]["linear"],
                   f"{b}.adaLN_modulation.1", sd)

    _dense(p["final_modulation"]["linear"], "final_modulation.1", sd)
    if "final_norm" in p:
        sd["final_norm.weight"] = p["final_norm"]["weight"]
    _dense(p["final_proj"], "final_proj", sd)
    return _to_torch(sd)


def _conv(d, name, out) -> None:
    out[f"{name}.weight"] = np.ascontiguousarray(
        np.asarray(d["kernel"]).transpose(3, 2, 0, 1)
    )
    if "bias" in d:
        out[f"{name}.bias"] = np.asarray(d["bias"])


def _groupnorm(d, name, out) -> None:
    out[f"{name}.weight"] = d["norm"]["scale"]
    out[f"{name}.bias"] = d["norm"]["bias"]


def _resnet(d, base, out) -> None:
    _groupnorm(d["norm1"], f"{base}.norm1", out)
    _conv(d["conv1"], f"{base}.conv1", out)
    _groupnorm(d["norm2"], f"{base}.norm2", out)
    _conv(d["conv2"], f"{base}.conv2", out)
    if "conv_shortcut" in d:
        _conv(d["conv_shortcut"], f"{base}.conv_shortcut", out)


def vae_state_dict_from_jax(flat_params: Mapping[str, np.ndarray],
                            cfg) -> dict[str, torch.Tensor]:
    """Flat JAX VAE params -> the port's decode-only `AutoencoderKL` state
    dict (encoder parameters are not used)."""
    p = unflatten(flat_params)
    dec = p.get("params", p)["decoder"]
    sd: dict[str, np.ndarray] = {}
    _conv(dec["conv_in"], "decoder.conv_in", sd)
    _resnet(dec["mid_resnet_0"], "decoder.mid_block.resnets.0", sd)
    _resnet(dec["mid_resnet_1"], "decoder.mid_block.resnets.1", sd)
    if "mid_attn" in dec:
        a, base = dec["mid_attn"], "decoder.mid_block.attentions.0"
        _groupnorm(a["group_norm"], f"{base}.group_norm", sd)
        for name in ("to_q", "to_k", "to_v"):
            _dense(a[name], f"{base}.{name}", sd)
        _dense(a["to_out"], f"{base}.to_out.0", sd)
    for i in range(len(cfg.block_out_channels)):
        for j in range(cfg.layers_per_block + 1):
            _resnet(dec[f"up_{i}_resnet_{j}"],
                    f"decoder.up_blocks.{i}.resnets.{j}", sd)
        if f"up_{i}_upsample" in dec:
            _conv(dec[f"up_{i}_upsample"],
                  f"decoder.up_blocks.{i}.upsamplers.0.conv", sd)
    _groupnorm(dec["conv_norm_out"], "decoder.conv_norm_out", sd)
    _conv(dec["conv_out"], "decoder.conv_out", sd)
    return _to_torch(sd)
