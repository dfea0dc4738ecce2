"""JAX parameters -> the port's state dicts (own copy of the maps in
`f_lite_tpu/convert/jax_to_torch.py`: `invert_dit_params` with
`from_scan_layout`, `invert_vae_params`; `pipeline_to_scan_params` is
`parallel/pipeline.py`'s), and the text towers' trees of
`convert_t5_state_dict` / `convert_qwen2_state_dict` carried to HF's names
(`t5_state_dict_from_jax`, `qwen2_state_dict_from_jax`).

Input: the dot-flattened keys exactly as `flax_params.safetensors` stores
them (e.g. `blocks_3.self_attn.qkv.kernel`), as numpy arrays. Layouts:
- Dense kernel (in, out)                 -> Linear weight (out, in);
- head-aligned kernel (in, *split, H, D) -> fused weight (prod(split)*H*D, in),
  zero-padded heads (`DiTConfig.padded_heads`) sliced off first;
- attention out-proj (Hpad*D, hidden)    -> rows past num_heads*D dropped;
- patch-embed kernel (p*p*C, D)          -> Conv2d weight (D, C, p, p);
- Conv kernel (kh, kw, in, out)          -> Conv2d weight (out, in, kh, kw);
- GroupNorm scale/bias                   -> weight/bias;
- scan-stacked blocks (`blocks_front`/`blocks_rest`/`blocks_all`, leading
  layers axis) unstacked to `blocks_{i}`, block 0's inert `lambda_v`
  dropped; the pipeline-parallel layout (`<trunk>.pipe.stages.blocks`,
  leading (stages, units per stage) axes) folded to the scan layout first;
- int8 projections (`quantize_dit_params`): w8 (in, *out) -> `QuantDense`
  w8 (N, in) int8 as the kernel above, scale (*out) -> (N,) fp32, in all of
  those layouts (a padded head's scale is 1 and its w8 zero).
Every step is a transpose, reshape, slice of zeros or unstacking, so the
conversion is exact. bfloat16 tensors may come as their uint16 bit
patterns (`utils.safetensors.load_file(bf16_bits=True)`): they are moved
as such and stay bfloat16 in the state dict.

`reference_dit_config` / `reference_vae_config` are the own copies of the
reference `config.json` fields of `jax_to_torch.py` that an export to the
reference's layout writes beside those state dicts.
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
    """The transpose of a 2-D array, contiguous (fp32, int8 and bfloat16
    bits copied by torch, on every core; other dtypes, such as ml_dtypes'
    bfloat16, by numpy)."""
    w = np.asarray(w)
    if w.dtype == np.uint16:  # bfloat16 bits
        return _t(w.view(np.int16)).view(np.uint16)
    if w.dtype not in (np.float32, np.int8, np.int16):
        return np.ascontiguousarray(w.T)
    return torch.from_numpy(np.ascontiguousarray(w)).t().contiguous().numpy()


def _dense(d, name, out) -> None:
    if "w8" in d:
        out[f"{name}.w8"] = _t(d["w8"])
        out[f"{name}.scale"] = np.asarray(d["scale"])
    else:
        out[f"{name}.weight"] = _t(d["kernel"])
    if "bias" in d:
        out[f"{name}.bias"] = np.asarray(d["bias"])


def _unpadded(a: np.ndarray, axis: int, n: int, name: str) -> np.ndarray:
    """`a` cut to its first `n` entries along `axis`; the rest must be the
    zeros of head padding."""
    a = np.asarray(a)
    cut = np.take(a, np.arange(n, a.shape[axis]), axis=axis)
    if cut.any():
        raise ValueError(f"{name}: padded heads past {n} are not zero")
    return np.take(a, np.arange(n), axis=axis)


def _head_dense(d, name, out, heads) -> None:
    if "w8" in d:
        k = _unpadded(d["w8"], -2, heads, name)  # (in, *split, H, D)
        out[f"{name}.w8"] = _t(k.reshape(k.shape[0], -1))
        # padded heads quantize to scale 1: cut without the zero check
        scale = np.take(np.asarray(d["scale"]), np.arange(heads), axis=-2)
        out[f"{name}.scale"] = scale.reshape(-1)
    else:
        k = _unpadded(d["kernel"], -2, heads, name)  # (in, *split, H, D)
        out[f"{name}.weight"] = _t(k.reshape(k.shape[0], -1))
    if "bias" in d:
        out[f"{name}.bias"] = _unpadded(d["bias"], -2, heads, name).reshape(-1)


def _proj(d, name, out, rows) -> None:
    if "w8" in d:
        out[f"{name}.w8"] = _t(_unpadded(d["w8"], 0, rows, name))
        out[f"{name}.scale"] = np.asarray(d["scale"])
    else:
        out[f"{name}.weight"] = _t(_unpadded(d["kernel"], 0, rows, name))


def _to_torch(sd: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """fp32 tensors, int8 weights kept int8, bfloat16 bits as bfloat16. A
    tensor shares its array's memory where that is writable and already of
    its dtype and contiguous (a transposed copy, or a view of
    `load_file(bf16_bits=True)`'s copy-on-write map); else it is a copy."""
    out = {}
    for k, v in sd.items():
        a = np.asarray(v)
        if a.dtype == np.uint16:
            a = np.ascontiguousarray(a).view(np.int16)
        else:
            a = np.ascontiguousarray(a, np.int8 if a.dtype == np.int8 else np.float32)
        if not a.flags.writeable:
            a = a.copy()
        t = torch.from_numpy(a)
        out[k] = t.view(torch.bfloat16) if t.dtype == torch.int16 else t
    return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(np.asarray(tree))


def _fold_pipeline(p: dict) -> dict:
    """The pipeline-parallel trunks folded back to the plain scan layout
    (`parallel.pipeline.pipeline_to_scan_params`): leaves (stages, units
    per stage, ...) -> (units, ...)."""
    from f_lite_tpu_torch.parallel.pipeline import pipeline_to_scan_params

    return pipeline_to_scan_params({"params": p})["params"]


def _unstack_scan(p: dict, cfg) -> dict:
    """Scan-stacked trunks -> per-block `blocks_{i}` (and
    `blocks_{i}_adaLN`) entries, in the block order of `to_scan_layout`."""
    p = dict(p)
    units = []  # (trunk, block indices of each unit)
    if cfg.cross_attn_all:
        units.append(("blocks_all", [[i] for i in range(cfg.depth)]))
    else:
        first_n = min(cfg.cross_attn_first_n, cfg.depth)
        period = cfg.cross_attn_period
        units.append(("blocks_front", [[i] for i in range(first_n)]))
        units.append(("blocks_rest", [
            [first_n + u * period + j for j in range(period)]
            for u in range((cfg.depth - first_n) // period)]))
    for trunk, unit_blocks in units:
        if trunk not in p:
            continue
        stacked = p.pop(trunk)
        for step, blocks in enumerate(unit_blocks):
            unit = _tree_map(lambda x, s=step: x[s], stacked)
            for j, i in enumerate(blocks):
                blk = unit[f"blk_{j}"]
                if i == 0 and cfg.residual_v:
                    # under scan every block owns a lambda_v; block 0's is
                    # inert and the unrolled layout has none
                    blk = {**blk, "self_attn": {
                        k: v for k, v in blk["self_attn"].items()
                        if k != "lambda_v"}}
                p[f"blocks_{i}"] = blk
                if f"blk_{j}_adaLN" in unit:
                    p[f"blocks_{i}_adaLN"] = unit[f"blk_{j}_adaLN"]
    return p


def state_dict_from_jax(flat_params: Mapping[str, np.ndarray],
                        cfg) -> dict[str, torch.Tensor]:
    """Flat JAX DiT params -> the port's `DiT` state dict (fp32, bfloat16
    where given as bits, int8 weights int8; the caller casts). Takes the
    unrolled, scan-stacked and pipeline-parallel layouts, with or without
    padded heads, quantized or not."""
    p = unflatten(flat_params)
    p = _fold_pipeline(p.get("params", p))
    if any(k in p for k in _SCAN_KEYS):
        p = _unstack_scan(p, cfg)
    heads, rows = cfg.num_heads, cfg.num_heads * cfg.head_dim
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
        _head_dense(sa["qkv"], f"{b}.self_attn.qkv", sd, heads)
        _proj(sa["proj"], f"{b}.self_attn.proj", sd, rows)
        if "lambda_v" in sa:
            sd[f"{b}.self_attn.lambda_v"] = sa["lambda_v"]
        for name in ("gate_proj", "up_proj", "down_proj"):
            _dense(blk["mlp"][name], f"{b}.mlp.{name}", sd)
        if "norm2" in blk:
            sd[f"{b}.norm2.weight"] = blk["norm2"]["weight"]
            ca = blk["cross_attn"]
            _head_dense(ca["q"], f"{b}.cross_attn.q", sd, heads)
            _head_dense(ca["context_kv"], f"{b}.cross_attn.context_kv", sd, heads)
            _proj(ca["proj"], f"{b}.cross_attn.proj", sd, rows)
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


def _mid(d, base, out) -> None:
    """Mid block: two resnets and, where present, the attention."""
    _resnet(d["mid_resnet_0"], f"{base}.mid_block.resnets.0", out)
    _resnet(d["mid_resnet_1"], f"{base}.mid_block.resnets.1", out)
    if "mid_attn" in d:
        a, attn = d["mid_attn"], f"{base}.mid_block.attentions.0"
        _groupnorm(a["group_norm"], f"{attn}.group_norm", out)
        for name in ("to_q", "to_k", "to_v"):
            _dense(a[name], f"{attn}.{name}", out)
        _dense(a["to_out"], f"{attn}.to_out.0", out)


def vae_state_dict_from_jax(flat_params: Mapping[str, np.ndarray],
                            cfg) -> dict[str, torch.Tensor]:
    """Flat JAX VAE params -> the port's `AutoencoderKL` state dict
    (encoder and decoder)."""
    p = unflatten(flat_params)
    p = p.get("params", p)
    enc, dec = p["encoder"], p["decoder"]
    sd: dict[str, np.ndarray] = {}
    _conv(enc["conv_in"], "encoder.conv_in", sd)
    for i in range(len(cfg.block_out_channels)):
        for j in range(cfg.layers_per_block):
            _resnet(enc[f"down_{i}_resnet_{j}"],
                    f"encoder.down_blocks.{i}.resnets.{j}", sd)
        if f"down_{i}_downsample" in enc:
            _conv(enc[f"down_{i}_downsample"],
                  f"encoder.down_blocks.{i}.downsamplers.0.conv", sd)
    _mid(enc, "encoder", sd)
    _groupnorm(enc["conv_norm_out"], "encoder.conv_norm_out", sd)
    _conv(enc["conv_out"], "encoder.conv_out", sd)

    _conv(dec["conv_in"], "decoder.conv_in", sd)
    _mid(dec, "decoder", sd)
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


def t5_state_dict_from_jax(params: Mapping, cfg) -> dict[str, torch.Tensor]:
    """JAX `T5EncoderStack` params (nested or dot-flattened) -> the port's
    `T5EncoderStack` state dict (HF `T5EncoderModel` names), fp32."""
    p = unflatten(params)
    p = p.get("params", p)
    sd: dict[str, np.ndarray] = {
        "shared.weight": p["embed_tokens"],
        "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
            p["relative_attention_bias"],
        "encoder.final_layer_norm.weight": p["final_layer_norm"],
    }
    ff = ("wi_0", "wi_1") if cfg.is_gated else ("wi",)
    for i in range(cfg.num_layers):
        blk = p[f"blocks_{i}"]
        a, f = f"encoder.block.{i}.layer.0", f"encoder.block.{i}.layer.1"
        sd[f"{a}.layer_norm.weight"] = blk["attn_layer_norm"]
        sd[f"{f}.layer_norm.weight"] = blk["ff_layer_norm"]
        for name in ("q", "k", "v", "o"):
            _dense(blk[name], f"{a}.SelfAttention.{name}", sd)
        for name in (*ff, "wo"):
            _dense(blk[name], f"{f}.DenseReluDense.{name}", sd)
    return _to_torch(sd)


def qwen2_state_dict_from_jax(params: Mapping, cfg) -> dict[str, torch.Tensor]:
    """JAX `Qwen2Encoder` params (nested or dot-flattened) -> the port's
    `Qwen2Encoder` state dict (HF `Qwen2Model` names), fp32."""
    p = unflatten(params)
    p = p.get("params", p)
    sd: dict[str, np.ndarray] = {"embed_tokens.weight": p["embed_tokens"],
                                 "norm.weight": p["norm"]}
    for i in range(cfg.num_hidden_layers):
        layer, base = p[f"layers_{i}"], f"layers.{i}"
        sd[f"{base}.input_layernorm.weight"] = layer["input_layernorm"]
        sd[f"{base}.post_attention_layernorm.weight"] = layer["post_attention_layernorm"]
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _dense(layer[name], f"{base}.self_attn.{name}", sd)
        for name in ("gate_proj", "up_proj", "down_proj"):
            _dense(layer[name], f"{base}.mlp.{name}", sd)
    return _to_torch(sd)


def reference_dit_config(config) -> dict:
    """The reference DiT's constructor args / diffusers `config.json`
    fields for this architecture (`model.py:419-433`, `pt.py:85-95`); the
    fields past v1 only where they differ from v1's defaults, so a v1
    export matches the reference's layout and a v2 one re-ingests as
    itself."""
    out = {
        "_class_name": "DiT",
        "in_channels": config.in_channels,
        "patch_size": config.patch_size,
        "hidden_size": config.hidden_size,
        "depth": config.depth,
        "num_heads": config.num_heads,
        "mlp_ratio": config.mlp_ratio,
        "cross_attn_input_size": config.cross_attn_input_size,
        "train_bias_and_rms": config.train_bias_and_rms,
        "use_rope": config.use_rope,
        "rope_base": config.rope_base,
        "dynamic_softmax_temperature": config.dynamic_softmax_temperature,
        "residual_v": config.residual_v,
        "gradient_checkpoint": False,
    }
    if config.adaln_mode != "shared":
        out["adaln_mode"] = config.adaln_mode
    if config.cross_attn_all:
        out["cross_attn_all"] = True
    if config.cross_attn_first_n != 8:
        out["cross_attn_first_n"] = config.cross_attn_first_n
    if config.cross_attn_period != 4:
        out["cross_attn_period"] = config.cross_attn_period
    return out


def reference_vae_config(config) -> dict:
    """diffusers AutoencoderKL `config.json` for the Flux-Schnell VAE shape
    (the fields `pt.py:143-145` and the VAE depend on)."""
    n = len(config.block_out_channels)
    return {
        "_class_name": "AutoencoderKL",
        "in_channels": 3,
        "out_channels": 3,
        "down_block_types": ["DownEncoderBlock2D"] * n,
        "up_block_types": ["UpDecoderBlock2D"] * n,
        "block_out_channels": list(config.block_out_channels),
        "layers_per_block": config.layers_per_block,
        "act_fn": "silu",
        "latent_channels": config.latent_channels,
        "norm_num_groups": config.norm_num_groups,
        "sample_size": 1024,
        "scaling_factor": config.scaling_factor,
        "shift_factor": config.shift_factor,
        "mid_block_add_attention": config.mid_block_add_attention,
        "use_quant_conv": False,
        "use_post_quant_conv": False,
    }
