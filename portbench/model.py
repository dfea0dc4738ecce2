"""What the drivers hand the port's constructors: the fields of a
configuration file that are the port's `DiTConfig` and `VAEConfig`."""

from __future__ import annotations

DIT_KEYS = ("in_channels", "patch_size", "hidden_size", "depth", "num_heads",
            "mlp_ratio", "cross_attn_input_size", "train_bias_and_rms", "use_rope",
            "rope_base", "dynamic_softmax_temperature", "residual_v", "adaln_mode",
            "cross_attn_period", "cross_attn_first_n", "n_register_tokens")
VAE_KEYS = ("in_channels", "out_channels", "latent_channels", "block_out_channels",
            "layers_per_block", "norm_num_groups", "scaling_factor", "shift_factor")


def dit_fields(cfg: dict) -> dict:
    return {k: cfg[k] for k in DIT_KEYS}


def vae_fields(vae: dict) -> dict:
    return {k: tuple(vae[k]) if k == "block_out_channels" else vae[k] for k in VAE_KEYS}


def spatial_scale(vae: dict) -> int:
    return 2 ** (len(vae["block_out_channels"]) - 1)
