"""The port's VAE decoder against the JAX `AutoencoderKL.decode`, on the CPU
in fp32: one seeded parameter set through `vae_state_dict_from_jax`, the
same numpy latents, atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f_lite_tpu.convert.jax_to_torch import invert_vae_params
from f_lite_tpu.models import vae as jvae
from f_lite_tpu_torch.convert.from_jax import vae_state_dict_from_jax
from f_lite_tpu_torch.models import vae as tvae

CONFIGS = {
    "tiny": {},
    "tiny_3_levels": dict(block_out_channels=(8, 16, 16)),
}


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *parents, leaf = k.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _params(jcfg, seed):
    """JAX init, with GroupNorm scales/biases and conv biases randomised
    too (their init is 1 / 0)."""
    model = jvae.AutoencoderKL(jcfg)
    x = jnp.zeros((1, 8, 8, 3), jnp.float32)
    flat = _flatten(model.init(jax.random.key(seed), x)["params"])
    rs = np.random.RandomState(seed)
    for k, v in flat.items():
        if k.endswith(".scale"):
            flat[k] = (1.0 + 0.1 * rs.randn(*v.shape)).astype(np.float32)
        elif k.endswith(".bias"):
            flat[k] = (0.1 * rs.randn(*v.shape)).astype(np.float32)
    return flat


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_matches_jax(name):
    jcfg = jvae.VAEConfig.tiny(**CONFIGS[name])
    tcfg = tvae.VAEConfig.tiny(**CONFIGS[name])
    assert tcfg.spatial_scale == jcfg.spatial_scale
    flat = _params(jcfg, seed=len(name))
    z = np.random.RandomState(7).randn(2, 6, 5, jcfg.latent_channels).astype(np.float32)

    want = np.asarray(jvae.AutoencoderKL(jcfg).apply(
        {"params": _unflatten(flat)}, jnp.asarray(z),
        method=jvae.AutoencoderKL.decode,
    ))
    model = tvae.AutoencoderKL(tcfg).eval()
    model.load_state_dict(vae_state_dict_from_jax(flat, tcfg), strict=True)
    with torch.no_grad():
        got = model.decode(torch.from_numpy(z)).numpy()
    s = jcfg.spatial_scale
    assert got.shape == want.shape == (2, 6 * s, 5 * s, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_decoder_keys_match_invert_vae_params():
    jcfg = jvae.VAEConfig.tiny()
    flat = _params(jcfg, seed=0)
    sd = vae_state_dict_from_jax(flat, tvae.VAEConfig.tiny())
    ref = {k: v for k, v in invert_vae_params({"params": _unflatten(flat)}, jcfg).items()
           if k.startswith("decoder.")}
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)


def test_latent_normalisation_and_memory_mode():
    cfg = tvae.VAEConfig.flux()
    z = torch.linspace(-2, 2, 9)
    back = tvae.normalize_latents(tvae.denormalize_latents(z, cfg), cfg)
    torch.testing.assert_close(back, z)
    np.testing.assert_allclose(
        tvae.denormalize_latents(z, cfg).numpy(),
        np.asarray(jvae.denormalize_latents(jnp.asarray(z.numpy()), jvae.VAEConfig.flux())),
        atol=1e-6,
    )
    assert tvae.resolve_memory_mode("auto", 128) == "direct"
    assert tvae.resolve_memory_mode("direct", 256) == "direct"
    with pytest.raises(NotImplementedError):
        tvae.resolve_memory_mode("auto", 129)
    ident = tvae.IdentityVAE()
    assert ident.config.spatial_scale == 1
    assert torch.equal(ident.decode(z), z)
