"""The port's VAE against the JAX `AutoencoderKL`, on the CPU in fp32: one
seeded parameter set through `vae_state_dict_from_jax`, the same numpy
inputs. Encode and decode atol 1e-5; the sliced modes and the tiled modes
(3x3 tiles of 16 latents at 72 px, seams blended) against the JAX
`encode_sliced`/`decode_sliced`/`encode_tiled`/`decode_tiled`, atol 1e-5."""

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
    assert {k for k in sd if k.startswith("decoder.")} == set(ref)
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
    for mode, lmax in (("auto", 128), ("auto", 129), ("direct", 256),
                       ("sliced", 8), ("tiled", 8)):
        assert tvae.resolve_memory_mode(mode, lmax) == jvae.resolve_memory_mode(mode, lmax)
    assert tvae.resolve_memory_mode("auto", 129) == "tiled"
    with pytest.raises(ValueError, match="memory mode"):
        tvae.resolve_memory_mode("chunked", 8)
    ident = tvae.IdentityVAE()
    assert ident.config.spatial_scale == 1
    assert torch.equal(ident.decode(z), z)


def _pair(name, seed):
    """(JAX model, its params tree, the port's model) on one seeded set."""
    jcfg = jvae.VAEConfig.tiny(**CONFIGS[name])
    tcfg = tvae.VAEConfig.tiny(**CONFIGS[name])
    flat = _params(jcfg, seed=seed)
    model = tvae.AutoencoderKL(tcfg).eval()
    model.load_state_dict(vae_state_dict_from_jax(flat, tcfg), strict=True)
    return jvae.AutoencoderKL(jcfg), {"params": _unflatten(flat)}, model


@pytest.mark.parametrize("name", list(CONFIGS))
def test_encode_matches_jax(name):
    jmodel, jparams, model = _pair(name, seed=len(name) + 1)
    x = np.random.RandomState(8).uniform(-1, 1, (2, 12, 20, 3)).astype(np.float32)
    want_mean, want_logvar = (np.asarray(a) for a in jmodel.apply(
        jparams, jnp.asarray(x), method=jvae.AutoencoderKL.encode_moments))
    with torch.no_grad():
        mean, logvar = (a.numpy() for a in model.encode_moments(torch.from_numpy(x)))
        enc = model.encode(torch.from_numpy(x)).numpy()
    s = jmodel.config.spatial_scale
    assert mean.shape == want_mean.shape == (2, 12 // s, 20 // s, 4)
    np.testing.assert_allclose(mean, want_mean, atol=1e-5, rtol=0)
    np.testing.assert_allclose(logvar, want_logvar, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(enc, mean)
    np.testing.assert_allclose(
        enc, np.asarray(jmodel.apply(jparams, jnp.asarray(x),
                                     method=jvae.AutoencoderKL.encode)),
        atol=1e-5, rtol=0)


def test_all_keys_match_invert_vae_params():
    jcfg = jvae.VAEConfig.tiny(block_out_channels=(8, 16, 16))
    flat = _params(jcfg, seed=3)
    sd = vae_state_dict_from_jax(flat, tvae.VAEConfig.tiny(block_out_channels=(8, 16, 16)))
    ref = invert_vae_params({"params": _unflatten(flat)}, jcfg)
    assert set(sd) == set(ref)
    assert any(k.startswith("encoder.down_blocks.1.downsamplers") for k in sd)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("mode", ["tiled", "sliced"])
def test_memory_modes_match_jax(mode):
    """72 px through the tiny 2-level VAE (36 latents): tiled with 16-latent
    tiles is 3x3 tiles with blended seams on both encode and decode; sliced
    is one sample at a time. Each against the JAX function of the same
    name."""
    jmodel, jparams, model = _pair("tiny", seed=5)
    rs = np.random.RandomState(9)
    x = rs.uniform(-1, 1, (2, 72, 72, 3)).astype(np.float32)
    z = rs.randn(2, 36, 36, 4).astype(np.float32)
    if mode == "tiled":
        want_enc = jvae.encode_tiled(jmodel, jparams, jnp.asarray(x), tile_latent_size=16)
        want_dec = jvae.decode_tiled(jmodel, jparams, jnp.asarray(z), tile_latent_size=16)
        with torch.no_grad():
            enc = tvae.encode_tiled(model, torch.from_numpy(x), tile_latent_size=16)
            dec = tvae.decode_tiled(model, torch.from_numpy(z), tile_latent_size=16)
            whole = model.decode(torch.from_numpy(z))
        # the seams are blended, not the whole decode
        assert float((dec - whole).abs().max()) > 1e-3
    else:
        want_enc = jvae.encode_sliced(jmodel, jparams, jnp.asarray(x))
        want_dec = jvae.decode_sliced(jmodel, jparams, jnp.asarray(z))
        with torch.no_grad():
            enc = tvae.encode_sliced(model, torch.from_numpy(x))
            dec = tvae.decode_sliced(model, torch.from_numpy(z))
    assert enc.shape == (2, 36, 36, 4) and dec.shape == (2, 72, 72, 3)
    np.testing.assert_allclose(enc.numpy(), np.asarray(want_enc), atol=1e-5, rtol=0)
    np.testing.assert_allclose(dec.numpy(), np.asarray(want_dec), atol=1e-5, rtol=0)
