"""The port's sampler extras against the JAX sampler, on the CPU in fp32.

One tiny DiT (seeded JAX parameters, loaded into the port through
`state_dict_from_jax`), the same numpy latents and embeddings. The JAX side
runs `make_denoise_fn` (guidance-interval segments, ab2 with its velocity
history, `start_step` slices, inpainting with one key per schedule row) or
`_denoise_schedule` on an explicit schedule; the port gets the JAX
per-step noise as a tensor. Bar: final latents allclose 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f_lite_tpu.models.dit import DiT as JaxDiT
from f_lite_tpu.models.dit import DiTConfig as JaxDiTConfig
from f_lite_tpu.sampling import euler as jeuler
from f_lite_tpu_torch.convert.from_jax import state_dict_from_jax
from f_lite_tpu_torch.models.dit import DiT, DiTConfig
from f_lite_tpu_torch.sampling import euler as teuler
from test_torch_dit import random_jax_params, unflatten

CFG = dict(in_channels=4, patch_size=2, hidden_size=64, depth=3, num_heads=4,
           mlp_ratio=2.0, cross_attn_input_size=32, residual_v=True,
           cross_attn_first_n=1, cross_attn_period=2)
STEPS = 8


@pytest.fixture(scope="module")
def models():
    jcfg = JaxDiTConfig(**CFG, use_pallas_attention=False)
    flat = random_jax_params(jcfg, 21)
    model = DiT(DiTConfig(**CFG)).eval()
    model.load_state_dict(state_dict_from_jax(flat, DiTConfig(**CFG)))
    return JaxDiT(jcfg).apply, {"params": unflatten(flat)}, model


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    latents = rs.randn(2, 8, 8, 4).astype(np.float32)
    pos = rs.randn(2, 6, 32).astype(np.float32)
    neg = rs.randn(2, 6, 32).astype(np.float32)
    mask = np.arange(6)[None, :] < np.array([6, 4])[:, None]
    neg_mask = np.arange(6)[None, :] < np.array([3, 6])[:, None]
    x_lat = rs.randn(2, 8, 8, 4).astype(np.float32)
    repaint = np.zeros((2, 8, 8, 1), np.float32)
    repaint[:, :, :4] = 1.0
    repaint[1, 2, 6] = 0.5  # a soft value
    return latents, pos, neg, mask, neg_mask, x_lat, repaint


def _jax_eps(key, n, shape):
    """The per-row noise `make_denoise_fn` draws for inpainting."""
    keys = jax.random.split(key, n)
    return np.stack([np.asarray(jax.random.normal(k, shape, jnp.float32))
                     for k in keys])


CASES = {
    "interval": dict(guidance_interval=(0.3, 0.8)),
    "ab2": dict(method="ab2"),
    "ab2_interval": dict(method="ab2", guidance_interval=(0.3, 0.8)),
    "start_step": dict(start_step=3),
    "ab2_start_step": dict(method="ab2", start_step=2),
    "inpaint": dict(start_step=2, inpaint=True),
    "ab2_inpaint_interval": dict(method="ab2", guidance_interval=(0.2, 0.7),
                                 inpaint=True),
    "no_cfg_ab2": dict(method="ab2", guidance_scale=0.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_denoise_matches_jax(models, case):
    japply, jparams, model = models
    opts = dict(CASES[case])
    start = opts.pop("start_step", 0)
    with_inpaint = opts.pop("inpaint", False)
    kw = dict(dict(num_inference_steps=STEPS, guidance_scale=4.0), **opts)
    latents, pos, neg, mask, neg_mask, x_lat, repaint = _inputs()

    jinpaint = tinpaint = None
    if with_inpaint:
        key = jax.random.key(5)
        jinpaint = (jnp.asarray(x_lat), jnp.asarray(repaint), key)
        eps = _jax_eps(key, STEPS - start, x_lat.shape)
        tinpaint = tuple(map(torch.from_numpy, (x_lat, repaint, eps)))
    fn = jeuler.make_denoise_fn(japply, jeuler.DenoiseSettings(**kw), donate=False)
    want = np.asarray(fn(jparams, jnp.asarray(latents), jnp.asarray(pos),
                         jnp.asarray(neg), jnp.asarray(mask),
                         neg_mask=jnp.asarray(neg_mask), start_step=start,
                         inpaint=jinpaint))
    got = teuler.denoise(
        model, torch.from_numpy(latents), torch.from_numpy(pos),
        torch.from_numpy(neg), torch.from_numpy(mask),
        teuler.DenoiseSettings(**kw), negative_mask=torch.from_numpy(neg_mask),
        start_step=start, inpaint=tinpaint).numpy()
    assert float(np.abs(want - latents).max()) > 0.1  # the trajectory moved
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_segments_and_start_time_match_jax():
    for lo_hi in (None, (0.3, 0.8), (0.0, 0.2), (0.95, 1.0)):
        s = teuler.DenoiseSettings(num_inference_steps=12, guidance_interval=lo_hi)
        js = jeuler.DenoiseSettings(num_inference_steps=12, guidance_interval=lo_hi)
        sched = jeuler._full_schedule(js, 16, 16)
        assert teuler.interval_segments(s, teuler.full_schedule(s, 16, 16)) == \
            jeuler._interval_segments(js, sched)
    s = teuler.DenoiseSettings(num_inference_steps=30)
    js = jeuler.DenoiseSettings(num_inference_steps=30)
    for lh, lw in ((128, 128), (160, 160), (13, 7)):
        assert teuler.schedule_start_time(s, lh, lw, 0) == 1.0
        for step in (1, 15, 29):
            assert teuler.schedule_start_time(s, lh, lw, step) == \
                jeuler.schedule_start_time(js, lh, lw, step)
    with pytest.raises(ValueError, match="method"):
        teuler.DenoiseSettings(method="heun")


@pytest.mark.parametrize("method", ["euler", "ab2"])
def test_inpaint_zero_dt_row_is_a_no_op(models, method):
    """`_denoise_schedule` on an explicit schedule with a repeated t (a
    zero-dt row) and inpainting: the row changes nothing, in both
    packages, and ab2 with a mask is Euler with a mask."""
    japply, jparams, model = models
    latents, pos, neg, mask, neg_mask, x_lat, repaint = _inputs(seed=1)
    rows = [[1.0, 0.8], [0.8, 0.8], [0.8, 0.5], [0.5, 0.0]]
    sched = np.asarray(rows, np.float32)
    settings = jeuler.DenoiseSettings(num_inference_steps=4, guidance_scale=3.0,
                                      method=method)
    key = jax.random.key(8)
    keys = jax.random.split(key, len(rows))
    eps = np.stack([np.asarray(jax.random.normal(k, x_lat.shape, jnp.float32))
                    for k in keys])
    out = jeuler._denoise_schedule(
        japply, jparams, jnp.asarray(latents), jnp.asarray(pos), jnp.asarray(neg),
        jnp.asarray(mask), jnp.asarray(neg_mask), jnp.asarray(sched), settings,
        inpaint=(jnp.asarray(x_lat), jnp.asarray(repaint), keys))
    want = np.asarray(out[0] if method == "ab2" else out)
    tsettings = teuler.DenoiseSettings(num_inference_steps=4, guidance_scale=3.0,
                                       method=method)
    args = (model, torch.from_numpy(latents), torch.from_numpy(pos),
            torch.from_numpy(neg), torch.from_numpy(mask),
            torch.from_numpy(neg_mask))
    tin = (torch.from_numpy(x_lat), torch.from_numpy(repaint))
    with torch.no_grad():
        got = teuler.denoise_schedule(*args, torch.from_numpy(sched), tsettings,
                                      inpaint=(*tin, torch.from_numpy(eps))).numpy()
        # without the zero-dt row (and its noise row): the same result
        keep = [0, 2, 3]
        without = teuler.denoise_schedule(
            *args, torch.from_numpy(sched[keep]), tsettings,
            inpaint=(*tin, torch.from_numpy(eps[keep]))).numpy()
        euler = teuler.denoise_schedule(
            *args, torch.from_numpy(sched), dataclasses.replace(tsettings, method="euler"),
            inpaint=(*tin, torch.from_numpy(eps))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got, without)
    np.testing.assert_array_equal(got, euler)
    # the last row has t_next = 0: the kept region is x_lat exactly
    keep_px = repaint[..., 0] == 0
    np.testing.assert_array_equal(got[keep_px], x_lat[keep_px])
