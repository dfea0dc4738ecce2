"""The port's ops (`f_lite_tpu_torch.ops`) against the JAX package's, on the
CPU in fp32: the same numpy inputs through both, allclose at atol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f_lite_tpu.ops import attention as jattn
from f_lite_tpu.ops import guidance as jguid
from f_lite_tpu.ops import norms as jnorms
from f_lite_tpu.ops import patching as jpatch
from f_lite_tpu.ops import rope as jrope
from f_lite_tpu.ops import timesteps as jts
from f_lite_tpu_torch.ops import attention as tattn
from f_lite_tpu_torch.ops import guidance as tguid
from f_lite_tpu_torch.ops import norms as tnorms
from f_lite_tpu_torch.ops import patching as tpatch
from f_lite_tpu_torch.ops import rope as trope
from f_lite_tpu_torch.ops import timesteps as tts

ATOL = 1e-6


def _close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("with_weight", [False, True])
def test_rms_norm(with_weight):
    x = _rand(2, 5, 32) * 3.0
    w = 1.0 + 0.1 * _rand(32, seed=1) if with_weight else None
    want = jnorms.rms_norm(jnp.asarray(x), None if w is None else jnp.asarray(w))
    got = tnorms.rms_norm(torch.from_numpy(x),
                          None if w is None else torch.from_numpy(w))
    _close(got, want)


def test_qk_norm():
    q, k = _rand(2, 3, 7, 16), _rand(2, 3, 7, 16, seed=1)
    jq, jk = jnorms.qk_norm(jnp.asarray(q), jnp.asarray(k))
    tq, tk = tnorms.qk_norm(torch.from_numpy(q), torch.from_numpy(k))
    _close(tq, jq)
    _close(tk, jk)


@pytest.mark.parametrize("n_reg", [0, 16])
def test_rope_tables_and_rotation(n_reg):
    jc, js = jrope.rope_2d_freqs(64, 4, 6, n_register_tokens=n_reg)
    tc, ts = trope.rope_2d_freqs(64, 4, 6, n_register_tokens=n_reg)
    _close(tc, jc)
    _close(ts, js)
    if n_reg:
        assert torch.equal(tc[:n_reg], torch.ones(n_reg, 32))
        assert torch.equal(ts[:n_reg], torch.zeros(n_reg, 32))
    x = _rand(2, 3, n_reg + 24, 64)
    want = jrope.apply_rotary(jnp.asarray(x), jc, js)
    _close(trope.apply_rotary(torch.from_numpy(x), tc, ts), want, atol=1e-5)


def test_timesteps():
    t = np.random.RandomState(0).rand(5).astype(np.float32) * 1000
    _close(tts.timestep_embedding(torch.from_numpy(t), 64),
           jts.timestep_embedding(jnp.asarray(t), 64), atol=1e-5)
    for hw in (32 * 32, 128 * 128, 96 * 64):
        assert tts.resolution_alpha(hw) == jts.resolution_alpha(hw)
        a = tts.resolution_alpha(hw)
        _close(tts.euler_timestep_pairs(30, a), jts.euler_timestep_pairs(30, a))
    x = np.linspace(0, 1, 11, dtype=np.float32)
    _close(tts.shift_t(torch.from_numpy(x), 3.0), jts.shift_t(jnp.asarray(x), 3.0))


def test_patchify_roundtrip():
    x = _rand(2, 8, 12, 3)
    want = jpatch.patchify(jnp.asarray(x), 2)
    got = tpatch.patchify(torch.from_numpy(x), 2)
    _close(got, want, atol=0)
    back = tpatch.unpatchify(got, 4, 6, 2, 3)
    _close(back, jpatch.unpatchify(want, 4, 6, 2, 3), atol=0)
    _close(back, x, atol=0)


@pytest.mark.parametrize("apg", [None, jguid.APGConfig()])
def test_guidance(apg):
    u, c = _rand(2, 4, 4, 3), _rand(2, 4, 4, 3, seed=1)
    want = jguid.guidance_combine(jnp.asarray(u), jnp.asarray(c), 6.0, apg)
    tapg = None if apg is None else tguid.APGConfig()
    got = tguid.guidance_combine(torch.from_numpy(u), torch.from_numpy(c), 6.0,
                                 tapg)
    _close(got, want, atol=1e-5)
    _close(tguid.cfg_combine(torch.from_numpy(u), torch.from_numpy(c), 3.0),
           jguid.cfg_combine(jnp.asarray(u), jnp.asarray(c), 3.0))


def test_compact_context_non_prefix_mask():
    ctx = _rand(3, 8, 5)
    mask = np.array([[1, 0, 1, 1, 0, 0, 1, 0],
                     [0, 0, 0, 0, 0, 0, 0, 0],
                     [1, 1, 1, 1, 1, 1, 1, 1]], bool)
    jc, jm = jattn.compact_context(jnp.asarray(ctx), jnp.asarray(mask))
    tc, tm = tattn.compact_context(torch.from_numpy(ctx), torch.from_numpy(mask))
    _close(tc, jc, atol=0)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tm[0].tolist() == [True] * 4 + [False] * 4


@pytest.mark.parametrize("masked", [False, True])
def test_attention_plain_matches_attention_xla(masked):
    q, k, v = _rand(2, 3, 9, 16), _rand(2, 3, 7, 16, seed=1), _rand(2, 3, 7, 16, seed=2)
    mask = np.array([[1, 0, 1, 1, 0, 1, 1], [0] * 7], bool) if masked else None
    want = jattn.attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               kv_mask=None if mask is None else jnp.asarray(mask))
    got = tattn.attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v),
                                kv_mask=None if mask is None else torch.from_numpy(mask))
    _close(got, want)
