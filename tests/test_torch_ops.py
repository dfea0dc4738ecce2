"""The port's ops (`f_lite_tpu_torch.ops`) against the JAX package's, on the
CPU in fp32: the same numpy inputs through both, allclose at atol 1e-6."""

from pathlib import Path

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
from f_lite_tpu_torch.ops.cuda import rms_norm as cuda_rms_norm

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


@pytest.mark.parametrize("with_weight", [False, True])
@pytest.mark.parametrize("transposed", [False, True])
def test_rms_norm_bwd_plain_matches_autograd(with_weight, transposed):
    """The backward kernel's twin equals autograd of the plain forward's
    expression, both in float64 (to 1e-12; `rms_norm_plain` itself computes
    in fp32), on a dense and on a transposed (B, H, L, D) input."""
    x = torch.from_numpy(_rand(2, 5, 3, 16).astype(np.float64) * 3.0)
    if transposed:
        x = x.transpose(1, 2)
    w = torch.from_numpy(1.0 + 0.1 * _rand(16, seed=1).astype(np.float64)) if with_weight else None
    g = torch.from_numpy(_rand(*x.shape, seed=2).astype(np.float64))
    xa = x.clone().requires_grad_(True)
    wa = None if w is None else w.clone().requires_grad_(True)
    y = xa * torch.rsqrt(xa.pow(2).mean(-1, keepdim=True) + 1e-6)
    if with_weight:
        y = y * wa
    want = torch.autograd.grad(y, [xa] + ([wa] if with_weight else []), g)
    dx, dw = tnorms.rms_norm_bwd_plain(x, w, g)
    assert dx.dtype == torch.float64
    torch.testing.assert_close(dx, want[0], atol=1e-12, rtol=1e-12)
    if with_weight:
        torch.testing.assert_close(dw, want[1], atol=1e-12, rtol=1e-12)
    else:
        assert dw is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_weight", [False, True])
def test_rms_norm_cpu_path_is_the_plain_expression(dtype, with_weight):
    """On the CPU `rms_norm` is the expression the port always ran, bit for
    bit, with its gradients (plain autograd)."""
    x = torch.from_numpy(_rand(3, 7, 40) * 2.0).to(dtype).requires_grad_(True)
    w = (torch.from_numpy(1.0 + 0.1 * _rand(40, seed=1)).to(dtype).requires_grad_(True)
         if with_weight else None)
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + 1e-6)
    want = (y * w.float() if with_weight else y).to(dtype)
    got = tnorms.rms_norm(x, w)
    assert torch.equal(got, want)
    g = torch.from_numpy(_rand(3, 7, 40, seed=3)).to(dtype)
    params = [x] + ([w] if with_weight else [])
    for a, b in zip(torch.autograd.grad(got, params, g), torch.autograd.grad(want, params, g)):
        assert torch.equal(a, b)


def test_rms_norm_raises_off_the_cpu_and_the_card():
    with pytest.raises(ValueError, match="CUDA tensors"):
        tnorms.rms_norm(torch.empty(2, 8, device="meta"))


def test_rms_norm_kernel_is_built_and_imports_without_nvcc(tmp_path):
    """`build.SOURCES` lists the kernel's source, which exists, and the
    wrapper imports where no nvcc can be found (the library is built at
    the first launch, never at import)."""
    import subprocess
    import sys

    from f_lite_tpu_torch.ops.cuda import build

    assert "rms_norm" in build.SOURCES
    assert (build.CSRC / "rms_norm.cu").exists()
    assert build.library_path("rms_norm").name.startswith("librms_norm-")
    code = ("import f_lite_tpu_torch.ops.cuda.rms_norm as m, f_lite_tpu_torch.ops.cuda.build as b\n"
            "try:\n    b.nvcc_path()\nexcept RuntimeError:\n    print('no nvcc', m.LAUNCHES.count)\n")
    env = {"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path), "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, cwd=Path(__file__).resolve().parents[1], timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "no nvcc 0"


def _strided(kind):
    base = torch.zeros(2, 5, 3, 16)
    return {"contiguous": base, "transposed": base.transpose(1, 2),
            "permuted": base.permute(2, 0, 1, 3), "one_row": base[:1, :1, :1],
            "sliced_d": base[..., :15], "every_other_row": base[:, ::2],
            "expanded": torch.zeros(5, 1, 16).expand(5, 3, 16),
            "last_dim_strided": base.transpose(-1, -2)}[kind]


@pytest.mark.parametrize("kind,dense", [
    ("contiguous", True), ("transposed", True), ("permuted", True), ("one_row", True),
    ("sliced_d", False), ("every_other_row", False), ("expanded", False),
    ("last_dim_strided", False)])
def test_rms_norm_dense_rows(kind, dense):
    """The kernel takes a tensor in place where its rows fill its memory,
    one after another; `torch.empty_like` then lays the output out the same."""
    x = _strided(kind)
    assert cuda_rms_norm.dense_rows(x) is dense
    if dense:
        y = torch.empty_like(x)
        assert all(a == b for a, b, s in zip(y.stride(), x.stride(), x.shape) if s != 1)


@pytest.mark.parametrize("kind", ["kv_slice", "head_slice", "every_other_row", "contiguous",
                                  "transposed"])
def test_rms_norm_kernel_input_holds_every_row(kind):
    """What the kernel reads (`kernel_input`) holds x's rows one after
    another from its data pointer: x itself where x is dense, else a
    contiguous copy; y (`torch.empty_like` of it) then has the plain
    path's layout where x is dense, and is contiguous where x is not (the
    cross-attention's k, a slice of the key-value product; the head's
    tokens without the registers)."""
    base = torch.arange(4 * 6 * 2 * 3 * 8, dtype=torch.float64)
    x = {"kv_slice": base.view(4, 6, 2, 3, 8).permute(2, 0, 3, 1, 4)[0],
         "head_slice": base[:480].view(4, 15, 8)[:, 3:],
         "every_other_row": base[:480].view(4, 15, 8)[:, ::2],
         "contiguous": base[:480].view(4, 15, 8),
         "transposed": base[:480].view(4, 5, 3, 8).transpose(1, 2)}[kind]
    kx = cuda_rms_norm.kernel_input(x)
    dense = kind in ("contiguous", "transposed")
    assert (kx is x) is dense and torch.equal(kx, x)
    memory = torch.as_strided(kx, (kx.numel(),), (1,))
    assert sorted(memory.view(-1, 8)[:, 0].tolist()) == sorted(x[..., 0].flatten().tolist())
    y = torch.empty_like(kx)
    if dense:
        assert y.stride() == tnorms.rms_norm_plain(x).stride()
    else:
        assert y.is_contiguous()


def test_rms_norm_gradient_follows_the_input_layout():
    """The backward brings the upstream gradient into x's layout: a
    contiguous g for a transposed x becomes a copy with x's strides."""
    x = torch.randn(2, 5, 3, 16).transpose(1, 2)
    g = torch.randn(2, 3, 5, 16)
    like = cuda_rms_norm._like(g, x)
    assert like.stride() == x.stride() and torch.equal(like, g)
    same = torch.randn(2, 5, 3, 16).transpose(1, 2)
    assert cuda_rms_norm._like(same, x) is same


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
