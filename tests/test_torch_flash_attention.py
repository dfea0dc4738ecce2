"""The port's flash-attention forward against the JAX Pallas kernel.

On the CPU the port's wrapper computes its plain version; the Pallas kernel
runs in interpret mode, as tests/test_flash_attention.py runs it. fp32,
atol 1e-5 (summation order differs). The Hopper kernel itself is held to
the plain version on the card by tests/test_torch_cuda.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f_lite_tpu.ops.pallas.flash_attention import flash_attention as jax_fa
from f_lite_tpu_torch.ops import attention as tattn
from f_lite_tpu_torch.ops.cuda import flash_attention as tfa

jax_fa = functools.partial(jax_fa, interpret=True)

CASES = [
    # b, h, lq, lk, d, kv_lens
    (1, 2, 64, 64, 64, None),
    (2, 2, 130, 72, 64, [72, 0]),
    (3, 1, 33, 77, 64, [77, 0, 41]),
    (2, 1, 97, 130, 256, [0, 93]),
    (1, 2, 40, 40, 256, None),
]


def _qkv(b, h, lq, lk, d, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, h, lq, d).astype(np.float32),
            rs.randn(b, h, lk, d).astype(np.float32),
            rs.randn(b, h, lk, d).astype(np.float32))


@pytest.mark.parametrize("b,h,lq,lk,d,kv_lens", CASES)
def test_plain_and_attention_match_pallas(b, h, lq, lk, d, kv_lens):
    q, k, v = _qkv(b, h, lq, lk, d)
    lens = None if kv_lens is None else np.asarray(kv_lens, np.int32)
    want = np.asarray(jax_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             kv_lens=None if lens is None else jnp.asarray(lens)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tlens = None if lens is None else torch.from_numpy(lens)
    tfa.LAUNCHES.reset()
    got = tfa.flash_attention_plain(tq, tk, tv, tlens)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    if lens is not None:
        assert not got[torch.from_numpy(lens == 0)].any()  # kv_len 0 -> zeros
        mask = torch.arange(lk)[None, :] < tlens[:, None]
    else:
        mask = None
    via_dispatch = tattn.attention(tq, tk, tv, kv_mask=mask)
    np.testing.assert_allclose(via_dispatch.numpy(), want, atol=1e-5, rtol=0)
    assert tfa.LAUNCHES.count == 0  # CPU tensors never launch the kernel


def test_plain_custom_scale():
    q, k, v = _qkv(1, 2, 64, 48, 64, seed=3)
    want = np.asarray(jax_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             scale=0.5))
    got = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)), scale=0.5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 1, 8, 64, dtype=torch.float16)
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))


def _bf16_kernel_rounding(q, k, v, kv_lens):
    """What the bf16 kernel does to the numbers, on the CPU: fp32 logits and
    softmax statistics, P rounded to bf16 before P V, the output rounded to
    bf16."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
    if kv_lens is not None:
        ok = torch.arange(k.shape[2])[None, :] < torch.tensor(kv_lens)[:, None]
        logits = logits.masked_fill(~ok[:, None, None, :], float("-inf"))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    o = torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(), v)
    return (o / p.sum(-1, keepdim=True)).bfloat16().float()


# the serving paths' kinds of call, at fewer query rows
@pytest.mark.parametrize("b,h,lq,lk,d,kv_lens", [
    (1, 2, 256, 1024, 256, None),
    (2, 2, 256, 128, 256, [77, 128]),
    (4, 2, 256, 32, 64, [32, 17, 32, 5]),
])
def test_bf16_tolerance_passes_rounding_and_fails_mistakes(b, h, lq, lk, d,
                                                          kv_lens):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, h, n, d, generator=g).bfloat16().float()
               for n in (lq, lk, lk))
    ref = tfa.flash_attention_plain(q, k, v, kv_lens)
    tol = tfa.tolerance(ref, torch.bfloat16)
    assert tfa.tolerance(ref, torch.float32) == 1e-5

    def err(out):
        return float((out - ref).abs().max())

    assert err(_bf16_kernel_rounding(q, k, v, kv_lens)) < 0.6 * tol
    scale = d**-0.5
    assert err(tfa.flash_attention_plain(q, k, v, kv_lens, scale=scale * 1.02)) > 2 * tol
    lens = kv_lens or [lk] * b
    assert err(tfa.flash_attention_plain(q, k, v, [n - 1 for n in lens])) > 2 * tol
    if kv_lens is not None:
        extra = [min(n + 1, lk) for n in lens]
        assert err(tfa.flash_attention_plain(q, k, v, extra)) > 2 * tol


def test_chip_smoke_bound_of_the_7b_self_attention():
    import chip_smoke

    ms, by = chip_smoke.attention_bound_ms(2, 10, 4112, 4112, 256, None,
                                           "bfloat16")
    assert by == "operations"
    assert abs(ms - 4 * 2 * 10 * 4112**2 * 256 / 989e12 * 1e3) < 1e-9
    assert 0.349 < ms < 0.351
    ms, by = chip_smoke.attention_bound_ms(2, 10, 4112, 128, 256, [77, 128],
                                           "bfloat16")
    assert by == "bytes" and 0.02 < ms < 0.03
