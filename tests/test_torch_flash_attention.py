"""The port's flash attention, forward and backward, against the JAX
Pallas kernels.

On the CPU the port's wrapper computes its plain versions (the backward
through its autograd Function); the Pallas kernels run in interpret mode,
as tests/test_flash_attention.py runs them. fp32: forward atol 1e-5,
gradients < 3e-6 (summation order differs). The Hopper kernels themselves
are held to the plain versions on the card by tests/test_torch_cuda.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f_lite_tpu.ops.pallas.flash_attention import _flash_forward
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
    # the Hopper forward's tile edges: a 16-row last query tile with fewer
    # keys than a tile; a 1-row last query tile with kv_len inside the last
    # key tile, 0, and a multiple of the tile
    (1, 2, 144, 32, 256, None),
    (3, 1, 129, 200, 64, [150, 0, 128]),
    # head dims the card pads along D (to 256): the wrapper's result must
    # still be the reference's
    (2, 2, 97, 70, 96, [70, 33]),
    (1, 2, 64, 64, 128, None),
    (2, 1, 33, 48, 128, [0, 48]),
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


def _lens(kv_lens):
    return None if kv_lens is None else np.asarray(kv_lens, np.int32)


@pytest.mark.parametrize("b,h,lq,lk,d,kv_lens", CASES)
def test_grads_match_jax_vjp_and_plain_autograd(b, h, lq, lk, d, kv_lens):
    """dq, dk, dv through the port's autograd Function (plain backward on
    the CPU) against jax.vjp of the Pallas kernels and against torch
    autograd through `flash_attention_plain`: max abs diff < 3e-6."""
    q, k, v = _qkv(b, h, lq, lk, d, seed=1)
    g = np.random.RandomState(2).randn(b, h, lq, d).astype(np.float32)
    lens = _lens(kv_lens)
    jl = None if lens is None else jnp.asarray(lens)
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_fa(q_, k_, v_, kv_lens=jl),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]

    tlens = None if lens is None else torch.from_numpy(lens)
    tfa.DQ_LAUNCHES.reset()
    tfa.DKV_LAUNCHES.reset()
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tfa.flash_attention(*ins, tlens).backward(torch.from_numpy(g))
    plain_ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tfa.flash_attention_plain(*plain_ins, tlens).backward(torch.from_numpy(g))
    assert tfa.DQ_LAUNCHES.count == tfa.DKV_LAUNCHES.count == 0
    for name, got, plain, ref in zip("qkv", ins, plain_ins, want):
        assert np.abs(ref).max() > 0.1, name
        assert float(np.abs(got.grad.numpy() - ref).max()) < 3e-6, name
        assert float(np.abs(got.grad.numpy() - plain.grad.numpy()).max()) < 3e-6, name
    if lens is not None:
        dead = torch.from_numpy(lens == 0)
        assert not ins[0].grad[dead].any()  # kv_len 0 rows: dq = 0
        masked = torch.arange(lk)[None, :] >= tlens[:, None]  # (B, Lk)
        for t in ins[1:]:
            assert not t.grad.transpose(1, 2)[masked].any()  # dk = dv = 0


@pytest.mark.parametrize("b,h,lq,lk,d,kv_lens", CASES)
def test_lse_matches_the_pallas_forward(b, h, lq, lk, d, kv_lens):
    q, k, _ = _qkv(b, h, lq, lk, d, seed=3)
    lens = _lens(kv_lens)
    _, lse = _flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
        None if lens is None else jnp.asarray(lens), d**-0.5, 128, 128,
        True, save_lse=True)
    want = np.asarray(lse)[:, :, :lq, 0]
    got = tfa.flash_attention_lse_plain(
        torch.from_numpy(q), torch.from_numpy(k),
        None if lens is None else torch.from_numpy(lens)).numpy()
    live = np.ones(b, bool) if lens is None else lens > 0
    np.testing.assert_allclose(got[live], want[live], atol=1e-5, rtol=1e-6)
    assert (got[~live] == tfa.LSE_EMPTY).all() and (want[~live] < -1e38).all()


def test_bwd_plain_is_the_gradient_of_the_plain_forward():
    """flash_attention_bwd with an explicit lse and delta equals autograd
    through the plain forward, and the no-grad path runs the LSE-free
    forward."""
    q, k, v = _qkv(2, 2, 40, 24, 64, seed=4)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    lens = torch.tensor([24, 9])
    g = torch.randn(2, 2, 40, 64, generator=torch.Generator().manual_seed(0))
    out = tfa.flash_attention_plain(tq, tk, tv, lens)
    lse = tfa.flash_attention_lse_plain(tq, tk, lens)
    got = tfa.flash_attention_bwd(tq, tk, tv, g, lse,
                                  tfa.attention_delta(out, g), lens)
    ins = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    tfa.flash_attention_plain(*ins, lens).backward(g)
    for a, b in zip(got, ins):
        torch.testing.assert_close(a, b.grad, atol=3e-6, rtol=0)
    with torch.no_grad():
        y = tfa.flash_attention(*ins, lens)
    assert y.grad_fn is None and torch.equal(y, out)


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
    # 1280 px: 6416 tokens
    ms, by = chip_smoke.attention_bound_ms(2, 10, 6416, 6416, 256, None,
                                           "bfloat16")
    assert by == "operations"
    assert abs(ms - 4 * 2 * 10 * 6416**2 * 256 / 989e12 * 1e3) < 1e-9
    assert 0.851 < ms < 0.853
    ms, by = chip_smoke.attention_bound_ms(2, 10, 6416, 128, 256, [77, 128],
                                           "bfloat16")
    nbytes = 2 * (2 * 2 * 10 * 6416 * 256 + 2 * 10 * 256 * (77 + 128))
    assert by == "bytes" and abs(ms - nbytes / 3.35e12 * 1e3) < 1e-9
    assert 0.039 < ms < 0.040


@pytest.mark.parametrize("b,h,lq,lk,d,kv_lens", [
    (1, 2, 256, 1024, 256, None),
    (2, 2, 256, 128, 256, [77, 128]),
    (4, 2, 256, 32, 64, [32, 17, 32, 5]),
])
def test_bwd_bf16_tolerance_passes_rounding_and_fails_mistakes(b, h, lq, lk, d,
                                                              kv_lens):
    """The card holds the bf16 backward kernels to the plain version on the
    same bf16 inputs (P and dS rounded to bf16 where the kernels round
    them) with `grad_tolerance`. Correct arithmetic rounded elsewhere (the
    unrounded fp32 gradient, rounded to bf16 at the end) passes; a softmax
    scale 2% off or one key too few fails every gradient by 2x or more."""
    g = torch.Generator().manual_seed(0)
    q, k, v, dout = (torch.randn(b, h, n, d, generator=g).bfloat16()
                     for n in (lq, lk, lk, lq))
    lens = None if kv_lens is None else torch.tensor(kv_lens)

    def grads(q_, k_, v_, do_, kv, scale=None):
        qf, kf, vf = q_.float(), k_.float(), v_.float()
        lse = tfa.flash_attention_lse_plain(qf, kf, kv, scale=scale)
        delta = tfa.attention_delta(
            tfa.flash_attention_plain(qf, kf, vf, kv, scale=scale), do_.float())
        return tfa.flash_attention_bwd_plain(q_, k_, v_, do_, lse, delta, kv,
                                             scale=scale, out_dtype=torch.float32)

    want = grads(q, k, v, dout, lens)
    tols = [tfa.grad_tolerance(w, torch.bfloat16) for w in want]

    def ratios(got):
        return [float((a - w).abs().max()) / t for a, w, t in zip(got, want, tols)]

    unrounded = grads(q.float(), k.float(), v.float(), dout.float(), lens)
    assert max(ratios([x.bfloat16().float() for x in unrounded])) < 1.0
    assert min(ratios(grads(q, k, v, dout, lens, scale=d**-0.5 * 1.02))) > 2.0
    fewer = torch.tensor([n - 1 for n in (kv_lens or [lk] * b)])
    assert min(ratios(grads(q, k, v, dout, fewer))) > 2.0


@pytest.mark.parametrize("label,lq,lk,kv_lens", [
    ("7b1280_self", 6416, 6416, None),
    ("7b1280_cross", 6416, 128, [77, 128]),
])
def test_chip_smoke_times_the_1280px_attention(label, lq, lk, kv_lens):
    """chip_smoke's phase 3 holds the forward kernel at the 1280 px serving
    calls (6416 tokens: 16 registers + 80x80 patches, 50 query tiles of 128
    with a 16-row last one) beside the 1024 px ones."""
    import chip_smoke

    shapes = {s[0]: s[1:] for s in chip_smoke.ATTN_SHAPES}
    assert shapes[label] == (2, 10, lq, lk, 256, kv_lens)
    assert lq == 16 + (1280 // 16) ** 2 and lq % 128 == 16
    assert shapes["7b_self"][2] == 16 + (1024 // 16) ** 2


def test_check_aligned_refuses_an_odd_storage_offset():
    """The forward's TMA loads need 16-byte aligned q, k, v: a contiguous
    view at a storage offset of 2 elements is refused, never copied."""
    flat = torch.zeros(2 + 2 * 64, dtype=torch.bfloat16)
    aligned = flat[:128].view(2, 64)
    odd = flat[2:].view(2, 64)
    assert aligned.data_ptr() % 16 == 0 and odd.is_contiguous()
    tfa.check_aligned(aligned, aligned, aligned)
    with pytest.raises(ValueError, match="k at address .* not 16-byte aligned"):
        tfa.check_aligned(aligned, odd, aligned)


@pytest.mark.parametrize("d,want", [
    (32, 64), (64, 64), (96, 256), (128, 256), (192, 256), (256, 256),
    (257, None),
])
def test_padded_head_dim(d, want):
    """Every D up to 256 runs on a compiled instance (64 or 256); a larger
    one raises."""
    if want is None:
        with pytest.raises(ValueError, match="head dim 257"):
            tfa.padded_head_dim(d)
    else:
        assert tfa.padded_head_dim(d) == want
        x = torch.ones(2, 3, d)
        padded = tfa.pad_head_dim(x)
        assert padded.shape == (2, 3, want) and padded.is_contiguous()
        assert torch.equal(padded[..., :d], x) and not padded[..., d:].any()


@pytest.mark.parametrize("d", [32, 96, 128, 192])
def test_zero_padding_along_d_is_exact(d):
    """What the card's wrapper does at a D it has no instance for: zero-pad
    q, k, v and dO along D, run the computation at the padded D with the
    true D's scale, slice back. fp32, against the plain versions at the
    true D: forward, lse and every gradient."""
    b, h, lq, lk = 2, 2, 40, 24
    q, k, v = (torch.from_numpy(x) for x in _qkv(b, h, lq, lk, d, seed=5))
    dout = torch.from_numpy(np.random.RandomState(6).randn(b, h, lq, d)
                            .astype(np.float32))
    lens = torch.tensor([24, 9])
    scale = d**-0.5
    qp, kp, vp, dop = (tfa.pad_head_dim(x) for x in (q, k, v, dout))
    assert qp.shape[-1] == tfa.padded_head_dim(d) > d

    out = tfa.flash_attention_plain(q, k, v, lens, scale=scale)
    out_p = tfa.flash_attention_plain(qp, kp, vp, lens, scale=scale)
    torch.testing.assert_close(out_p[..., :d], out, atol=1e-6, rtol=0)
    assert not out_p[..., d:].any()
    lse = tfa.flash_attention_lse_plain(q, k, lens, scale=scale)
    torch.testing.assert_close(tfa.flash_attention_lse_plain(qp, kp, lens, scale=scale),
                               lse, atol=1e-6, rtol=0)
    delta = tfa.attention_delta(out, dout)
    torch.testing.assert_close(tfa.attention_delta(out_p, dop), delta,
                               atol=1e-6, rtol=0)
    want = tfa.flash_attention_bwd_plain(q, k, v, dout, lse, delta, lens,
                                         scale=scale)
    got = tfa.flash_attention_bwd_plain(qp, kp, vp, dop, lse, delta, lens,
                                        scale=scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g[..., :d], w, atol=1e-6, rtol=0, msg=name)
        assert not g[..., d:].any(), name


def test_padded_stat_rows_leave_the_backward_unchanged():
    """The bf16 backward kernels read lse and delta with rows padded to a
    multiple of STAT_ROWS (zeros), beside q and dO rows that TMA zero-fills
    past Lq. Those rows add nothing: the plain backward on the padded rows
    gives the same dk and dv, and the same dq on the real rows."""
    b, h, lq, lk, d = 2, 2, 97, 40, 64
    q, k, v = (torch.from_numpy(x) for x in _qkv(b, h, lq, lk, d, seed=7))
    dout = torch.from_numpy(np.random.RandomState(8).randn(b, h, lq, d)
                            .astype(np.float32))
    lens = torch.tensor([40, 13])
    lse = tfa.flash_attention_lse_plain(q, k, lens)
    delta = tfa.attention_delta(tfa.flash_attention_plain(q, k, v, lens), dout)
    lse_p, delta_p = tfa.pad_stat_rows(lse), tfa.pad_stat_rows(delta)
    rows = lse_p.shape[-1]
    assert rows % tfa.STAT_ROWS == 0 and rows - lq < tfa.STAT_ROWS
    assert lse_p.is_contiguous() and lse_p.dtype == torch.float32
    # a transposed view whose rows are a multiple already comes back
    # contiguous too
    assert tfa.pad_stat_rows(torch.zeros(128, 2, 2).permute(1, 2, 0)).is_contiguous()
    assert torch.equal(lse_p[..., :lq], lse) and not lse_p[..., lq:].any()
    assert torch.equal(delta_p[..., :lq], delta) and not delta_p[..., lq:].any()

    def zero_rows(x):  # q or dO: rows are dim 2
        return torch.nn.functional.pad(x, (0, 0, 0, rows - lq))

    want = tfa.flash_attention_bwd_plain(q, k, v, dout, lse, delta, lens)
    got = tfa.flash_attention_bwd_plain(zero_rows(q), k, v, zero_rows(dout),
                                        lse_p, delta_p, lens)
    assert torch.equal(got[0][:, :, :lq], want[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_chip_smoke_backward_bounds_and_padded_shape():
    """chip_smoke's phase 4 holds the backward kernels at the 7B training
    self-attention (bounds: dq 3 products, dkv 4, over 4x10x1040x1040x256)
    and at a head dim the wrapper pads to 256 (128)."""
    import chip_smoke

    flops = 2 * 4 * 10 * 1040 * 1040 * 256 / 989e12 * 1e3
    for which, products in (("dq", 3), ("dkv", 4), ("pair", 7)):
        ms, by = chip_smoke.backward_bound_ms(4, 10, 1040, 1040, 256, None,
                                              "bfloat16", which)
        assert by == "operations" and abs(ms - products * flops) < 1e-12
    shapes = {s[0]: s[1:] for s in chip_smoke.BWD_SHAPES}
    b, h, lq, lk, d, kv = shapes["7b_d128"]
    assert d not in tfa.HEAD_DIMS and tfa.padded_head_dim(d) == 256
    assert (b, h, lq, lk) == shapes["7b_self"][:4]
