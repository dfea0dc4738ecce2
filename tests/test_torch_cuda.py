"""Tests of the port that need an NVIDIA GPU: the Hopper kernels (forward,
dq, dkv, the lab's variants, the int8 quantize and product) against their
plain versions, and the DiT's gradients, a training step and the pipeline
(bf16 and int8) on the card against the same code on the CPU. They skip
without a card. This file imports no JAX, so it also runs
on a GPU host without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from f_lite_tpu_torch.models.dit import DiT, DiTConfig
from f_lite_tpu_torch.ops.cuda import flash_attention as tfa
from f_lite_tpu_torch.ops.cuda import flash_variants as tfv
from f_lite_tpu_torch.ops.cuda import int8_gemm as tig
from f_lite_tpu_torch.pipeline import FLitePipeline
from f_lite_tpu_torch.quant import quantize_weight
from f_lite_tpu_torch.tools import int8_tiles
from f_lite_tpu_torch.text.encoder import ZeroTextEncoder
from f_lite_tpu_torch.train.optim import build_optimizer
from f_lite_tpu_torch.train.step import TrainState, train_step
from f_lite_tpu_torch.utils.random_weights import randomize_

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "artifacts" / "fixture_run" / "pipeline"

# b, h, lq, lk, d, kv_lens
CASES = [
    (1, 2, 64, 64, 64, None),
    (2, 2, 130, 72, 64, [72, 0]),
    (3, 1, 33, 77, 64, [77, 0, 41]),
    (2, 1, 97, 130, 256, [0, 93]),
    (1, 2, 40, 40, 256, None),
    (2, 4, 1040, 32, 64, [32, 17]),
    # the forward's tile edges (128 query rows a block; 80 keys a tile at
    # D = 256, 32 at D = 64): a last query tile of 16 rows (4112 % 128) and
    # of 1 row (129)
    (1, 2, 144, 144, 256, None),
    (1, 2, 144, 96, 64, None),
    (2, 1, 129, 70, 256, [70, 33]),
    # fewer keys than a tile
    (2, 2, 96, 32, 256, None),
    (2, 2, 96, 20, 64, None),
    # kv_len inside the last tile, 0, and a multiple of the tile
    (3, 1, 200, 256, 256, [150, 0, 160]),
    (3, 1, 200, 256, 64, [150, 64, 256]),
    # more blocks than the card holds at once
    (2, 40, 256, 256, 256, None),
    (3, 50, 256, 200, 64, None),
]

# the backward kernels' tile edges: the dq kernel's 128 q rows a block and
# 48 keys a tile (32 at D = 64); the dkv kernel's 64 keys a block (128 at
# D = 64) and 64 q rows a tile. q rows past a tile (333, 129, 97); kv_len
# 0, inside the last tile and a multiple of the tiles; fewer keys than a
# tile.
BWD_EDGES = [
    (2, 2, 333, 333, 256, [333, 200]),
    (3, 1, 333, 77, 64, [77, 0, 41]),
    (2, 1, 129, 192, 256, [64, 192]),
    (2, 1, 129, 300, 64, [128, 257]),
    (2, 2, 97, 20, 64, None),
    (2, 2, 97, 16, 256, [16, 0]),
    (2, 3, 97, 131, 256, [96, 131]),
    (2, 2, 97, 160, 256, [144, 150]),
    (4, 2, 1040, 128, 256, [77, 128, 0, 33]),
]

# head dims the wrapper zero-pads along D to a compiled instance
PADDED_DIMS = [32, 96, 128, 192]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, h, lq, lk, d, device, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(b, h, n, d, generator=g).to(device, dtype)
                 for n in (lq, lk, lk))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,lq,lk,d,kv_lens", CASES)
def test_kernel_matches_plain(cuda_device, dtype, b, h, lq, lk, d, kv_lens):
    q, k, v = _qkv(b, h, lq, lk, d, cuda_device, dtype)
    lens = None if kv_lens is None else torch.tensor(kv_lens, device=cuda_device)
    before = tfa.LAUNCHES.count
    got = tfa.flash_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES.count == before + 1
    want = tfa.flash_attention_plain(q.float(), k.float(), v.float(), lens)
    assert got.dtype == dtype and got.shape == q.shape
    assert float((got.float() - want).abs().max()) <= tfa.tolerance(want, dtype)
    if kv_lens is not None:
        zero = torch.tensor(kv_lens, device=cuda_device) == 0
        assert not got[zero].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,lq,lk,d,kv_lens", CASES)
def test_forward_lse_matches_plain(cuda_device, dtype, b, h, lq, lk, d, kv_lens):
    q, k, v = _qkv(b, h, lq, lk, d, cuda_device, dtype)
    lens = None if kv_lens is None else torch.tensor(kv_lens, device=cuda_device)
    out, lse = tfa.flash_attention_fwd_lse(q, k, v, lens)
    want = tfa.flash_attention_lse_plain(q.float(), k.float(), lens)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, lq)
    torch.testing.assert_close(out, tfa.flash_attention(q, k, v, lens),
                               atol=0, rtol=0)
    live = torch.ones(b, dtype=torch.bool, device=cuda_device) if lens is None else lens > 0
    torch.testing.assert_close(lse[live], want[live], rtol=0,
                               atol=1e-4 if dtype == torch.float32 else 2e-2)
    assert bool((lse[~live] < -1e38).all())  # kv_len 0: the sentinel, never read


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,lq,lk,d,kv_lens", CASES + BWD_EDGES)
def test_backward_kernels_match_plain(cuda_device, dtype, b, h, lq, lk, d,
                                      kv_lens):
    """dq and dkv kernels against `flash_attention_bwd_plain` on the same
    inputs (plain in fp32): `grad_tolerance`, exact zeros at masked keys
    and at kv_len 0 rows, one launch each."""
    q, k, v = _qkv(b, h, lq, lk, d, cuda_device, dtype)
    dout = _qkv(b, h, lq, lq, d, cuda_device, dtype, seed=1)[0]
    lens = None if kv_lens is None else torch.tensor(kv_lens, device=cuda_device)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, dout))
    lse = tfa.flash_attention_lse_plain(qf, kf, lens)
    delta = tfa.attention_delta(tfa.flash_attention_plain(qf, kf, vf, lens), dof)
    before = (tfa.DQ_LAUNCHES.count, tfa.DKV_LAUNCHES.count)
    got = tfa.flash_attention_bwd(q, k, v, dout, lse, delta, lens)
    torch.cuda.synchronize()
    assert (tfa.DQ_LAUNCHES.count, tfa.DKV_LAUNCHES.count) == (
        before[0] + 1, before[1] + 1)
    want = tfa.flash_attention_bwd_plain(q, k, v, dout, lse, delta, lens,
                                         out_dtype=torch.float32)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        err = float((g.float() - w).abs().max())
        assert err <= tfa.grad_tolerance(w, dtype), (name, err)
    if kv_lens is not None:
        assert not got[0][lens == 0].any()
        masked = torch.arange(lk, device=cuda_device)[None, :] >= lens[:, None]
        for g in got[1:]:
            assert not g.transpose(1, 2)[masked].any()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 256])
def test_kernel_is_deterministic(cuda_device, d):
    """Two launches on the same inputs give the same bits (output and lse,
    and dq, dk, dv of the backward kernels): no atomics, no order that
    changes from run to run."""
    q, k, v = _qkv(2, 3, 300, 200, d, cuda_device, torch.bfloat16, seed=3)
    lens = torch.tensor([200, 77], device=cuda_device)
    first = tfa.flash_attention_fwd_lse(q, k, v, lens)
    second = tfa.flash_attention_fwd_lse(q, k, v, lens)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    dout = _qkv(2, 3, 300, 300, d, cuda_device, torch.bfloat16, seed=4)[0]
    delta = tfa.attention_delta(first[0], dout)
    grads = [tfa.flash_attention_bwd(q, k, v, dout, first[1], delta, lens)
             for _ in range(2)]
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", PADDED_DIMS)
def test_padded_head_dims_match_plain(cuda_device, dtype, d):
    """A head dim with no compiled instance runs zero-padded to the next
    one: forward (out and lse) within `tolerance`, dq, dk, dv within
    `grad_tolerance` of the plain versions at the true D, one launch of
    each kernel, exact zeros at kv_len 0 rows and masked keys."""
    b, h, lq, lk = 2, 3, 200, 150
    q, k, v = _qkv(b, h, lq, lk, d, cuda_device, dtype, seed=11)
    dout = _qkv(b, h, lq, lq, d, cuda_device, dtype, seed=12)[0]
    lens = torch.tensor([150, 0], device=cuda_device)
    before = (tfa.LAUNCHES.count, tfa.DQ_LAUNCHES.count, tfa.DKV_LAUNCHES.count)
    out, lse = tfa.flash_attention_fwd_lse(q, k, v, lens)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, dout))
    want = tfa.flash_attention_plain(qf, kf, vf, lens)
    assert out.shape == q.shape and out.dtype == dtype
    assert float((out.float() - want).abs().max()) <= tfa.tolerance(want, dtype)
    want_lse = tfa.flash_attention_lse_plain(qf, kf, lens)
    torch.testing.assert_close(lse[0], want_lse[0], rtol=0,
                               atol=1e-4 if dtype == torch.float32 else 2e-2)
    assert not out[1].any()
    lse_p = tfa.flash_attention_lse_plain(qf, kf, lens)
    delta = tfa.attention_delta(want, dof)
    got = tfa.flash_attention_bwd(q, k, v, dout, lse_p, delta, lens)
    torch.cuda.synchronize()
    after = (tfa.LAUNCHES.count, tfa.DQ_LAUNCHES.count, tfa.DKV_LAUNCHES.count)
    assert [x - y for x, y in zip(after, before)] == [1, 1, 1]
    ref = tfa.flash_attention_bwd_plain(q, k, v, dout, lse_p, delta, lens,
                                        out_dtype=torch.float32)
    for name, g, w in zip(("dq", "dk", "dv"), got, ref):
        assert g.shape == w.shape and g.dtype == dtype, name
        err = float((g.float() - w).abs().max())
        assert err <= tfa.grad_tolerance(w, dtype), (name, err)
    assert not got[0][1].any()
    assert not got[1][:, :, 150:].any() and not got[1][1].any()
    assert not got[2][:, :, 150:].any() and not got[2][1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_raises_on_an_unaligned_q(cuda_device, dtype):
    """A contiguous q at a storage offset of 2 elements is not 16-byte
    aligned: the wrapper raises before any launch and copies nothing."""
    flat = torch.randn(2 + 2 * 2 * 64 * 64, device=cuda_device).to(dtype)
    q = flat[2:].view(2, 2, 64, 64)
    k = torch.randn(2, 2, 64, 64, device=cuda_device).to(dtype)
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    before = tfa.LAUNCHES.count
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.flash_attention(q, k, k)
    assert tfa.LAUNCHES.count == before


@pytest.mark.cuda
def test_autograd_launches_the_backward_kernels(cuda_device):
    q, k, v = (x.requires_grad_() for x in _qkv(2, 2, 70, 70, 64, cuda_device,
                                                 torch.bfloat16))
    before = (tfa.LAUNCHES.count, tfa.DQ_LAUNCHES.count, tfa.DKV_LAUNCHES.count)
    tfa.flash_attention(q, k, v).float().square().sum().backward()
    torch.cuda.synchronize()
    after = (tfa.LAUNCHES.count, tfa.DQ_LAUNCHES.count, tfa.DKV_LAUNCHES.count)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in (q, k, v))


@pytest.mark.cuda
def test_kernel_takes_transposed_views(cuda_device):
    q, k, v = _qkv(2, 3, 50, 50, 64, cuda_device, torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
    assert not qt.is_contiguous()
    torch.testing.assert_close(tfa.flash_attention(qt, kt, vt),
                               tfa.flash_attention(q, k, v), atol=0, rtol=0)


@pytest.mark.cuda
def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    q = torch.zeros(1, 1, 8, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        tfa.flash_attention(q, q, q)
    q = torch.zeros(1, 1, 8, 320, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(tfv.VARIANTS))
@pytest.mark.parametrize("b,h,l,d", [(1, 2, 333, 64), (1, 2, 333, 256),
                                     (2, 1, 256, 64)])
def test_variant_kernel_matches_plain(cuda_device, variant, b, h, l, d):
    """Kernel #4 at every block pair compiled for its head dim
    (`blocks(d)`) against `flash_fwd_plain` at the same block_k (plain in
    fp32 on the same bf16 inputs), within `flash_attention.tolerance`;
    ragged (333) and whole (256) key tiles."""
    kw = tfv.VARIANTS[variant]
    q, k, v = _qkv(b, h, l, l, d, cuda_device, torch.bfloat16, seed=7)
    for bq, bk in tfv.blocks(d):
        before = tfv.LAUNCHES.count
        got = tfv.flash_fwd(q, k, v, block_q=bq, block_k=bk, **kw)
        torch.cuda.synchronize()
        assert tfv.LAUNCHES.count == before + 1
        want = tfv.flash_fwd_plain(q, k, v, block_k=bk, out_dtype=torch.float32,
                                   **kw)
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        err = float((got.float() - want).abs().max())
        assert err <= tfa.tolerance(want, torch.bfloat16), (bq, bk, err)


@pytest.mark.cuda
@pytest.mark.parametrize("d", PADDED_DIMS)
def test_variant_padded_head_dims_match_plain(cuda_device, d):
    """A head dim with no compiled instance runs zero-padded to the next
    one (blocks of that one): every variant at every pair of `blocks(d)`
    within `tolerance` of `flash_fwd_plain` at the true D, sliced back to
    D, one launch each."""
    q, k, v = _qkv(1, 2, 333, 333, d, cuda_device, torch.bfloat16, seed=13)
    assert tfv.blocks(d) == tfv.BLOCKS[tfa.padded_head_dim(d)]
    for bq, bk in tfv.blocks(d):
        for name, kw in tfv.VARIANTS.items():
            before = tfv.LAUNCHES.count
            got = tfv.flash_fwd(q, k, v, block_q=bq, block_k=bk, **kw)
            torch.cuda.synchronize()
            assert tfv.LAUNCHES.count == before + 1
            assert got.shape == q.shape and got.dtype == torch.bfloat16
            want = tfv.flash_fwd_plain(q, k, v, block_k=bk,
                                       out_dtype=torch.float32, **kw)
            err = float((got.float() - want).abs().max())
            assert err <= tfa.tolerance(want, torch.bfloat16), (bq, bk, name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 256])
def test_variant_flag_branches_round_as_named(cuda_device, d):
    """Each flag branch moves the kernel's output from the plain result of
    the twin without that flag to the plain result of its own variant
    (`flag_step` within FLAG_STEP_TOLERANCE of 1), at the ragged shape and
    every block pair of `blocks(d)`."""
    q, k, v = _qkv(1, 2, 333, 333, d, cuda_device, torch.bfloat16, seed=9)
    for bq, bk in tfv.blocks(d):
        plain = {name: tfv.flash_fwd_plain(q, k, v, block_k=bk,
                                           out_dtype=torch.float32, **kw)
                 for name, kw in tfv.VARIANTS.items()}
        for own, twin in tfv.FLAG_TWINS:
            got = tfv.flash_fwd(q, k, v, block_q=bq, block_k=bk, **tfv.VARIANTS[own])
            c = tfv.flag_step(got, plain[own], plain[twin])
            assert abs(c - 1) < tfv.FLAG_STEP_TOLERANCE, (bq, bk, own, c)


@pytest.mark.cuda
def test_variant_condmask_equals_its_twin(cuda_device):
    """condmask (the mask on the straddling tile only) gives its twin's
    bits, at both compiled head dims and every pair of `blocks(d)`."""
    for d in (256, 64):
        q, k, v = _qkv(1, 2, 333, 333, d, cuda_device, torch.bfloat16, seed=8)
        for bq, bk in tfv.blocks(d):
            for twin, masked in (("base", "condmask-e"), ("exp2", "condmask")):
                a = tfv.flash_fwd(q, k, v, block_q=bq, block_k=bk,
                                  **tfv.VARIANTS[twin])
                c = tfv.flash_fwd(q, k, v, block_q=bq, block_k=bk,
                                  **tfv.VARIANTS[masked])
                assert torch.equal(a, c), (d, bq, bk, twin)


@pytest.mark.cuda
def test_variant_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    """fp32, a block pair not compiled for the head dim, a flag set that is
    none of the lab's, D > 256 and a q that is not 16-byte aligned raise
    before any launch. (D = 128 runs: the wrapper pads it to 256.)"""
    before = tfv.LAUNCHES.count
    q = torch.zeros(1, 1, 8, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        tfv.flash_fwd(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="blocks"):
        tfv.flash_fwd(q, q, q, block_q=64, block_k=64)
    with pytest.raises(ValueError, match="blocks"):
        tfv.flash_fwd(q, q, q, block_q=128, block_k=80)
    with pytest.raises(ValueError, match="flag set"):
        tfv.flash_fwd(q, q, q, condmask=True, alpha_bf16=True)
    q = torch.zeros(1, 1, 8, 320, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        tfv.flash_fwd(q, q, q)
    flat = torch.randn(2 + 2 * 2 * 64 * 64, device=cuda_device).to(torch.bfloat16)
    q = flat[2:].view(2, 2, 64, 64)
    k = torch.randn(2, 2, 64, 64, device=cuda_device).to(torch.bfloat16)
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfv.flash_fwd(q, k, k)
    assert tfv.LAUNCHES.count == before


@pytest.mark.cuda
def test_dit_on_the_card_matches_the_cpu(cuda_device):
    cfg = DiTConfig(in_channels=4, hidden_size=256, depth=3, num_heads=4,
                    mlp_ratio=2.0, cross_attn_input_size=32, residual_v=True,
                    cross_attn_first_n=1, cross_attn_period=2)
    cpu = randomize_(DiT(cfg).eval(), seed=0)
    gpu = DiT(cfg).eval()
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(cuda_device)
    rs = np.random.RandomState(1)
    args = (torch.from_numpy(rs.randn(2, 16, 16, 4).astype(np.float32)),
            torch.from_numpy(rs.randn(2, 8, 32).astype(np.float32)),
            torch.from_numpy(np.arange(8)[None] < np.array([[8], [3]])),
            torch.from_numpy(rs.rand(2).astype(np.float32)))
    before = tfa.LAUNCHES.count
    with torch.no_grad():
        want = cpu(*args)
        got = gpu(*(a.to(cuda_device) for a in args)).cpu()
    assert tfa.LAUNCHES.count - before == 3 + 2  # 3 self, 2 cross blocks
    assert float(want.abs().max()) > 1e-2
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def _small_dit_and_inputs():
    cfg = DiTConfig(in_channels=4, hidden_size=256, depth=3, num_heads=4,
                    mlp_ratio=2.0, cross_attn_input_size=32, residual_v=True,
                    cross_attn_first_n=1, cross_attn_period=2)
    cpu = randomize_(DiT(cfg), seed=0)
    rs = np.random.RandomState(1)
    args = (torch.from_numpy(rs.randn(2, 16, 16, 4).astype(np.float32)),
            torch.from_numpy(rs.randn(2, 8, 32).astype(np.float32)),
            torch.from_numpy(np.arange(8)[None] < np.array([[8], [3]])),
            torch.from_numpy(rs.rand(2).astype(np.float32)))
    weight = torch.from_numpy(rs.randn(2, 16, 16, 4).astype(np.float32))
    return cfg, cpu, args, weight


@pytest.mark.cuda
def test_dit_grads_on_the_card_match_the_cpu(cuda_device):
    """Every parameter gradient of a 3-block residual_v DiT, fp32, on the
    card (through the attention kernels) equals the CPU's (plain attention
    under autograd), atol 1e-4: attention must pass gradients on the card."""
    cfg, cpu, args, weight = _small_dit_and_inputs()
    gpu = DiT(cfg)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(cuda_device)
    (cpu(*args) * weight).sum().backward()
    before = (tfa.DQ_LAUNCHES.count, tfa.DKV_LAUNCHES.count)
    (gpu(*(a.to(cuda_device) for a in args)) * weight.to(cuda_device)).sum().backward()
    torch.cuda.synchronize()
    # 3 self-attention and 2 cross-attention calls, each through both kernels
    assert (tfa.DQ_LAUNCHES.count - before[0], tfa.DKV_LAUNCHES.count - before[1]) == (5, 5)
    for (name, pc), (_, pg) in zip(cpu.named_parameters(), gpu.named_parameters()):
        assert pc.grad is not None, name
        assert pg.grad is not None, f"{name}: no gradient on the card"
        torch.testing.assert_close(pg.grad.cpu(), pc.grad, atol=1e-4, rtol=1e-4,
                                   msg=lambda m, n=name: f"{n}: {m}")


@pytest.mark.cuda
def test_dit_with_128_wide_heads_on_the_card_matches_the_cpu(cuda_device):
    """A DiT whose heads are 128 wide (no compiled instance: the kernels
    run it zero-padded to 256), fp32: output and every parameter gradient
    on the card equal the CPU's (plain attention), atol 1e-4."""
    cfg = DiTConfig(in_channels=4, hidden_size=256, depth=3, num_heads=2,
                    mlp_ratio=2.0, cross_attn_input_size=32, residual_v=True,
                    cross_attn_first_n=1, cross_attn_period=2)
    assert cfg.head_dim == 128
    _, _, args, weight = _small_dit_and_inputs()
    cpu = randomize_(DiT(cfg), seed=0)
    gpu = DiT(cfg)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(cuda_device)
    want = cpu(*args)
    (want * weight).sum().backward()
    before = (tfa.LAUNCHES.count, tfa.DQ_LAUNCHES.count, tfa.DKV_LAUNCHES.count)
    got = gpu(*(a.to(cuda_device) for a in args))
    (got * weight.to(cuda_device)).sum().backward()
    torch.cuda.synchronize()
    after = (tfa.LAUNCHES.count, tfa.DQ_LAUNCHES.count, tfa.DKV_LAUNCHES.count)
    assert [x - y for x, y in zip(after, before)] == [5, 5, 5]
    assert float(want.abs().max()) > 1e-2
    torch.testing.assert_close(got.detach().cpu(), want.detach(), atol=1e-4,
                               rtol=1e-4)
    for (name, pc), (_, pg) in zip(cpu.named_parameters(), gpu.named_parameters()):
        assert pg.grad is not None, f"{name}: no gradient on the card"
        torch.testing.assert_close(pg.grad.cpu(), pc.grad, atol=1e-4, rtol=1e-4,
                                   msg=lambda m, n=name: f"{n}: {m}")


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One step of loss -> backward -> clip -> AdamW in fp32, on the same
    weights, batch, timesteps and noise: loss, grad norm and the updated
    parameters agree."""
    cfg, cpu, (x, ctx, mask, _), _ = _small_dit_and_inputs()
    gpu = DiT(cfg)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(cuda_device)
    rs = np.random.RandomState(2)
    t = torch.from_numpy(rs.rand(2).astype(np.float32))
    noise = torch.from_numpy(rs.randn(*x.shape).astype(np.float32))
    metrics = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda_device)):
        opt = build_optimizer(list(model.parameters()), learning_rate=1e-4,
                              lr_scheduler="constant", weight_decay=0.01)
        metrics.append(train_step(
            TrainState(model, opt), x.to(dev), ctx.to(dev), mask.to(dev), uncond_prob=0.0,
            timesteps=t.to(dev), noise=noise.to(dev)))
    torch.cuda.synchronize()
    want, got = metrics
    torch.testing.assert_close(got["loss"].cpu(), want["loss"], rtol=1e-5, atol=0)
    torch.testing.assert_close(got["grad_norm"].cpu(), want["grad_norm"],
                               rtol=1e-4, atol=0)
    for (name, pc), (_, pg) in zip(cpu.named_parameters(), gpu.named_parameters()):
        torch.testing.assert_close(pg.detach().cpu(), pc.detach(), atol=1e-5,
                                   rtol=0, msg=lambda m, n=name: f"{n}: {m}")


@pytest.mark.cuda
def test_fixture_pipeline_on_the_card_matches_the_cpu(cuda_device):
    embeds, mask = ZeroTextEncoder(64, seq_len=32).encode(
        ["a red circle", "a blue square"])
    latents = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    kw = dict(prompt_embeds=embeds, context_mask=mask, latents=latents,
              num_inference_steps=3, output_type="np")
    want = FLitePipeline.from_pretrained(FIXTURE, dtype=torch.float32,
                                         device="cpu")(**kw).images
    got = FLitePipeline.from_pretrained(FIXTURE, dtype=torch.float32)(**kw).images
    assert float(((got - want) ** 2).mean()) < 1e-8


# (N, K) of the int8 paths' projections: the 7B's qkv, proj and q, gate and
# up, down, context_kv; the fixture's; then one n-tile of the persistent
# product kernel's design at the K of its grid-edge checks (not multiples
# of 128; both designs)
INT8_NK = [(7680, 2560), (2560, 2560), (10240, 2560), (2560, 10240),
           (5120, 2560), (768, 256), (256, 256), (1024, 256), (256, 1024),
           (512, 256)] + [(tig.BLOCK_N[tig.gemm_design(k)], k)
                          for k in int8_tiles.EDGE_K]
# one row, a ragged 17, and the 7B's CFG batch of 2 x 4112 tokens
INT8_M = [1, 17, 8224]


def _int8_weight(n, k, seed):
    """(w8, scale, bias) on the card from a seeded weight with two zero
    rows (scale 1, w8 0)."""
    g = torch.Generator("cuda").manual_seed(seed)
    w = torch.randn((n, k), generator=g, device="cuda") * k**-0.5
    w[3] = 0.0
    w[-1] = 0.0
    w8, scale = quantize_weight(w)
    bias = torch.randn((n,), generator=g, device="cuda") * 0.1
    return w8, scale, bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k", INT8_NK)
def test_int8_kernels_match_plain_bit_for_bit(cuda_device, dtype, n, k):
    """x8 and sx, the int32 accumulators and the dequantized output (with
    and without bias) equal the plain versions' bits, at M = 1, 17, 8224,
    with a zero activation row; each call launches its kernel once. At the
    grid-edge K, also at the M values that give the card's SMs - 1, SMs and
    SMs + 1 m-tiles and a partial last round (`int8_tiles.grid_edge_ms`)."""
    w8, scale, bias = _int8_weight(n, k, seed=n + k)
    g = torch.Generator("cuda").manual_seed(k)
    edges = (int8_tiles.grid_edge_ms(tig.num_sms(0))
             if (n, k) in INT8_NK[-len(int8_tiles.EDGE_K):] else [])
    for m in INT8_M + edges:
        x = (torch.randn((m, k), generator=g, device="cuda") * 3).to(dtype)
        if m > 1:
            x[m // 2] = 0.0
        before = (tig.QUANTIZE_LAUNCHES.count, tig.GEMM_LAUNCHES.count)
        x8, sx = tig.quantize_rows(x)
        acc = tig.int8_gemm_int32(x8, w8)
        outs = [tig.int8_gemm_dequant(x8, sx, w8, scale, b, dtype)
                for b in (None, bias)]
        torch.cuda.synchronize()
        after = (tig.QUANTIZE_LAUNCHES.count, tig.GEMM_LAUNCHES.count)
        assert (after[0] - before[0], after[1] - before[1]) == (1, 3)
        x8_want, sx_want = tig.quantize_rows_plain(x)
        assert torch.equal(x8, x8_want), f"x8 at M = {m}"
        assert torch.equal(sx, sx_want), f"sx at M = {m}"
        assert torch.equal(acc, tig.int8_matmul_plain(x8, w8)), f"acc at M = {m}"
        for b, y in zip((None, bias), outs):
            want = tig.int8_linear_plain(x8, sx, w8, scale, b, dtype)
            assert y.dtype == dtype and y.shape == (m, n)
            assert torch.equal(y, want), (
                f"output at M = {m}, bias {b is not None}: max abs diff "
                f"{float((y.float() - want.float()).abs().max())}")


@pytest.mark.cuda
def test_int8_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    w8, scale, _ = _int8_weight(64, 64, seed=0)
    x = torch.randn((8, 64), device="cuda", dtype=torch.bfloat16)
    x8, sx = tig.quantize_rows(x)
    before = (tig.QUANTIZE_LAUNCHES.count, tig.GEMM_LAUNCHES.count)
    with pytest.raises(ValueError, match="multiple of 16"):
        tig.quantize_rows(torch.randn((8, 40), device="cuda"))
    with pytest.raises(TypeError):
        tig.quantize_rows(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        tig.quantize_rows(torch.randn((64, 8), device="cuda").T)
    unaligned = torch.empty(8 * 64 + 16, device="cuda", dtype=torch.int8)[1:513]
    with pytest.raises(ValueError, match="16-byte aligned"):
        tig.int8_gemm_dequant(unaligned.view(8, 64), sx, w8, scale)
    with pytest.raises(ValueError, match="multiple of 8"):
        tig.int8_gemm_dequant(x8, sx, w8[:60].contiguous(), scale[:60])
    with pytest.raises(TypeError):
        tig.int8_gemm_dequant(x8, sx, w8.int(), scale)
    with pytest.raises(ValueError, match="scale"):
        tig.int8_gemm_dequant(x8, sx, w8, scale.double())
    with pytest.raises(ValueError, match="sx"):
        tig.int8_gemm_dequant(x8, sx[:4], w8, scale)
    with pytest.raises(TypeError, match="output dtype"):
        tig.int8_gemm_dequant(x8, sx, w8, scale, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        tig.int8_gemm_dequant(x8, sx, w8.T.contiguous().T, scale)
    assert (tig.QUANTIZE_LAUNCHES.count, tig.GEMM_LAUNCHES.count) == before


@pytest.mark.cuda
def test_quantized_fixture_dit_on_the_card_matches_the_cpu(cuda_device, monkeypatch):
    """The fixture's DiT loaded with quantize=True in fp32, one forward on
    the same inputs, 48 launches of each int8 kernel (6 blocks x (5 + 3
    cross-attention projections)).

    - On the card, the kernels' output equals the same DiT's through the
      plain int8 versions bit for bit.
    - Against the CPU's int8 run it stays within the quantization noise
      (the CPU int8 run's MSE to the CPU fp32 DiT). The CPU run's 1% bar
      against JAX is out of reach here: the card's fp32 DiT differs from
      the CPU's by an MSE near 6e-14, and the int8 DiT turns any such
      difference into x8 rounding flips that compound through the blocks.
      On the CPU alone, scaling the input by 1 + 1e-7 noise moves the int8
      output by 1.1e-6 MSE (the fp32 output by 6e-14), the size of the
      card-vs-CPU gap. The CPU port and JAX agree nearly bit for bit
      upstream, so there are almost no flips between them."""
    from f_lite_tpu_torch import quant

    def load(device, **kw):
        return FLitePipeline.from_pretrained(FIXTURE, dtype=torch.float32,
                                             device=device, **kw).dit
    rs = np.random.RandomState(3)
    args = (torch.from_numpy(rs.randn(2, 64, 64, 3).astype(np.float32)),
            torch.from_numpy(rs.randn(2, 32, 64).astype(np.float32) * 0.02),
            torch.from_numpy(np.arange(32)[None] < np.array([[32], [9]])),
            torch.from_numpy(rs.rand(2).astype(np.float32)))
    gpu_args = tuple(a.to(cuda_device) for a in args)
    gpu = load("cuda", quantize=True)
    with torch.no_grad():
        want = load("cpu", quantize=True)(*args)
        noise = float(((want - load("cpu")(*args)) ** 2).mean())
        fp32_diff = float(((load("cuda")(*gpu_args).cpu() - load("cpu")(*args)) ** 2).mean())
        before = (tig.QUANTIZE_LAUNCHES.count, tig.GEMM_LAUNCHES.count)
        got = gpu(*gpu_args)
        after = (tig.QUANTIZE_LAUNCHES.count, tig.GEMM_LAUNCHES.count)
        monkeypatch.setattr(quant, "quantize_rows", tig.quantize_rows_plain)
        monkeypatch.setattr(quant, "int8_gemm_dequant", tig.int8_linear_plain)
        plain = gpu(*gpu_args)
    assert (after[0] - before[0], after[1] - before[1]) == (48, 48)
    assert torch.equal(got, plain)
    diff = float(((got.cpu() - want) ** 2).mean())
    print(f"card int8 vs cpu int8 MSE {diff}, cpu int8 vs fp32 {noise}, "
          f"card fp32 vs cpu fp32 {fp32_diff}")
    assert 0 < noise and diff <= noise
