"""Tests of the port that need an NVIDIA GPU: the Hopper kernels (forward,
dq, dkv, the lab's variants, the int8 quantize and product, the RMSNorm
forward and backward) against their plain versions, and the DiT's gradients, a training step, the pipeline
(bf16 and int8) and the T5 and Qwen2 text stacks (bf16) on the card against
the same code on the CPU, and the port's spans on the profiler's clock and
`serve`'s device seconds. They skip
without a card. This file imports no JAX, so it also runs
on a GPU host without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from f_lite_tpu_torch.models.dit import DiT, DiTConfig
from f_lite_tpu_torch.ops.cuda import flash_attention as tfa
from f_lite_tpu_torch.ops.cuda import flash_variants as tfv
from f_lite_tpu_torch.ops.cuda import int8_gemm as tig
from f_lite_tpu_torch.pipeline import FLitePipeline
from f_lite_tpu_torch.serve import _device_timed
from f_lite_tpu_torch.quant import quantize_weight
from f_lite_tpu_torch.tools import int8_tiles
from f_lite_tpu_torch.text import qwen2, t5
from f_lite_tpu_torch.text.encoder import ZeroTextEncoder
from f_lite_tpu_torch.train.optim import build_optimizer
from f_lite_tpu_torch.train.step import TrainState, train_step
from f_lite_tpu_torch.utils import trace
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
def test_dots_remat_and_token_indices_on_the_card(cuda_device):
    """On the card, through the kernels: "dots" (blocks 1-2 checkpointed)
    gives the gradients of "full" bit for bit with the same launches (the
    backward runs attention again), and a forward on 8 kept tokens a row
    (`token_indices`) matches the CPU's, atol 1e-4."""
    cfg, cpu, args, weight = _small_dit_and_inputs()
    grads, counts = {}, {}
    for policy in ("full", "dots"):
        gpu = DiT(dataclasses.replace(cfg, gradient_checkpoint=True,
                                      gradient_checkpoint_from=1, remat_policy=policy))
        gpu.load_state_dict(cpu.state_dict())
        gpu = gpu.to(cuda_device)
        before = (tfa.LAUNCHES.count, tfa.DQ_LAUNCHES.count, tfa.DKV_LAUNCHES.count)
        (gpu(*(a.to(cuda_device) for a in args)) * weight.to(cuda_device)).sum().backward()
        torch.cuda.synchronize()
        after = (tfa.LAUNCHES.count, tfa.DQ_LAUNCHES.count, tfa.DKV_LAUNCHES.count)
        counts[policy] = [x - y for x, y in zip(after, before)]
        grads[policy] = {n: p.grad for n, p in gpu.named_parameters()}
    assert counts["dots"] == counts["full"] == [8, 5, 5]
    for name, g in grads["full"].items():
        assert torch.equal(g, grads["dots"][name]), name
    idx = torch.from_numpy(np.stack([np.random.RandomState(s).permutation(64)[:8]
                                     for s in range(2)]))
    gpu = DiT(cfg)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(cuda_device)
    with torch.no_grad():
        want = cpu(*args, idx)
        got = gpu(*(a.to(cuda_device) for a in args), idx.to(cuda_device))
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


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


@pytest.mark.cuda
def test_spans_hold_their_launches_on_the_profiler_clock(cuda_device):
    """A span around one kernel launch holds that launch's runtime event on
    the clock of torch.profiler's trace (the device activity alone): each
    kernel's launch, found by its correlation id, lies inside the span that
    issued it."""
    from torch.profiler import ProfilerActivity, profile

    a, b = (torch.randn(1 << 16, device=cuda_device) for _ in range(2))
    for _ in range(5):
        a + b
    torch.cuda.synchronize()
    with trace.recording() as rec:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(50):
                with trace.span("probe", index=i):
                    a + b
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    launches = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() != cuda and e.name().startswith("cu")}
    kernels = sorted((e.start_ns(), e.correlation_id()) for e in events
                     if e.device_type() == cuda)
    spans = sorted(rec.spans, key=lambda s: s.start_ns)
    assert len(kernels) == len(spans) == 50
    for i, (s, (_, corr)) in enumerate(zip(spans, kernels)):
        assert s.attrs["index"] == i
        assert s.start_ns <= launches[corr] <= s.end_ns


@pytest.mark.cuda
def test_device_seconds_of_a_dispatch(cuda_device):
    """`serve`'s device seconds: CUDA events around the call, no more than
    the host clock around it."""
    pipe = FLitePipeline.from_pretrained(FIXTURE, dtype=torch.float32)
    embeds, mask = ZeroTextEncoder(64, seq_len=32).encode(["a red circle"])
    t0 = time.perf_counter()
    images, device_s = _device_timed(pipe, lambda: pipe(
        prompt_embeds=embeds, context_mask=mask, height=64, width=64,
        num_inference_steps=3).images)
    host_s = time.perf_counter() - t0
    assert images.shape == (1, 64, 64, 3) and 0 < device_s <= host_s


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [16, 128, 1280, 5120])
def test_given_amax_entries_match_plain_and_the_fused_entry(cuda_device, dtype, k):
    """The quantize kernel's entries for a row-parallel layer under tensor
    parallelism: `row_amax` and `quantize_rows_given` equal their plain
    versions' bits (also with a given amax larger than the row's own, as
    another rank's share of the row gives), and the given entry fed the
    row's own amax equals the fused `quantize_rows`; one launch each."""
    g = torch.Generator("cuda").manual_seed(k)
    for m in (1, 17, 8224):
        x = (torch.randn((m, k), generator=g, device="cuda") * 3).to(dtype)
        if m > 1:
            x[m // 2] = 0.0
        before = tig.QUANTIZE_LAUNCHES.count
        amax = tig.row_amax(x)
        given = tig.quantize_rows_given(x, amax)
        larger = tig.quantize_rows_given(x, amax * 1.5)
        torch.cuda.synchronize()
        assert tig.QUANTIZE_LAUNCHES.count - before == 3
        assert torch.equal(amax, tig.row_amax_plain(x))
        for got, want in ((given, tig.quantize_rows_given_plain(x, amax)),
                          (larger, tig.quantize_rows_given_plain(x, amax * 1.5)),
                          (given, tig.quantize_rows(x))):
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), m


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


def _counts():
    return (tfa.LAUNCHES.count, tfa.DQ_LAUNCHES.count, tfa.DKV_LAUNCHES.count,
            tfv.LAUNCHES.count, tig.QUANTIZE_LAUNCHES.count, tig.GEMM_LAUNCHES.count)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["t5", "qwen2"])
def test_text_stack_bf16_on_the_card_matches_fp32_cpu(cuda_device, kind):
    """A small T5 (gated-gelu, 6 blocks) and Qwen2 tower (GQA 8/2, 6 layers)
    with bf16 weights on the card (bf16 products into fp32 activations),
    with padding, within 5% of the rms of the same weights in fp32 on the
    CPU on the real rows (`tolerance`), at return_index -2 and -1; no
    hand-written kernel is launched."""
    if kind == "t5":
        cpu = t5.T5EncoderStack(t5.T5Config(
            vocab_size=100, d_model=256, d_kv=32, d_ff=512, num_layers=6,
            num_heads=8))
    else:
        cpu = qwen2.Qwen2Encoder(qwen2.Qwen2Config(
            vocab_size=128, hidden_size=256, intermediate_size=512,
            num_hidden_layers=6, num_attention_heads=8, num_key_value_heads=2))
    cpu = randomize_(cpu, seed=0).eval()
    gpu = type(cpu)(cpu.config).to(cuda_device, torch.bfloat16).eval()
    gpu.load_state_dict(cpu.state_dict())
    cpu.load_state_dict(gpu.state_dict())  # the bf16-rounded weights in fp32
    rs = np.random.RandomState(1)
    ids = torch.from_numpy(rs.randint(0, 100, (3, 40)))
    mask = torch.from_numpy(np.arange(40)[None] < np.array([[40], [17], [5]]))
    before = _counts()
    for return_index in (-2, -1):
        with torch.no_grad():
            want = cpu(ids, mask, return_index=return_index)
            got = gpu(ids.to(cuda_device), mask.to(cuda_device),
                      return_index=return_index)
        assert got.dtype == torch.float32 and got.shape == want.shape == (3, 40, 256)
        err = float((got.cpu() - want)[mask].abs().max())
        tol = tfa.tolerance(want[mask], torch.bfloat16)
        print(f"{kind} return_index {return_index}: err {err:.4g} tol {tol:.4g}")
        assert err <= tol
    assert _counts() == before


@pytest.mark.cuda
def test_lora_merge_and_save_on_the_card_match_the_cpu(cuda_device, tmp_path):
    """The fixture with a seeded rank-4 LoRA merged at load in bf16: the
    card's merged weights within one bf16 ulp of the CPU's (the factors'
    fp32 product may round differently), and `save_pretrained` on the card
    writes those weights bit for bit."""
    from f_lite_tpu_torch.utils.safetensors import save_file

    g = torch.Generator().manual_seed(3)
    d = 256
    save_file({f"blocks_{i}.{attn}.{t}.{k}": torch.randn(shape, generator=g) * 0.05
               for i in range(6)
               for attn, targets in (("self_attn", {"qkv": 3 * d, "proj": d}),
                                     ("cross_attn", {"q": d, "context_kv": 2 * d,
                                                     "proj": d}))
               for t, n in targets.items()
               for k, shape in (("lora_a", (d, 4)), ("lora_b", (4, n)))},
              tmp_path / "lora_weights.safetensors")
    kw = dict(dtype=torch.bfloat16, lora_path=tmp_path, lora_alpha=8.0)
    want = FLitePipeline.from_pretrained(FIXTURE, device="cpu", **kw).dit.state_dict()
    pipe = FLitePipeline.from_pretrained(FIXTURE, **kw)
    got = pipe.dit.state_dict()
    for key, w in want.items():
        a, b = got[key].float().cpu(), w.float()
        ulp = torch.ldexp(torch.ones_like(b), torch.frexp(
            b.abs().clamp_min(2.0 ** -126)).exponent - 8)
        assert bool(((a - b).abs() <= ulp).all()), key
    pipe.save_pretrained(tmp_path / "saved")
    again = FLitePipeline.from_pretrained(tmp_path / "saved", dtype=torch.bfloat16,
                                          device="cpu").dit.state_dict()
    for key, w in got.items():
        assert torch.equal(again[key], w.cpu()), key


@pytest.mark.cuda
def test_cache_builder_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """`tools.precompute_embeddings` on a 16-row PNG table (a seeded tiny
    VAE as a native `vae/` dir, the zero encoder): the card's cache has the
    CPU's index and embeddings bit for bit, and every latent within 1e-5 x
    max |CPU| (the same CPU-drawn posterior noise, fp32, TF32 off)."""
    import json

    from f_lite_tpu_torch.convert.to_jax import vae_state_dict_to_jax
    from f_lite_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from f_lite_tpu_torch.tools import precompute_embeddings
    from f_lite_tpu_torch.utils.image import png_bytes_with_metadata
    from f_lite_tpu_torch.utils.safetensors import save_file

    rs = np.random.RandomState(0)
    rows = []
    for i in range(16):
        f = tmp_path / f"{i}.png"
        f.write_bytes(png_bytes_with_metadata(rs.randint(0, 256, (64, 64, 3))
                                              .astype(np.uint8)))
        rows.append({"media_path": str(f), "captions": [f"caption {i % 5}"],
                     "width": 64, "height": 64})
    (tmp_path / "t.json").write_text(json.dumps(rows))
    vae = AutoencoderKL(VAEConfig.tiny(latent_channels=16))
    vae.init_weights(torch.Generator().manual_seed(2))
    (tmp_path / "vae").mkdir()
    (tmp_path / "vae" / "config.json").write_text(json.dumps(vae.config.to_json_dict()))
    save_file(vae_state_dict_to_jax(vae.state_dict(), vae.config),
              tmp_path / "vae" / "flax_params.safetensors")
    argv = ["--train_data_path", str(tmp_path / "t.json"), "--root_dir_type", "json",
            "--base_url", "file://", "--resolution", "64", "--center_crop",
            "--vae_path", str(tmp_path / "vae"), "--batch_size", "6",
            "--cross_attn_input_size", "64"]
    caches = {}
    for device in ("cuda", "cpu"):
        caches[device] = tmp_path / device
        assert precompute_embeddings.main(
            argv + ["--output_dir", str(caches[device]), "--device", device]) == 16
    index = {d: json.loads((c / "precomputed_mapping.json").read_text())
             for d, c in caches.items()}
    assert index["cuda"] == index["cpu"]
    for e in index["cpu"]["entries"]:
        want = np.load(caches["cpu"] / "vae_latents" / e["latent_file"])
        got = np.load(caches["cuda"] / "vae_latents" / e["latent_file"])
        assert got.shape == want.shape == (32, 32, 16)
        assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max())
        np.testing.assert_array_equal(
            np.load(caches["cuda"] / "text_embeddings" / e["embedding_file"]),
            np.load(caches["cpu"] / "text_embeddings" / e["embedding_file"]))


@pytest.mark.cuda
def test_release_dryrun_runs_on_the_card(cuda_device, tmp_path, monkeypatch):
    """`tools.fabricated_release_dryrun.main` on the card at a tiny manifest
    (hidden 512, depth 3, 2 heads of 256, residual_v) beside the Flux VAE
    at full size: fabricated there, ingested strictly, loaded in bf16 with
    int8 projections, two 64 px images of 2 steps. The report's status ok
    and finite images; #1 launched 2 x 2 x 6 times (3 self and 3 cross
    attentions a forward) and each int8 kernel 2 x 2 x 24 times (5
    projections a block and 3 more in each cross-attention)."""
    import json

    from f_lite_tpu_torch.convert.manifest import expected_torch_keys
    from f_lite_tpu_torch.tools import fabricated_release_dryrun as tool

    cfg = dict(hidden_size=512, depth=3, num_heads=2, cross_attn_input_size=64,
               residual_v=True, train_bias_and_rms=False)
    (tmp_path / "tiny.json").write_text(json.dumps({
        "repo_id": "tiny/F-Lite-tiny", "config": cfg,
        "keys": sorted(expected_torch_keys(tool.dit_config({"config": cfg})))}))
    monkeypatch.setattr(tool, "MANIFEST_DIR", tmp_path)
    before = _counts()
    report = tool.main(["--manifest", "tiny", "--workdir", str(tmp_path / "work"),
                        "--out", str(tmp_path / "report.json"), "--size", "64",
                        "--steps", "2", "--repeats", "2"])
    after = _counts()
    assert report["status"] == "ok" and report["finite"] and report["device"] == "cuda"
    assert report["fabricated_on"] == "cuda"
    assert [b - a for a, b in zip(before, after)] == [24, 0, 0, 0, 96, 96]
    assert report["hbm"]["max_memory_allocated_gb"] < 80


# The RMSNorm kernel (csrc/rms_norm.cu) against its plain twins. Cases:
# shape, x's dtype, the weight's (None: no weight), x's layout: "dense";
# "transposed", a (B, L, H, D) tensor seen as (B, H, L, D) as the
# cross-attention's q; "kv_slice", the k of a (2, B, H, L, D) permute of a
# (B, L, 2, H, D) product, as the cross-attention's k; "head_slice", rows
# 16 on of each batch row, as the head's tokens without the registers
# (these two the wrapper copies contiguous first); "unaligned", one element
# past a 16-byte boundary.
NORM_CASES = [
    ((2, 4112, 2560), torch.bfloat16, torch.bfloat16, "dense"),  # 7B pre-norms
    ((2, 4112, 3072), torch.bfloat16, torch.bfloat16, "dense"),  # 10B pre-norms
    ((2, 10, 4112, 256), torch.bfloat16, None, "dense"),  # 7B QK-norm
    ((2, 10, 4112, 256), torch.bfloat16, None, "transposed"),  # cross-attention q
    ((1, 128, 4096), torch.float32, torch.float32, "dense"),  # T5-XXL tower
    ((1, 128, 3584), torch.float32, torch.bfloat16, "dense"),  # Qwen2.5-VL-7B tower
    ((2, 1040, 2560), torch.bfloat16, torch.float32, "dense"),  # fp32 weight
    ((2, 333, 2560), torch.float32, torch.float32, "dense"),  # 2 chunks a thread
    ((4, 33, 1024), torch.bfloat16, torch.bfloat16, "dense"),  # a warp a row, 4 chunks a lane
    ((4, 33, 1024), torch.float32, None, "dense"),  # 256 chunks: a block a row
    ((2, 5, 8192), torch.float32, torch.float32, "dense"),  # 4 chunks a thread
    ((1, 3, 8200), torch.float32, torch.float32, "dense"),  # past 2048 chunks: a value a thread
    ((4, 33, 128), torch.bfloat16, torch.bfloat16, "dense"),  # 128-wide heads
    ((3, 37, 100), torch.bfloat16, torch.float32, "dense"),  # D % 8: a value a lane
    ((3, 37, 1030), torch.float32, torch.bfloat16, "dense"),  # D % 4 over 1024
    ((2, 77, 2560), torch.bfloat16, torch.bfloat16, "unaligned"),
    ((2, 10, 128, 256), torch.bfloat16, None, "kv_slice"),  # 7B cross-attention k
    ((2, 12, 128, 256), torch.float32, None, "kv_slice"),
    ((2, 4096, 2560), torch.bfloat16, None, "head_slice"),  # 7B head
    ((2, 40, 100), torch.bfloat16, torch.bfloat16, "head_slice"),  # strided, a value a lane
]


def _norm_inputs(shape, dtype, wdtype, layout, device, seed=0):
    """x (3 N(0, 1) in `layout`), the weight (1 + 0.1 N(0, 1)) and an
    upstream gradient (N(0, 1), contiguous), on `device`."""
    gen = torch.Generator().manual_seed(seed)
    d = shape[-1]
    if layout == "transposed":
        b, h, n, _ = shape
        x = (3 * torch.randn(b, n, h, d, generator=gen)).to(device, dtype).transpose(1, 2)
    elif layout == "kv_slice":
        b, h, n, _ = shape
        kv = (3 * torch.randn(b, n, 2, h, d, generator=gen)).to(device, dtype)
        x = kv.permute(2, 0, 3, 1, 4)[0]
    elif layout == "head_slice":
        b, n, _ = shape
        x = (3 * torch.randn(b, n + 16, d, generator=gen)).to(device, dtype)[:, 16:]
    elif layout == "unaligned":
        flat = (3 * torch.randn(int(np.prod(shape)) + 1, generator=gen)).to(device, dtype)
        x = flat[1:].view(shape)
    else:
        x = (3 * torch.randn(shape, generator=gen)).to(device, dtype)
    w = None if wdtype is None else (1 + 0.1 * torch.randn(d, generator=gen)).to(device, wdtype)
    g = torch.randn(shape, generator=gen).to(device, dtype)
    return x, w, g


def _assert_norm_close(got, want, scale, what):
    """Kernel against twin within `rms_norm.excess`'s bound (its docstring
    gives the reasons for each dtype's)."""
    from f_lite_tpu_torch.ops.cuda import rms_norm as crn

    worst = crn.excess(got, want, scale)
    assert worst <= 0, f"{what}: the error exceeds its bound by {worst}"


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,wdtype,layout", NORM_CASES)
def test_rms_norm_kernel_matches_plain(cuda_device, shape, dtype, wdtype, layout):
    """`rms_norm` on the card (the kernel, forward and backward through its
    autograd Function) against `rms_norm_plain` and `rms_norm_bwd_plain`
    on the same card: y, dx and dw within `_assert_norm_close`; y keeps
    x's layout where x is dense and is contiguous where the wrapper copied
    x; one forward and one backward launch a call."""
    from f_lite_tpu_torch.ops import norms
    from f_lite_tpu_torch.ops.cuda import rms_norm as crn

    x, w, g = _norm_inputs(shape, dtype, wdtype, layout, cuda_device)
    xa = x.detach().requires_grad_(True)
    wa = None if w is None else w.detach().requires_grad_(True)
    before = (crn.LAUNCHES.count, crn.BWD_LAUNCHES.count)
    y = norms.rms_norm(xa, wa)
    y.backward(g)
    torch.cuda.synchronize()
    assert (crn.LAUNCHES.count - before[0], crn.BWD_LAUNCHES.count - before[1]) == (1, 1)
    want = norms.rms_norm_plain(x, w)
    if layout in ("dense", "transposed", "unaligned"):
        assert crn.dense_rows(x) and y.stride() == x.stride() == want.stride()
    else:  # copied contiguous first, y with it
        assert not crn.dense_rows(x) and y.is_contiguous()
    _assert_norm_close(y, want, want.float().abs(), "y")

    dx, dw = norms.rms_norm_bwd_plain(x, w, g)
    scale, dw_scale = crn.bwd_scales(x, w, g)
    _assert_norm_close(xa.grad, dx, scale, "dx")
    assert xa.grad.dtype == dtype
    if w is not None:
        assert wa.grad.dtype == wdtype
        _assert_norm_close(wa.grad, dw, dw_scale, "dw")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,wdtype", [
    ((2, 4112, 2560), torch.bfloat16, torch.bfloat16),
    ((4, 33, 256), torch.float32, torch.float32),  # a warp a row
    ((3, 37, 100), torch.bfloat16, torch.bfloat16),  # a value a lane
])
def test_rms_norm_kernel_repeats_bit_for_bit(cuda_device, shape, dtype, wdtype):
    """Two backward calls on the same inputs give the same dx and dw, bit
    for bit (dw's partial sums are added in a fixed order, no atomics); the
    forward without grad equals the forward with it."""
    from f_lite_tpu_torch.ops.cuda import rms_norm as crn

    x, w, g = _norm_inputs(shape, dtype, wdtype, "dense", cuda_device)
    y, r = crn.rms_norm_fwd(x, w, with_rstd=True)
    first = crn.rms_norm_bwd(x, w, r, g)
    second = crn.rms_norm_bwd(x, w, r, g)
    before = (crn.LAUNCHES.count, crn.BWD_LAUNCHES.count)
    with torch.no_grad():
        again = crn.rms_norm(x.requires_grad_(True), w)
    assert (crn.LAUNCHES.count - before[0], crn.BWD_LAUNCHES.count - before[1]) == (1, 0)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    assert torch.equal(y, again)


@pytest.mark.cuda
def test_rms_norm_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    from f_lite_tpu_torch.ops.cuda import rms_norm as crn

    x = torch.randn(4, 256, device=cuda_device)
    before = crn.LAUNCHES.count
    for bad in (x.half(), x.to(torch.int32)):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            crn.rms_norm(bad)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        crn.rms_norm(x, torch.ones(256, device=cuda_device, dtype=torch.float16))
    with pytest.raises(ValueError, match="weight"):
        crn.rms_norm(x, torch.ones(128, device=cuda_device))
    with pytest.raises(ValueError, match="CUDA tensors"):
        crn.rms_norm(x.cpu())
    assert crn.LAUNCHES.count == before


@pytest.mark.cuda
def test_dots_checkpointed_block_matches_the_unwrapped_block(cuda_device):
    """The last block checkpointed under "dots" (the norms run again in the
    backward, through the kernel) gives the unwrapped DiT's gradients, fp32:
    the same kernels on the same values, so only the order in which
    autograd adds a shared input's contributions (the modulation, the
    context) may differ, by fp32 rounding (atol 1e-6, rtol 1e-5)."""
    from f_lite_tpu_torch.ops.cuda import rms_norm as crn

    cfg, cpu, args, weight = _small_dit_and_inputs()
    grads, counts = {}, {}
    for name, extra in (("none", {}), ("dots", {"gradient_checkpoint": True,
                                                "gradient_checkpoint_from": cfg.depth - 1,
                                                "remat_policy": "dots"})):
        gpu = DiT(dataclasses.replace(cfg, **extra))
        gpu.load_state_dict(cpu.state_dict())
        gpu = gpu.to(cuda_device)
        before = (crn.LAUNCHES.count, crn.BWD_LAUNCHES.count)
        (gpu(*(a.to(cuda_device) for a in args)) * weight.to(cuda_device)).sum().backward()
        torch.cuda.synchronize()
        counts[name] = (crn.LAUNCHES.count - before[0], crn.BWD_LAUNCHES.count - before[1])
        grads[name] = {n: p.grad for n, p in gpu.named_parameters()}
    # the block's norms run again in the recompute; each backward runs once
    assert counts["dots"][0] > counts["none"][0]
    assert counts["dots"][1] == counts["none"][1] > 0
    for name, g in grads["none"].items():
        assert grads["dots"][name] is not None, name
        torch.testing.assert_close(grads["dots"][name], g, atol=1e-6, rtol=1e-5,
                                   msg=lambda m, n=name: f"{n}: {m}")
