"""Tests of the port that need an NVIDIA GPU: the Hopper kernel against its
plain version, and the DiT and pipeline on the card against the same code on
the CPU. They skip without a card. This file imports no JAX, so it also runs
on a GPU host without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from f_lite_tpu_torch.models.dit import DiT, DiTConfig
from f_lite_tpu_torch.ops.cuda import flash_attention as tfa
from f_lite_tpu_torch.pipeline import FLitePipeline
from f_lite_tpu_torch.text.encoder import ZeroTextEncoder
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
]


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
    q = torch.zeros(1, 1, 8, 128, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q, q, q)


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
