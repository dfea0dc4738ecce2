"""The plain reference against the port's plain (CPU) path at a tiny size,
both in float32 on the same seeded weights and inputs: they agree to
float32 rounding."""

from __future__ import annotations

import pytest
import torch

from portbench.model import dit_fields, vae_fields
from portbench.reference.dit import ReferenceDiT
from portbench.reference.quant import fp8
from portbench.reference.sampler import cfg_step, schedule
from portbench.reference.train import AdamW, loss
from portbench.reference.vae import decode
from portbench.tests.conftest import TINY, tiny_cell
from portbench.weights import dit_weights, vae_decoder_weights

CPU = torch.device("cpu")


def port_dit(w, quantize=False, **extra):
    from f_lite_tpu_torch.models.dit import DiT, DiTConfig
    from f_lite_tpu_torch.quant import quantize_dit

    with torch.device("meta"):
        dit = DiT(DiTConfig(**dit_fields(TINY), **extra))
    dit.load_state_dict({k: v.clone() for k, v in w.items()}, strict=True, assign=True)
    return quantize_dit(dit) if quantize else dit


def inputs(seed=0, b=2):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, 16, 16, 16, generator=g)
    ctx = torch.randn(b, 8, TINY["cross_attn_input_size"], generator=g)
    mask = torch.arange(8)[None] < torch.tensor([3, 8][:b])[:, None]
    return x, ctx, mask, torch.tensor([0.7, 0.2][:b])


def rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("quantize", [False, True])
def test_dit_forward(quantize):
    w = dit_weights(TINY, 11, CPU, torch.float32)
    with torch.no_grad():
        got = port_dit(w, quantize)(*inputs())
        want = ReferenceDiT(w, TINY, "int8" if quantize else "fp32")(*inputs())
    assert rel(got, want) < 1e-5


def test_vae_decoder():
    from f_lite_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    w = vae_decoder_weights(TINY["vae"], 11, CPU)
    with torch.device("meta"):
        vae = AutoencoderKL(VAEConfig(**vae_fields(TINY["vae"])))
    vae.decoder.load_state_dict({k: v.clone() for k, v in w.items()}, strict=True, assign=True)
    z = torch.randn(1, 16, 16, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert rel(vae.decode(z), decode(w, TINY["vae"], z)) < 1e-5


def test_sampler_trajectory():
    """The port's CFG Euler loop and the reference's, step by step from the
    same start, in fp32."""
    from f_lite_tpu_torch.sampling.euler import DenoiseSettings, denoise

    w = dit_weights(TINY, 12, CPU, torch.float32)
    x, ctx, mask, _ = inputs(b=1)
    dit, ref = port_dit(w), ReferenceDiT(w, TINY)
    with torch.no_grad():
        got = denoise(dit, x, ctx, torch.zeros_like(ctx), mask,
                      DenoiseSettings(num_inference_steps=4, guidance_scale=6.0))
        z = x
        for t, t_next in schedule(4, 16, 16):
            z = cfg_step(ref, z, ctx, mask, t, t_next, 6.0)
    assert rel(got, z) < 1e-5


def test_training_step():
    """One step of the port's `train_step` (fp32 compute, no remat) and the
    reference's loss, clipped gradient and AdamW update."""
    from f_lite_tpu_torch.train.loss import LossDraws
    from f_lite_tpu_torch.train.optim import build_optimizer
    from f_lite_tpu_torch.train.step import TrainState, train_step

    from portbench.drivers.train import draw_batch, text_lengths

    cell = tiny_cell("f_lite_7b.train_512")
    traffic = cell.traffic
    w = dit_weights(TINY, 13, CPU, torch.float32)
    b = draw_batch(TINY, traffic, 13, 1, text_lengths(traffic, 13), CPU)
    b["drop"][0] = True  # a dropped caption in the batch
    model = port_dit(w)
    opt = build_optimizer(list(model.parameters()), learning_rate=1e-3,
                          lr_scheduler="constant", max_grad_norm=0.5)
    m = train_step(TrainState(model, opt), b["latents"], b["context"], b["mask"],
                   draws=LossDraws(b["drop"], b["t"], b["noise"], None))
    wr = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    value = loss(ReferenceDiT(wr, TINY), b["latents"], b["context"], b["mask"], b["drop"],
                 b["t"], b["noise"])
    ref_opt = AdamW(wr, 1e-3, max_grad_norm=0.5)
    norms = ref_opt.step(dict(zip(wr, torch.autograd.grad(value, list(wr.values())))))
    assert float(m["loss"]) == pytest.approx(float(value.detach()), rel=1e-5)
    got = dict(model.named_parameters())
    for (name, mu) in zip(got, opt.mu):
        assert float(mu.norm()) / 0.1 == pytest.approx(norms[name], rel=1e-4, abs=1e-9)
        assert rel(got[name].detach() - w[name], wr[name].detach() - w[name]) < 1e-3


def test_fp8_rounding():
    """Each row's largest value is kept exactly; the others move by at
    most e4m3's half step (2^-4 relative) while they stay normal."""
    x = torch.tensor([[1.0, 0.5, 0.3, 3.0], [448.0, -1.0, 0.0, 2.0]])
    y = fp8(x)
    assert float(y[0, 3]) == 3.0 and float(y[1, 0]) == 448.0
    assert float(((y - x).abs() / x.abs().clamp_min(1e-9))[0].max()) <= 2 ** -4
    assert not torch.equal(y, x)
