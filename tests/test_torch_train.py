"""The port's training path against the JAX package, on the CPU in fp32.

Inputs are made from numpy seeds and fed to both packages: the loss with
injected timesteps and noise, DiT parameter gradients (XLA attention on the
JAX side, the port's plain attention under its autograd Function), the
optax schedules and clip + AdamW chain, the precomputed cache, and the
trainer's export, which the JAX pipeline loads. The attention kernels' own
gradients are held to `jax.vjp` of the Pallas kernel in
tests/test_torch_flash_attention.py.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from f_lite_tpu.data.precomputed import PrecomputedCacheWriter as JaxCacheWriter
from f_lite_tpu.data.precomputed import create_precomputed_data_loader as jax_loader
from f_lite_tpu.models.dit import DiT as JaxDiT
from f_lite_tpu.models.dit import DiTConfig as JaxDiTConfig
from f_lite_tpu.train.loss import flow_matching_loss as jax_loss
from f_lite_tpu.train.optim import build_lr_schedule as jax_schedule
from f_lite_tpu.train.optim import build_optimizer as jax_optimizer
from f_lite_tpu_torch.convert.from_jax import state_dict_from_jax
from f_lite_tpu_torch.convert.to_jax import state_dict_to_jax
from f_lite_tpu_torch.data.precomputed import (
    PrecomputedDataset,
    create_precomputed_data_loader,
)
from f_lite_tpu_torch.models.dit import DiT, DiTConfig
from f_lite_tpu_torch.train.loss import flow_matching_loss
from f_lite_tpu_torch.train.optim import build_lr_schedule, build_optimizer
from f_lite_tpu_torch.train.trainer import parse_args, train
from test_torch_dit import BASE, CONFIGS, random_jax_params, unflatten

ROOT = Path(__file__).resolve().parent.parent

SMALL = dict(in_channels=4, patch_size=2, hidden_size=64, depth=3,
             num_heads=4, mlp_ratio=2.0, cross_attn_input_size=24,
             residual_v=True, cross_attn_first_n=1, cross_attn_period=2)


def _batch(seed, b=3, hw=8, c=4, s=8, ctx=24):
    rs = np.random.RandomState(seed)
    return dict(
        latents=rs.randn(b, hw, hw, c).astype(np.float32),
        context=rs.randn(b, s, ctx).astype(np.float32),
        mask=np.arange(s)[None, :] < np.asarray([8, 5, 3])[:b, None],
        timesteps=rs.rand(b).astype(np.float32),
        noise=rs.randn(b, hw, hw, c).astype(np.float32),
    )


def _jax_loss(jcfg, flat, batch):
    def loss_fn(params):
        return jax_loss(
            JaxDiT(jcfg).apply, {"params": params}, jax.random.key(0),
            jnp.asarray(batch["latents"]), jnp.asarray(batch["context"]),
            jnp.asarray(batch["mask"]), uncond_prob=0.0,
            timesteps=jnp.asarray(batch["timesteps"]),
            noise=jnp.asarray(batch["noise"]))
    return loss_fn, unflatten(flat)


def _port_loss(model, batch):
    return flow_matching_loss(
        model, torch.from_numpy(batch["latents"]),
        torch.from_numpy(batch["context"]), torch.from_numpy(batch["mask"]),
        uncond_prob=0.0, timesteps=torch.from_numpy(batch["timesteps"]),
        noise=torch.from_numpy(batch["noise"]))


def _port_model(cfg_kw, flat, **extra):
    cfg = DiTConfig(**cfg_kw, **extra)
    model = DiT(cfg)
    model.load_state_dict(state_dict_from_jax(flat, cfg), strict=True)
    return model


def test_flow_matching_loss_and_bins_match_jax():
    jcfg = JaxDiTConfig(**SMALL, use_pallas_attention=False)
    flat = random_jax_params(jcfg, 11)
    batch = _batch(0)
    loss_fn, params = _jax_loss(jcfg, flat, batch)
    want, aux = loss_fn(params)
    got, taux = _port_loss(_port_model(SMALL, flat), batch)
    assert float(want) > 0.1
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(taux.per_sample_loss.detach().numpy(),
                               np.asarray(aux.per_sample_loss), rtol=1e-5)
    np.testing.assert_allclose(taux.bin_sums.numpy(), np.asarray(aux.bin_sums),
                               rtol=1e-5)
    np.testing.assert_array_equal(taux.bin_counts.numpy(),
                                  np.asarray(aux.bin_counts))


def test_dit_parameter_grads_match_jax_grad():
    """3 blocks with residual_v (block 0's V feeds blocks 1 and 2), non-zero
    parameters; per tensor max |g - g_jax| <= 1e-4 * max |g_jax|."""
    jcfg = JaxDiTConfig(**SMALL, use_pallas_attention=False)
    flat = random_jax_params(jcfg, 12)
    batch = _batch(1)
    loss_fn, params = _jax_loss(jcfg, flat, batch)
    jgrads = jax.grad(lambda p: loss_fn(p)[0])(params)
    from test_torch_dit import flatten

    want = state_dict_from_jax(flatten(jgrads), DiTConfig(**SMALL))
    model = _port_model(SMALL, flat)
    loss, _ = _port_loss(model, batch)
    loss.backward()
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, g_jax in want.items():
        g = got[name].grad
        assert g is not None, name
        scale = float(g_jax.abs().max())
        assert scale > 0, name  # non-zero parameters: every gradient moves
        err = float((g - g_jax).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)


def test_gradient_checkpointing_gives_the_same_grads_exactly():
    jcfg = JaxDiTConfig(**SMALL, use_pallas_attention=False)
    flat = random_jax_params(jcfg, 13)
    batch = _batch(2)
    grads = []
    for remat in (False, True):
        model = _port_model(SMALL, flat, gradient_checkpoint=remat,
                            gradient_checkpoint_from=1)
        _port_loss(model, batch)[0].backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name


def test_dots_remat_policy_is_not_ported():
    model = DiT(DiTConfig(**SMALL, gradient_checkpoint=True, remat_policy="dots"))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        _port_loss(model, _batch(0))


def test_fresh_init_outputs_zero_with_jax_initializers():
    cfg = DiTConfig(**SMALL)
    model = DiT(cfg).init_weights(torch.Generator().manual_seed(0))
    b = _batch(3)
    with torch.no_grad():
        out = model(torch.from_numpy(b["latents"]), torch.from_numpy(b["context"]),
                    torch.from_numpy(b["mask"]), torch.from_numpy(b["timesteps"]))
    assert out.shape == b["latents"].shape and not out.any()
    w = model.blocks[0].mlp.up_proj.weight  # lecun_normal, fan_in 64
    assert abs(float(w.std()) - 64**-0.5) < 0.1 * 64**-0.5
    assert float(w.abs().max()) <= 2 * 64**-0.5 / 0.87962566103423978 + 1e-6
    assert not model.final_proj.weight.any() and not model.adaLN_modulation[1].weight.any()
    assert float(model.blocks[1].self_attn.lambda_v) == 0.5
    assert bool((model.blocks[0].norm1.weight == 1).all())
    assert abs(float(model.register_tokens.std()) - 1.0) < 0.1


@pytest.mark.parametrize("name", ["linear", "cosine", "wsd", "constant"])
def test_lr_schedules_match_optax_at_every_step(name):
    kw = dict(num_warmup_steps=7, max_steps=53)
    want = jax_schedule(name, 3e-4, **kw)
    got = build_lr_schedule(name, 3e-4, **kw)
    assert got(0) == 0.0  # the first update is a no-op
    for step in range(70):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-12, err_msg=f"step {step}")


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_clip_and_adamw_match_optax_chain(moment_dtype):
    """3 updates of clip_by_global_norm(1.0) + adamw on the same gradients
    (one step below the clip norm, two above): parameters to 1e-6."""
    rs = np.random.RandomState(5)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    params = [rs.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rs.randn(*s).astype(np.float32) * scale for s in shapes]
             for scale in (0.1, 3.0, 10.0)]
    kw = dict(learning_rate=1e-2, lr_scheduler="cosine", num_warmup_steps=1,
              max_steps=10, weight_decay=0.1, max_grad_norm=1.0,
              moment_dtype=moment_dtype)
    opt = jax_optimizer(**kw)
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    topt = build_optimizer(tp, **kw)
    for g in grads:
        jg = [jnp.asarray(x) for x in g]
        updates, state = opt.update(jg, state, jp)
        jp = optax.apply_updates(jp, updates)
        norm = topt.step([torch.from_numpy(x) for x in g])
        np.testing.assert_allclose(float(norm), float(optax.global_norm(jg)),
                                   rtol=1e-6)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    if moment_dtype:
        assert topt.mu[0].dtype == torch.bfloat16
        assert topt.nu[0].dtype == torch.float32
        np.testing.assert_array_equal(
            topt.mu[0].float().numpy(),
            np.asarray(state[1][0].mu[0].astype(jnp.float32)))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_to_jax_inverts_from_jax_exactly(name):
    cfg_kw = CONFIGS[name]
    jcfg = JaxDiTConfig(**BASE, **cfg_kw, use_pallas_attention=False)
    flat = random_jax_params(jcfg, list(CONFIGS).index(name))
    back = state_dict_to_jax(state_dict_from_jax(flat, DiTConfig(**BASE, **cfg_kw)),
                             DiTConfig(**BASE, **cfg_kw))
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_reads_the_jax_precomputed_cache_into_the_same_batches(tmp_path):
    writer = JaxCacheWriter(tmp_path)
    rs = np.random.RandomState(6)
    for i in range(10):
        writer.add(f"id{i}", f"caption {i % 4}",
                   rs.randn(4, 4, 3).astype(np.float32),
                   rs.randn(5 + i % 4, 16).astype(np.float32))
    writer.finalize()
    jdl, _ = jax_loader(tmp_path, 4, num_workers=1, seed=3, use_buckets=False)
    tdl, _ = create_precomputed_data_loader(tmp_path, 4, seed=3)
    assert len(tdl) == len(jdl) == 2
    for want, got in zip(jdl, tdl):
        assert got["caption"] == want["caption"] and got["_id"] == want["_id"]
        for key in ("vae_latent", "text_embedding", "text_mask"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert PrecomputedDataset(tmp_path).collate_fn(
        [PrecomputedDataset(tmp_path)[0]])["text_mask"].shape == (1, 8)


def _tiny_cache(root: Path, n=8):
    from f_lite_tpu_torch.data.precomputed import PrecomputedCacheWriter

    writer = PrecomputedCacheWriter(root)
    rs = np.random.RandomState(7)
    for i in range(n):
        writer.add(f"{i}", f"a caption {i % 3}",
                   rs.uniform(-1, 1, (16, 16, 3)).astype(np.float32),
                   rs.randn(6 + i % 3, 32).astype(np.float32))
    writer.finalize()
    return root


def _tiny_argv(cache, out):
    return ["--device", "cpu", "--use_precomputed_data",
            "--precomputed_data_dir", str(cache), "--pixel_space",
            "--model_width", "128", "--model_depth", "3",
            "--model_head_dim", "64", "--cross_attn_input_size", "32",
            "--residual_v", "--train_batch_size", "4", "--num_epochs", "2",
            "--max_steps", "3", "--learning_rate", "1e-2",
            "--num_warmup_steps", "1", "--log_every", "1", "--seed", "0",
            "--gradient_checkpointing", "--output_dir", str(out),
            "--export_pipeline"]


def test_module_entry_point_trains_and_jax_loads_the_export(tmp_path):
    cache = _tiny_cache(tmp_path / "cache")
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "f_lite_tpu_torch.train",
         *_tiny_argv(cache, out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "step 3 loss" in proc.stderr and "exported pipeline" in proc.stderr

    from f_lite_tpu.pipeline import FLitePipeline as JaxPipeline
    from f_lite_tpu_torch.pipeline import FLitePipeline

    export = out / "pipeline"
    cfg = json.loads((export / "dit" / "config.json").read_text())
    assert cfg["hidden_size"] == 128 and cfg["in_channels"] == 3
    jpipe = JaxPipeline.from_pretrained(export, dtype=jnp.float32,
                                        load_text_encoder=False,
                                        scan_layers=False)
    tpipe = FLitePipeline.from_pretrained(export, dtype=torch.float32,
                                          device="cpu")
    rs = np.random.RandomState(8)
    x = rs.randn(2, 16, 16, 3).astype(np.float32)
    ctx = rs.randn(2, 8, 32).astype(np.float32)
    mask = np.arange(8)[None, :] < np.asarray([8, 6])[:, None]
    t = rs.rand(2).astype(np.float32)
    want = np.asarray(jpipe.dit_model.apply(
        jpipe.dit_params, jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(mask),
        jnp.asarray(t)))
    with torch.no_grad():
        got = tpipe.dit(*map(torch.from_numpy, (x, ctx, mask, t))).numpy()
    assert np.abs(want).max() > 1e-4  # trained: the zero-init head moved
    assert float(((got - want) ** 2).mean()) < 1e-9


def test_trainer_result_and_log_line(tmp_path, caplog):
    cache = _tiny_cache(tmp_path / "cache")
    argv = _tiny_argv(cache, tmp_path / "out")
    argv.remove("--export_pipeline")
    with caplog.at_level("INFO", logger="f_lite_tpu_torch.train"):
        result = train(parse_args(argv))
    assert result["global_step"] == 3 and result["train/step"] == 3
    assert result["train/lr"] == build_lr_schedule(
        "linear", 1e-2, num_warmup_steps=1, max_steps=3)(3)
    assert np.isfinite(result["train/loss"]) and result["train/grad_norm"] > 0
    assert {"train/loss", "train/grad_norm", "train/lr", "global_step",
            "wall_s"} <= set(result)
    lines = [r.getMessage() for r in caplog.records if r.getMessage().startswith("step ")]
    assert len(lines) == 3 and lines[0].startswith("step 1 loss ")


@pytest.mark.parametrize("extra", [
    ["--use_lora"], ["--ema_decay", "0.999"], ["--bs_rampup", "10"],
    ["--gradient_accumulation_steps", "2"], ["--sequence_dropout", "0.5"],
    ["--fsdp", "2"], ["--multihost"], ["--resume_from_checkpoint", "latest"],
    ["--checkpointing_steps", "500"], ["--sample_every", "500"],
    ["--val_data_path", "x"], ["--remat_policy", "dots"],
    ["--report_to", "tensorboard"],
])
def test_unported_options_raise(tmp_path, extra):
    argv = _tiny_argv(tmp_path, tmp_path / "out") + extra
    with pytest.raises(SystemExit, match="not ported yet"):
        train(parse_args(argv))


def test_online_image_path_is_not_ported(tmp_path):
    argv = _tiny_argv(tmp_path, tmp_path / "out")
    argv.remove("--use_precomputed_data")
    with pytest.raises(SystemExit, match="not ported yet"):
        train(parse_args(argv))
