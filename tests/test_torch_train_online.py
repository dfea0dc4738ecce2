"""The port's online training path against the JAX package, on the CPU in
fp32: the VAE's posterior sample (`encode(x, noise=eps)`, atol 1e-5),
`encode_batch` (VAE encode + `normalize_latents` + `ZeroTextEncoder`,
atol 1e-5), the sample grid (`sample_decoded` against JAX's
`make_denoise_fn` + decode on the same latents, 4 steps, atol 1e-5) and
`MetricsLogger` (tags and values, both writers replaced by a recorder);
then the trainer itself on PNG files: pixel space and a tiny VAE, a resume
at step 3 of 6 bit-equal to the straight run (losses and the final
checkpoint), validation, sampling, profiling, `--debug_nans` and the two
combinations the JAX trainer fails late on (R6, R7), rejected before the
first step."""

import json
import logging
import math
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f_lite_tpu.models import vae as jvae
from f_lite_tpu.models.dit import DiT as JaxDiT
from f_lite_tpu.models.dit import DiTConfig as JaxDiTConfig
from f_lite_tpu.sampling.euler import DenoiseSettings as JaxSettings
from f_lite_tpu.sampling.euler import make_denoise_fn
from f_lite_tpu.text.encoder import ZeroTextEncoder as JaxZeroTextEncoder
from f_lite_tpu.train import trainer as jtrainer
from f_lite_tpu_torch.convert.from_jax import state_dict_from_jax
from f_lite_tpu_torch.data.image_ops import denormalize_to_u8
from f_lite_tpu_torch.models import vae as tvae
from f_lite_tpu_torch.models.dit import DiT, DiTConfig
from f_lite_tpu_torch.text.encoder import ZeroTextEncoder
from f_lite_tpu_torch.train import trainer
from f_lite_tpu_torch.train.checkpoint import Checkpointer
from f_lite_tpu_torch.utils.image import make_image_grid, png_bytes_with_metadata, read_png
from test_torch_dit import random_jax_params, unflatten
from test_torch_vae import _pair



@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny models: one intra-op thread each, so that parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_vae_posterior_sample_matches_jax():
    jmodel, jparams, model = _pair("tiny", seed=3)
    x = np.random.RandomState(4).uniform(-1, 1, (2, 12, 16, 3)).astype(np.float32)
    rng = jax.random.key(11)
    want = np.asarray(jmodel.apply(jparams, jnp.asarray(x), rng,
                                   method=jvae.AutoencoderKL.encode))
    eps = np.array(jax.random.normal(rng, want.shape, jnp.float32))
    with torch.no_grad():
        got = model.encode(torch.from_numpy(x), noise=torch.from_numpy(eps)).numpy()
        mean = model.encode(torch.from_numpy(x)).numpy()
        g = torch.Generator().manual_seed(0)
        drawn = model.encode(torch.from_numpy(x), generator=g)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(got - mean).max() > 1e-3  # a sample, not the mean
    assert drawn.shape == want.shape and drawn.dtype == torch.float32
    ident = torch.ones(1, 4, 4, 3)
    assert tvae.IdentityVAE().encode(ident, generator=g) is ident


def test_encode_batch_matches_jax_encode_and_text():
    jmodel, jparams, model = _pair("tiny", seed=5)
    rs = np.random.RandomState(6)
    batch = {"image": rs.uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32),
             "caption": ["a red circle", "", "a blue square"]}
    gen = trainer.encode_generator("cpu", 2, 7)
    latents, ctx, mask = trainer.encode_batch(
        batch, model, ZeroTextEncoder(24, seq_len=32), generator=gen,
        dtype=torch.float32, device=torch.device("cpu"), batch_multiplicity=2)
    mean, logvar = jmodel.apply(jparams, jnp.asarray(batch["image"]),
                                method=jvae.AutoencoderKL.encode_moments)
    eps = torch.randn(mean.shape, generator=trainer.encode_generator("cpu", 2, 7))
    want = np.asarray(jvae.normalize_latents(
        mean + jnp.exp(0.5 * logvar) * jnp.asarray(eps.numpy()), jmodel.config))
    want_ctx, want_mask = JaxZeroTextEncoder(24, seq_len=32).encode(batch["caption"])
    assert latents.shape == (6, 8, 8, 4) and ctx.shape == (6, 32, 24)
    np.testing.assert_allclose(latents.numpy(), np.tile(want, (2, 1, 1, 1)),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(ctx.numpy(), np.tile(want_ctx, (2, 1, 1)),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(mask.numpy(), np.tile(want_mask, (2, 1)))


SMALL = dict(in_channels=4, patch_size=2, hidden_size=64, depth=3, num_heads=4,
             mlp_ratio=2.0, cross_attn_input_size=24, residual_v=True,
             cross_attn_first_n=1, cross_attn_period=2)


def test_sample_grid_matches_jax_denoise_and_decode(tmp_path):
    jcfg = JaxDiTConfig(**SMALL, use_pallas_attention=False)
    flat = random_jax_params(jcfg, 21)
    cfg = DiTConfig(**SMALL)
    model = DiT(cfg)
    model.load_state_dict(state_dict_from_jax(flat, cfg), strict=True)
    jvae_model, jvae_params, vae = _pair("tiny", seed=8)
    prompts = ["a red circle", "a green square", "a cyan triangle", "x", "y"]
    (tmp_path / "prompts.txt").write_text("\n".join(prompts) + "\n\n")
    latents = np.random.RandomState(9).randn(5, 8, 8, 4).astype(np.float32)
    got = trainer.sample_decoded(model, vae, ZeroTextEncoder(24, seq_len=32), 7,
                                 num_inference_steps=4,
                                 prompts_file=str(tmp_path / "prompts.txt"),
                                 latents=torch.from_numpy(latents))
    embeds, mask = JaxZeroTextEncoder(24, seq_len=32).encode(prompts)
    fn = make_denoise_fn(JaxDiT(jcfg).apply,
                         JaxSettings(num_inference_steps=4, guidance_scale=6.0),
                         donate=False)
    pos = jnp.asarray(embeds)
    final = fn({"params": unflatten(flat)}, jnp.asarray(latents), pos,
               jnp.zeros_like(pos), jnp.asarray(mask))
    want = np.asarray(jvae_model.apply(
        jvae_params, jvae.denormalize_latents(final, jvae_model.config),
        method=jvae.AutoencoderKL.decode))
    assert got.shape == want.shape == (5, 16, 16, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    grid = trainer.sample_images(model, vae, ZeroTextEncoder(24, seq_len=32), 7,
                                 num_inference_steps=4,
                                 prompts_file=str(tmp_path / "prompts.txt"),
                                 output_dir=tmp_path,
                                 latents=torch.from_numpy(latents))
    np.testing.assert_array_equal(grid, make_image_grid(denormalize_to_u8(got), nrow=3))
    assert grid.shape == (16 * 2 + 2, 16 * 3 + 4, 3)
    np.testing.assert_array_equal(
        read_png((tmp_path / "samples" / "step_7.png").read_bytes()), grid)


class Recorder:
    """Stands in for tensorboardX's SummaryWriter and the wandb module."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name in ("Histogram", "Image"):
            return lambda x: (name, np.asarray(x).tolist())
        return lambda *a, **kw: self.calls.append((name, _plain(a), _plain(kw)))


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.tolist())
    if isinstance(x, (np.floating, float)):
        return float(x)
    return x


def test_metrics_logger_records_what_jax_records(caplog):
    args = SimpleNamespace(report_to="none", output_dir=".", logging_dir="logs",
                           project_name="p", run_name=None)
    loggers = []
    for cls in (jtrainer.MetricsLogger, trainer.MetricsLogger):
        m = cls(args)
        m.tb, m.wandb = Recorder(), Recorder()
        loggers.append(m)
    scalars = {"train/loss": 0.25, "train/lr": np.float32(1e-4), "train/step": 3,
               "metrics/avg_loss_bin_2": np.float32(0.5) / np.float32(3.0)}
    grid = np.random.RandomState(0).randint(0, 256, (10, 14, 3)).astype(np.uint8)
    for m in loggers:
        m.log(scalars, 3)
        m.log_histogram("metrics/diffusion_loss_bin_counts",
                        np.array([0, 2, 0, 1, 0, 0, 0, 0, 0, 5], np.float32), 3)
        m.log_histogram("empty", np.zeros(10), 3)
        m.log_image("samples", grid, 3)
    want, got = loggers
    assert got.tb.calls == want.tb.calls and len(got.tb.calls) == 6
    assert got.wandb.calls == want.wandb.calls and len(got.wandb.calls) == 3
    # no backend where one was asked for: the JAX error line, and the run goes on
    args.report_to = "wandb"
    with caplog.at_level(logging.ERROR):
        trainer.MetricsLogger(args)
    assert any("NO metrics backend is active (--report_to wandb" in r.getMessage()
               for r in caplog.records)


def _write_pngs(root: Path, n=16, size=32, seed=0) -> Path:
    rs = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        img = np.full((size, size, 3), 110, np.uint8)
        y, x = rs.randint(4, size - 12, 2)
        img[y:y + 8, x:x + 8] = rs.randint(0, 256, 3)
        f = root / f"{i}.png"
        f.write_bytes(png_bytes_with_metadata(img))
        rows.append({"media_path": str(f), "captions": [f"shape {i % 4}", f"alt {i % 4}"],
                     "width": size, "height": size})
    table = root / "table.json"
    table.write_text(json.dumps(rows))
    return table


def _argv(table, out, *extra, steps=3, pixel=True):
    argv = ["--device", "cpu", "--train_data_path", str(table),
            "--root_dir_type", "json", "--base_url", "file://", "--resolution", "32",
            "--center_crop", "--model_width", "64", "--model_depth", "2",
            "--model_head_dim", "32", "--cross_attn_input_size", "16",
            "--train_batch_size", "4", "--num_epochs", "4", "--max_steps", str(steps),
            "--learning_rate", "1e-3", "--lr_scheduler", "constant", "--log_every", "1",
            "--seed", "0", "--num_workers", "2", "--report_to", "none",
            "--output_dir", str(out), *extra]
    return argv + (["--pixel_space"] if pixel else [])


def _run(argv, on_step=None):
    losses = []

    def record(state, metrics):
        losses.append(float(metrics["loss"]))
        if on_step is not None:
            on_step(state, metrics)

    result = trainer.train(trainer.parse_args(argv), on_step=record)
    return result, losses


@pytest.mark.parametrize("pixel", [True, False], ids=["pixel_space", "tiny_vae"])
def test_online_steps_train_with_finite_losses(tmp_path, pixel):
    table = _write_pngs(tmp_path)
    result, losses = _run(_argv(table, tmp_path / "out", pixel=pixel))
    assert result["global_step"] == 3 and len(losses) == 3
    assert all(math.isfinite(v) for v in losses) and result["train/grad_norm"] > 0
    assert result["loader_wait_s"] >= 0


def test_online_resume_is_bit_equal_to_the_straight_run(tmp_path):
    table = _write_pngs(tmp_path)
    common = ("--random_flip", "--checkpointing_steps", "3", "--sample_every", "0")
    _, straight = _run(_argv(table, tmp_path / "a", *common, steps=6))
    _, first = _run(_argv(table, tmp_path / "b", *common, steps=3))
    _, rest = _run(_argv(table, tmp_path / "b", *common, "--resume_from_checkpoint",
                         "latest", steps=6))
    assert len(straight) == 6 and straight == first + rest
    want = Checkpointer(tmp_path / "a").load(6)[1]
    got = Checkpointer(tmp_path / "b").load(6)[1]
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_an_error_inside_the_profiled_steps_closes_the_profile(tmp_path):
    """A step that raises between `--profile_steps`' ends leaves no span
    recording open in the process: the next one opens."""
    from f_lite_tpu_torch.utils import trace

    def fail(state, metrics):
        assert trace._recording is not None  # inside the profiled steps
        raise RuntimeError("step failed")

    table = _write_pngs(tmp_path)
    with pytest.raises(RuntimeError, match="step failed"):
        trainer.train(trainer.parse_args(_argv(table, tmp_path / "out", "--profile_steps",
                                               "0,2", "--sample_every", "0")),
                      on_step=fail)
    assert trace._recording is None
    with trace.recording():
        pass


def test_validation_sampling_and_profile_during_training(tmp_path, caplog, monkeypatch):
    table = _write_pngs(tmp_path)
    (tmp_path / "val").mkdir()
    val = _write_pngs(tmp_path / "val", n=8, seed=1)
    logged = []
    monkeypatch.setattr(trainer.MetricsLogger, "log",
                        lambda self, scalars, step: logged.append((step, dict(scalars))))
    with caplog.at_level(logging.INFO, logger="f_lite_tpu_torch.train"):
        result, losses = _run(_argv(
            table, tmp_path / "out", "--val_data_path", str(val), "--eval_every", "2",
            "--eval_batch_size", "4", "--sample_every", "3", "--debug",
            "--profile_steps", "1,2", steps=4))
    vals = [(step, s["val/loss"]) for step, s in logged if "val/loss" in s]
    assert [s for s, _ in vals] == [2, 4]
    assert all(math.isfinite(v) for _, v in vals) and result["val/loss"] == vals[-1][1]
    assert all(s["val/diffusion_loss"] == s["val/loss"] for _, s in logged if "val/loss" in s)
    grid = read_png((tmp_path / "out" / "samples" / "step_3.png").read_bytes())
    assert grid.shape == (32 * 2 + 2, 32 * 3 + 4, 3)
    trace = json.loads((tmp_path / "out" / "profile" / "steps_1_2.json").read_text())
    assert trace["traceEvents"]
    # the program's spans, a track of their own: the profiled step's
    spans = [e for e in trace["traceEvents"] if e.get("cat") == "span"]
    assert {"train.step", "train.loss", "train.backward", "optim.update"} <= {
        e["name"] for e in spans}
    assert {e["pid"] for e in spans} == {"program spans"}
    assert any("dataset=16 images, 4 batches/epoch, max_steps=4" in r.getMessage()
               for r in caplog.records)


def test_debug_nans_raises_on_a_nan_and_changes_nothing_else(tmp_path, monkeypatch):
    table = _write_pngs(tmp_path)
    _, plain = _run(_argv(table, tmp_path / "a"))
    _, checked = _run(_argv(table, tmp_path / "b", "--debug_nans"))
    assert plain == checked
    encode = trainer.encode_batch
    calls = []

    def poisoned(batch, *a, **kw):
        latents, ctx, mask = encode(batch, *a, **kw)
        calls.append(1)
        if len(calls) == 2:
            latents = latents.clone()
            latents[0, 0, 0, 0] = float("nan")
        return latents, ctx, mask

    monkeypatch.setattr(trainer, "encode_batch", poisoned)
    with pytest.raises(FloatingPointError, match="step 2"):
        _run(_argv(table, tmp_path / "c", "--debug_nans"))


def _tiny_cache(root: Path) -> Path:
    from f_lite_tpu_torch.data.precomputed import PrecomputedCacheWriter

    writer = PrecomputedCacheWriter(root)
    rs = np.random.RandomState(0)
    for i in range(8):
        writer.add(str(i), f"c{i % 2}", rs.randn(16, 16, 3).astype(np.float32),
                   rs.randn(6, 16).astype(np.float32))
    writer.finalize()
    return root


def _precomputed_argv(cache, out, *extra):
    argv = _argv(cache, out, *extra)
    i = argv.index("--train_data_path")
    del argv[i:i + 2]
    return argv + ["--use_precomputed_data", "--precomputed_data_dir", str(cache)]


def test_r6_uncached_sample_prompts_raise_before_the_first_step(tmp_path):
    cache = _tiny_cache(tmp_path / "cache")
    steps = []
    with pytest.raises(KeyError, match="no precomputed embedding"):
        _run(_precomputed_argv(cache, tmp_path / "out", "--sample_every", "2"),
             on_step=lambda s, m: steps.append(1))
    assert not steps and not list((tmp_path / "out" / "checkpoints").iterdir())
    # cached prompts sample; sampling past max_steps is not checked
    (tmp_path / "p.txt").write_text("c0\nc1\n")
    result, _ = _run(_precomputed_argv(cache, tmp_path / "out", "--sample_every", "2",
                                       "--sample_prompts_file", str(tmp_path / "p.txt")))
    assert (tmp_path / "out" / "samples" / "step_2.png").exists()
    result, _ = _run(_precomputed_argv(cache, tmp_path / "out2", "--sample_every", "500"))
    assert result["global_step"] == 3


def test_r7_validation_on_the_precomputed_path_is_rejected(tmp_path):
    cache = _tiny_cache(tmp_path / "cache")
    with pytest.raises(SystemExit, match="--val_data_path with --use_precomputed_data"):
        _run(_precomputed_argv(cache, tmp_path / "out", "--val_data_path",
                               str(tmp_path / "v.json")))
