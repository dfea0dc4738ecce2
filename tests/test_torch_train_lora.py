"""LoRA training and fine-tuning from a pipeline in the port's trainer,
against the JAX package, on the CPU in fp32.

- `init_lora_params`: the factor tree's keys and shapes are JAX's;
- the training-time merge (`attach_lora`): the DiT's forward against JAX's
  `apply_lora` forward with the same factors (MSE < 1e-9), and the factor
  gradients against `jax.grad` (1e-4 relative);
- `--use_lora` from `--pretrained_model_path`: the base stays bit for bit,
  `lora_weights.safetensors` reads back through JAX's `load_lora_weights`
  exactly, and the export merges the factors as JAX's `apply_lora` does;
- `--pretrained_model_path` of a JAX-saved pipeline, unrolled and in the
  scan layout (the reference's layout fault, ROADMAP Queue C), at lr 0:
  the export's DiT is the pipeline's bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f_lite_tpu.models.dit import DiT as JaxDiT
from f_lite_tpu.models.dit import DiTConfig as JaxDiTConfig
from f_lite_tpu.pipeline import FLitePipeline as JaxPipeline
from f_lite_tpu.train import lora as jlora
from f_lite_tpu_torch.convert.from_jax import state_dict_from_jax
from f_lite_tpu_torch.models.dit import DiTConfig
from f_lite_tpu_torch.pipeline import FLitePipeline
from f_lite_tpu_torch.train import lora
from f_lite_tpu_torch.train.trainer import parse_args, train
from test_torch_dit import flatten, random_jax_params, unflatten
from test_torch_train import SMALL, _batch, _jax_loss, _port_loss, _port_model, _tiny_cache

RANK, ALPHA = 4, 8.0


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny models: one intra-op thread each, so that parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
# the model of test_torch_train._tiny_argv
TINY_ARGV_CFG = dict(in_channels=3, patch_size=2, hidden_size=128, depth=3, num_heads=2,
                     cross_attn_input_size=32, residual_v=True)


def _jax_params(seed):
    jcfg = JaxDiTConfig(**SMALL, use_pallas_attention=False)
    return jcfg, random_jax_params(jcfg, seed)


def _random_factors(jax_tree, seed):
    """JAX's factor tree for the DiT, with non-zero lora_b."""
    tree = jlora.init_lora_params(jax.random.key(seed), {"params": jax_tree}, rank=RANK)
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda x: jnp.asarray(rs.randn(*x.shape).astype(np.float32) * 0.1),
                        tree["params"])


@pytest.mark.parametrize("targets", [lora.DEFAULT_TARGETS, ("qkv", "proj")])
def test_factor_tree_keys_and_shapes_match_jax(targets):
    jcfg, flat = _jax_params(31)
    want = jlora.init_lora_params(jax.random.key(7), {"params": unflatten(flat)},
                                  rank=RANK, targets=targets)
    model = _port_model(SMALL, flat)
    got = lora.init_lora_params(model, rank=RANK, targets=targets,
                                generator=torch.Generator().manual_seed(7))
    want_flat = flatten(want["params"])
    got_flat = lora.flatten_lora(got)
    assert list(got_flat) == sorted(got_flat)
    assert set(got_flat) == set(want_flat)
    for k, v in want_flat.items():
        assert tuple(got_flat[k].shape) == v.shape, k
        if k.endswith("lora_b"):
            assert not got_flat[k].any()
        else:
            assert abs(float(got_flat[k].std()) - 0.02) < 0.005, k


def test_training_merge_matches_jax_apply_lora_forward():
    jcfg, flat = _jax_params(32)
    params = unflatten(flat)
    factors = _random_factors(params, 33)
    b = _batch(11)
    merged = jlora.apply_lora({"params": params}, {"params": factors}, alpha=ALPHA,
                              rank=RANK)
    want = np.asarray(JaxDiT(jcfg).apply(
        merged, *(jnp.asarray(b[k]) for k in ("latents", "context", "mask", "timesteps"))))
    model = _port_model(SMALL, flat)
    lora.attach_lora(model, jax.tree.map(np.asarray, factors), alpha=ALPHA, rank=RANK)
    with torch.no_grad():
        got = model(*(torch.from_numpy(b[k]) for k in ("latents", "context", "mask",
                                                      "timesteps"))).numpy()
    base = np.asarray(JaxDiT(jcfg).apply(
        {"params": params}, *(jnp.asarray(b[k]) for k in ("latents", "context", "mask",
                                                          "timesteps"))))
    assert float(((want - base) ** 2).mean()) > 1e-6  # the factors matter
    assert float(((got - want) ** 2).mean()) < 1e-9
    lora.detach_lora(model)
    with torch.no_grad():
        back = model(*(torch.from_numpy(b[k]) for k in ("latents", "context", "mask",
                                                       "timesteps"))).numpy()
    assert float(((back - base) ** 2).mean()) < 1e-9


def test_factor_grads_match_jax_grad():
    """The flow-matching loss through the merged weights: per factor max
    |g - g_jax| <= 1e-4 * max |g_jax|; no base parameter takes a
    gradient."""
    jcfg, flat = _jax_params(34)
    params = unflatten(flat)
    factors = _random_factors(params, 35)
    b = _batch(12)
    loss_fn, _ = _jax_loss(jcfg, flat, b)
    jgrads = jax.grad(lambda f: loss_fn(jlora.apply_lora(
        {"params": params}, {"params": f}, alpha=ALPHA, rank=RANK)["params"])[0])(factors)
    model = _port_model(SMALL, flat)
    trained = lora.attach_lora(model, jax.tree.map(np.asarray, factors), alpha=ALPHA,
                               rank=RANK)
    _port_loss(model, b)[0].backward()
    want = flatten(jgrads)
    got = lora.flatten_lora(trained)
    assert set(got) == set(want)
    for k, g_jax in want.items():
        scale = float(np.abs(g_jax).max())
        assert scale > 0, k
        assert float(np.abs(got[k].grad.numpy() - g_jax).max()) <= 1e-4 * scale, k
    assert all(p.grad is None for n, p in model.named_parameters()
               if not n.endswith(("lora_a", "lora_b")))


def _jax_pipeline_dir(tmp_path, scan: bool):
    jcfg = JaxDiTConfig(**TINY_ARGV_CFG, use_pallas_attention=False)
    flat = random_jax_params(jcfg, 36)
    path = tmp_path / "unrolled"
    JaxPipeline(JaxDiT(jcfg), {"params": unflatten(flat)}).save_pretrained(path)
    if scan:
        JaxPipeline.from_pretrained(path, dtype=jnp.float32, load_text_encoder=False,
                                    scan_layers=True).save_pretrained(tmp_path / "scan")
        path = tmp_path / "scan"
    return path, flat


def _argv(cache, out, pretrained, *extra):
    from test_torch_train import _tiny_argv

    argv = _tiny_argv(cache, out)
    argv.remove("--gradient_checkpointing")
    return argv + ["--pretrained_model_path", str(pretrained), *extra]


@pytest.mark.parametrize("layout", ["unrolled", "scan"])
def test_fine_tune_at_lr_0_exports_the_pipeline_bit_for_bit(tmp_path, layout):
    path, _ = _jax_pipeline_dir(tmp_path, scan=layout == "scan")
    cache = _tiny_cache(tmp_path / "cache")
    train(parse_args(_argv(cache, tmp_path / "out", path, "--learning_rate", "0")))
    want = FLitePipeline.from_pretrained(path, dtype=torch.float32, device="cpu")
    got = FLitePipeline.from_pretrained(tmp_path / "out" / "pipeline", dtype=torch.float32,
                                        device="cpu")
    want_sd, got_sd = want.dit.state_dict(), got.dit.state_dict()
    assert set(want_sd) == set(got_sd)
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k


def test_pretrained_dit_that_does_not_fit_the_arguments_raises(tmp_path):
    path, _ = _jax_pipeline_dir(tmp_path, scan=False)
    cache = _tiny_cache(tmp_path / "cache")
    argv = _argv(cache, tmp_path / "out", path)
    argv[argv.index("--model_depth") + 1] = "2"
    with pytest.raises(ValueError, match="does not fit the model the arguments build"):
        train(parse_args(argv))


def test_lora_training_keeps_the_base_and_saves_what_jax_reads(tmp_path):
    """3 LoRA steps from a pipeline: every base tensor unchanged bit for bit,
    the factors moved; `lora_weights.safetensors` of the final checkpoint
    equals them through JAX's `load_lora_weights`; the export's weights are
    JAX's `apply_lora` of the base and those factors (1e-6)."""
    path, flat = _jax_pipeline_dir(tmp_path, scan=False)
    cache = _tiny_cache(tmp_path / "cache")
    snapshots = []  # the model's parameters after each step

    def on_step(state, metrics):
        snapshots.append({n: p.detach().clone()
                          for n, p in state.model.named_parameters()})

    result = train(parse_args(_argv(cache, tmp_path / "out", path, "--use_lora",
                                    "--lora_rank", str(RANK), "--lora_alpha", "8")),
                   on_step=on_step)
    last = snapshots[-1]
    base = FLitePipeline.from_pretrained(path, dtype=torch.float32, device="cpu").dit
    originals = {n.replace(".parametrizations.weight.original", ".weight"): p
                 for n, p in last.items() if not n.endswith(("lora_a", "lora_b"))}
    assert set(originals) == set(base.state_dict())
    for n, v in base.state_dict().items():
        assert torch.equal(originals[n], v), n
    ckpt = tmp_path / "out" / "checkpoints" / str(result["global_step"])
    got = flatten(jlora.load_lora_weights(ckpt))
    factors = {".".join(("blocks_" + n.split(".")[1], *n.split(".")[2:4], n.rsplit(".", 1)[1])): p
               for n, p in last.items() if n.endswith(("lora_a", "lora_b"))}
    assert set(got) == set(factors) and len(got) == 2 * 5 * 3  # 3 blocks of qkv, proj, q, context_kv, proj
    assert any(float(v.abs().max()) > 0 for k, v in factors.items() if k.endswith("lora_b"))
    for k, v in factors.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)

    jcfg = JaxDiTConfig(**TINY_ARGV_CFG, use_pallas_attention=False)
    merged = jlora.apply_lora({"params": unflatten(flat)},
                              {"params": unflatten({k: np.asarray(v) for k, v in got.items()})},
                              alpha=8.0, rank=RANK)
    want = state_dict_from_jax(flatten(merged["params"]), DiTConfig(**TINY_ARGV_CFG))
    export = FLitePipeline.from_pretrained(tmp_path / "out" / "pipeline", dtype=torch.float32,
                                           device="cpu").dit.state_dict()
    assert jcfg.depth == 3 and set(export) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(export[k], v, rtol=0, atol=1e-6, msg=k)



@pytest.mark.parametrize("extra", [["--lora_dropout", "0.1"], ["--scan_layers"]])
def test_lora_options_the_jax_trainer_rejects_raise_its_message(tmp_path, extra):
    from f_lite_tpu.train.trainer import parse_args as jax_parse_args
    from f_lite_tpu.train.trainer import train as jax_train
    from test_torch_train import _tiny_argv

    argv = _tiny_argv(tmp_path, tmp_path / "out") + ["--use_lora", *extra]
    with pytest.raises(SystemExit) as want:
        jax_train(jax_parse_args(argv[2:]))  # the JAX trainer has no --device
    with pytest.raises(SystemExit) as got:
        train(parse_args(argv))
    assert str(got.value) == str(want.value) and "LoRA" in str(got.value)
