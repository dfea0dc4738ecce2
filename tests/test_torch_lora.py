"""LoRA at load in the port against the JAX package, on the CPU.

- `convert.lora_torch`: the port's peft <-> framework conversion equals the
  JAX package's bit for bit, and the error cases of
  `tests/test_lora_convert.py` raise in the port where they raise in JAX.
- `train.lora.load_lora_weights`: the framework's safetensors (a dir or the
  file) and a peft `lora_weights.pt` give the JAX package's factor trees.
- `FLitePipeline.from_pretrained(lora_path=...)` against JAX's with
  `scan_layers=False` (a JAX scan base is the reference fault of
  `tests/test_pipeline.py:539`): fp32 images within MSE < 1e-9 and merged
  weights within 1e-6; bf16 merged weights within one bf16 ulp;
  `lora_scale=0` bit-equal to the pipeline without LoRA; the peft and the
  safetensors forms give equal images; with `quantize=True` within 1% of
  the JAX int8 path's own quantization MSE (the bar of
  `tests/test_torch_quant.py`); the layouts JAX cannot merge raise.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f_lite_tpu.convert import lora_torch as jlora_torch
from f_lite_tpu.models import vae as jvae
from f_lite_tpu.models.dit import DiT as JaxDiT
from f_lite_tpu.models.dit import DiTConfig as JaxDiTConfig
from f_lite_tpu.pipeline import FLitePipeline as JaxPipeline
from f_lite_tpu.train import lora as jlora
from f_lite_tpu_torch.convert import lora_torch
from f_lite_tpu_torch.convert.from_jax import state_dict_from_jax
from f_lite_tpu_torch.models.dit import DiTConfig
from f_lite_tpu_torch.pipeline import FLitePipeline
from f_lite_tpu_torch.train import lora
from test_torch_dit import flatten, random_jax_params, unflatten

TINY = dict(in_channels=4, patch_size=2, hidden_size=64, depth=3, num_heads=4,
            mlp_ratio=2.0, cross_attn_input_size=32, residual_v=True,
            train_bias_and_rms=True, cross_attn_first_n=1, cross_attn_period=2)
RANK, ALPHA = 4, 8.0
MSE_FRACTION = 0.01  # of the JAX int8 path's own quantization MSE


def _rand_lora_tree(seed, cfg=DiTConfig(**TINY), rank=RANK):
    """Framework factors on every target of every block, A and B both
    seeded and non-zero."""
    rs = np.random.RandomState(seed)
    d = cfg.hidden_size
    out_flat = {"qkv": 3 * d, "q": d, "context_kv": 2 * d, "proj": d}
    tree = {}
    for i in range(cfg.depth):
        attns = {"self_attn": ("qkv", "proj")}
        if cfg.block_has_cross_attn(i):
            attns["cross_attn"] = ("q", "context_kv", "proj")
        tree[f"blocks_{i}"] = {attn: {t: {
            "lora_a": (rs.randn(d, rank) * 0.3).astype(np.float32),
            "lora_b": (rs.randn(rank, out_flat[t]) * 0.3).astype(np.float32)}
            for t in targets} for attn, targets in attns.items()}
    return tree


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


# ---------------------------------------------------------------------------
# convert.lora_torch and load_lora_weights
# ---------------------------------------------------------------------------

def test_peft_conversion_equals_the_jax_package():
    tree = _rand_lora_tree(0)
    sd = jlora_torch.lora_to_peft_state_dict(tree)
    got = lora_torch.lora_to_peft_state_dict(tree)
    assert set(got) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(got[k], sd[k])
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    want, back = _leaves(jlora_torch.lora_from_peft_state_dict(tsd)), _leaves(
        lora_torch.lora_from_peft_state_dict(tsd))
    assert set(back) == set(want) == set(_leaves(tree))
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])
        np.testing.assert_array_equal(back[k], _leaves(tree)[k])


def _peft_prefixed():
    sd = jlora_torch.lora_to_peft_state_dict(_rand_lora_tree(2, DiTConfig(
        **{**TINY, "depth": 1})))
    return {f"base_model.model.{k}": v for k, v in sd.items()}


def _peft_default_segment():
    return {"blocks.0.self_attn.qkv.lora_A.default.weight": np.ones((4, 8), np.float32),
            "blocks.0.self_attn.qkv.lora_B.default.weight": np.ones((24, 4), np.float32)}


# (function, input, exception match or None where it must not raise)
CONVERT_CASES = {
    "prefix_stripped": ("lora_from_peft_state_dict", _peft_prefixed, None),
    "adapter_name_segment": ("lora_from_peft_state_dict", _peft_default_segment, None),
    "unknown_key": ("lora_from_peft_state_dict", lambda: {
        "blocks.0.mlp.gate_proj.lora_A.weight": np.zeros((4, 8))}, "unrecognized"),
    "unknown_tree_node": ("lora_to_peft_state_dict", lambda: {
        "final_proj": {"lora_a": np.zeros((8, 4)), "lora_b": np.zeros((4, 8))}},
        "unexpected"),
    "rank_mismatch": ("lora_from_peft_state_dict", lambda: {
        "blocks.0.self_attn.qkv.lora_A.weight": np.zeros((4, 8)),
        "blocks.0.self_attn.qkv.lora_B.weight": np.zeros((16, 3))}, "rank mismatch"),
    "mixed_rank": ("lora_from_peft_state_dict", lambda: {
        "blocks.0.self_attn.qkv.lora_A.weight": np.zeros((4, 8)),
        "blocks.0.self_attn.qkv.lora_B.weight": np.zeros((24, 4)),
        "blocks.0.self_attn.proj.lora_A.weight": np.zeros((8, 8)),
        "blocks.0.self_attn.proj.lora_B.weight": np.zeros((8, 8))}, "mixed-rank"),
    "missing_b_in_peft": ("lora_from_peft_state_dict", lambda: {
        "blocks.0.self_attn.qkv.lora_A.weight": np.zeros((4, 8))}, "missing"),
    "missing_b_in_tree": ("lora_to_peft_state_dict", lambda: {
        "blocks_0": {"self_attn": {"qkv": {"lora_a": np.zeros((8, 4))}}}},
        "lora_a and lora_b"),
    "empty_tree": ("lora_to_peft_state_dict", lambda: {}, "empty"),
}


@pytest.mark.parametrize("case", list(CONVERT_CASES))
def test_conversion_raises_where_the_jax_package_raises(case):
    fn, make, match = CONVERT_CASES[case]
    if match is None:
        want = _leaves(getattr(jlora_torch, fn)(make()))
        got = _leaves(getattr(lora_torch, fn)(make()))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        return
    for module in (jlora_torch, lora_torch):
        with pytest.raises(ValueError, match=match):
            getattr(module, fn)(make())


@pytest.fixture(scope="module")
def lora_dirs(tmp_path_factory):
    """The same adapter in the framework's safetensors form (written by the
    JAX package's `save_lora_weights`) and in the peft `.pt` form."""
    root = tmp_path_factory.mktemp("lora")
    tree = _rand_lora_tree(1)
    (root / "st").mkdir()
    jlora.save_lora_weights(tree, root / "st")
    (root / "pt").mkdir()
    torch.save({k: torch.from_numpy(v) for k, v in
                jlora_torch.lora_to_peft_state_dict(tree).items()},
               root / "pt" / "lora_weights.pt")
    return root


@pytest.mark.parametrize("form", ["st_dir", "st_file", "pt_dir", "pt_file"])
def test_load_lora_weights_gives_the_jax_tree(lora_dirs, form):
    path = {"st_dir": lora_dirs / "st",
            "st_file": lora_dirs / "st" / "lora_weights.safetensors",
            "pt_dir": lora_dirs / "pt",
            "pt_file": lora_dirs / "pt" / "lora_weights.pt"}[form]
    want = _leaves(jlora.load_lora_weights(path))
    got = _leaves(lora.load_lora_weights(path))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert lora.lora_rank(lora.load_lora_weights(path)) == RANK


def test_load_lora_weights_names_what_an_empty_dir_lacks(tmp_path):
    for module in (jlora, lora):
        with pytest.raises(FileNotFoundError, match="no LoRA weights"):
            module.load_lora_weights(tmp_path)


# ---------------------------------------------------------------------------
# from_pretrained(lora_path=...)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    """A latent-space pipeline (tiny DiT with biases, tiny VAE) saved
    unrolled by the JAX package, with seeded non-zero weights."""
    path = tmp_path_factory.mktemp("lora_pipe")
    cfg = JaxDiTConfig(**TINY)
    params = {"params": unflatten(random_jax_params(cfg, seed=31))}
    vae = jvae.AutoencoderKL(jvae.VAEConfig.tiny())
    vparams = vae.init(jax.random.key(3), jnp.zeros((1, 8, 8, 3)))
    JaxPipeline(JaxDiT(cfg), params, vae, vparams).save_pretrained(path)
    return path


def _request(pipe, latents):
    rs = np.random.RandomState(11)
    embeds = rs.randn(2, 8, 32).astype(np.float32)
    mask = np.arange(8)[None, :] < np.array([8, 5])[:, None]
    return np.asarray(pipe(prompt_embeds=embeds, context_mask=mask, latents=latents,
                           num_inference_steps=3, guidance_scale=4.0,
                           output_type="np").images)


LATENTS = np.random.RandomState(12).randn(2, 8, 8, 4).astype(np.float32)


def _port(path, **kw):
    return FLitePipeline.from_pretrained(path, device="cpu", **kw)


def _jax(path, **kw):
    return JaxPipeline.from_pretrained(path, load_text_encoder=False,
                                       scan_layers=False, **kw)


def _jax_state_dict(jpipe):
    """The JAX pipeline's (merged) DiT weights in the port's layout."""
    return state_dict_from_jax(flatten(jpipe.dit_params["params"]), DiTConfig(**TINY))


@pytest.mark.parametrize("form", ["st", "pt"])
def test_fp32_lora_pipeline_matches_jax(tiny_dir, lora_dirs, form):
    kw = dict(lora_path=lora_dirs / form, lora_alpha=ALPHA)
    tpipe = _port(tiny_dir, dtype=torch.float32, **kw)
    jpipe = _jax(tiny_dir, dtype=jnp.float32, **kw)
    want_sd = _jax_state_dict(jpipe)
    got_sd = tpipe.dit.state_dict()
    base = _port(tiny_dir, dtype=torch.float32).dit.state_dict()
    changed = [k for k in base if not torch.equal(base[k], got_sd[k])]
    assert len(changed) == 2 * 3 + 3 * 2  # qkv, proj a block; q, context_kv, proj cross
    for k, v in want_sd.items():
        torch.testing.assert_close(got_sd[k], v, atol=1e-6, rtol=0, msg=k)
    got = _request(tpipe, LATENTS)
    want = _request(jpipe, jnp.asarray(LATENTS))
    mse = float(np.mean((got - want) ** 2))
    assert mse < 1e-9, mse
    no_lora = _request(_port(tiny_dir, dtype=torch.float32), LATENTS)
    assert float(np.mean((got - no_lora) ** 2)) > 1e3 * max(mse, 1e-12)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers at |x| (x held in fp32)."""
    _, e = np.frexp(np.maximum(np.abs(x), np.float32(2.0 ** -126)))
    return np.ldexp(np.float32(1.0), e - 8).astype(np.float32)


def test_bf16_merged_weights_within_one_ulp_of_jax(tiny_dir, lora_dirs):
    kw = dict(lora_path=lora_dirs / "st", lora_alpha=ALPHA, lora_scale=0.7)
    got_sd = _port(tiny_dir, dtype=torch.bfloat16, **kw).dit.state_dict()
    want_sd = _jax_state_dict(_jax(tiny_dir, dtype=jnp.bfloat16, **kw))
    worst = 0.0
    for k, v in want_sd.items():
        assert got_sd[k].dtype == torch.bfloat16, k
        g, w = got_sd[k].float().numpy(), v.numpy()
        worst = max(worst, float((np.abs(g - w) / _bf16_ulp(w)).max()))
    assert worst <= 1.0, worst


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_scale_zero_is_the_pipeline_without_lora_bit_for_bit(tiny_dir, lora_dirs, dtype):
    got = _request(_port(tiny_dir, dtype=dtype, lora_path=lora_dirs / "st",
                         lora_scale=0.0), LATENTS)
    np.testing.assert_array_equal(got, _request(_port(tiny_dir, dtype=dtype), LATENTS))


def test_peft_and_safetensors_forms_give_equal_images(tiny_dir, lora_dirs):
    st = _request(_port(tiny_dir, dtype=torch.bfloat16, lora_path=lora_dirs / "st"),
                  LATENTS)
    pt = _request(_port(tiny_dir, dtype=torch.bfloat16,
                        lora_path=lora_dirs / "pt" / "lora_weights.pt"), LATENTS)
    np.testing.assert_array_equal(st, pt)


def test_alpha_defaults_to_the_rank(tiny_dir, lora_dirs):
    a = _port(tiny_dir, dtype=torch.float32, lora_path=lora_dirs / "st").dit.state_dict()
    b = _port(tiny_dir, dtype=torch.float32, lora_path=lora_dirs / "st",
              lora_alpha=RANK).dit.state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], atol=0, rtol=0)


def test_int8_lora_pipeline_matches_jax(tiny_dir, lora_dirs):
    kw = dict(lora_path=lora_dirs / "st", lora_alpha=ALPHA)
    jax_images = {q: _request(_jax(tiny_dir, dtype=jnp.float32, quantize=q, **kw),
                              jnp.asarray(LATENTS)) for q in (False, True)}
    tpipe = _port(tiny_dir, dtype=torch.float32, quantize=True, **kw)
    assert tpipe.dit.config.quantized
    got = _request(tpipe, LATENTS)
    noise = float(np.mean((jax_images[True] - jax_images[False]) ** 2))
    diff = float(np.mean((got - jax_images[True]) ** 2))
    assert noise > 0
    assert diff <= MSE_FRACTION * noise, (diff, noise)


def test_apply_lora_skips_layers_the_dit_lacks_and_counts_the_merges():
    from f_lite_tpu_torch.models.dit import DiT

    dit = DiT(DiTConfig(**TINY))
    tree = _rand_lora_tree(4)
    tree["blocks_9"] = tree["blocks_0"]
    tree["blocks_1"]["cross_attn"] = tree["blocks_0"]["cross_attn"]  # block 1 has none
    assert lora.apply_lora(dit, tree, alpha=ALPHA, rank=RANK) == 12
    assert lora.apply_lora(dit, {"params": {}}, alpha=ALPHA, rank=RANK) == 0


def _layout_dir(tiny_dir, tmp_path, kind):
    path = tmp_path / kind
    if kind == "scan":
        JaxPipeline.from_pretrained(tiny_dir, dtype=jnp.float32, load_text_encoder=False,
                                    scan_layers=True).save_pretrained(path)
    elif kind == "padded_heads":
        JaxPipeline.from_pretrained(tiny_dir, dtype=jnp.float32, load_text_encoder=False,
                                    scan_layers=False, pad_heads_to=6).save_pretrained(path)
    else:
        _port(tiny_dir, dtype=torch.float32, quantize=True).save_pretrained(path)
    return path


@pytest.mark.parametrize("kind", ["scan", "padded_heads", "int8"])
def test_layouts_jax_cannot_merge_raise(tiny_dir, lora_dirs, tmp_path, kind):
    path = _layout_dir(tiny_dir, tmp_path, kind)
    kw = dict(lora_path=lora_dirs / "st", quantize=kind == "int8")
    with pytest.raises(Exception):
        JaxPipeline.from_pretrained(path, dtype=jnp.float32, load_text_encoder=False, **kw)
    with pytest.raises(ValueError, match="matched no kernels" if kind == "scan" else "LoRA"):
        _port(path, dtype=torch.float32, **kw)


def test_lora_without_a_factors_raises(tiny_dir, tmp_path):
    (tmp_path / "empty").mkdir()
    from f_lite_tpu_torch.utils.safetensors import save_file

    save_file({"blocks_0.self_attn.qkv.other": np.zeros(2, np.float32)},
              tmp_path / "empty" / "lora_weights.safetensors")
    with pytest.raises(ValueError, match="no lora_a factors"):
        _port(tiny_dir, dtype=torch.float32, lora_path=tmp_path / "empty")
    shutil.rmtree(tmp_path / "empty")
