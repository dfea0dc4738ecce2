"""The port's prompt surface against the JAX pipeline's on the CPU:
`encode_prompt`, `__call__(prompt=, negative_prompt=)`,
`from_pretrained(text_encoder=, load_text_encoder=)`.

- `encode_prompt` with and without a negative prompt (of another length):
  the four arrays equal JAX's (masks exactly, embeddings within
  1e-5 * max, fp32 T5 encoders on one folder).
- The committed fixture through `pipe(prompt=captions)` with
  `ZeroTextEncoder` against the JAX pipeline's `prompt=` path: image MSE
  < 1e-6 (2 captions, 10 steps).
- A tiny latent pipeline saved by the JAX package with a `text_encoder/`,
  a `tokenizer/` and `text_encoder_type` "t5", then "qwen2": both packages'
  `from_pretrained` load the same encoder class in bf16, whose embeddings
  agree within 5% of the rms; with fp32 encoders passed as `text_encoder=`
  the `prompt=` images (two per prompt) agree as uint8 within 1.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f_lite_tpu.models import vae as jvae
from f_lite_tpu.models.dit import DiT as JaxDiT
from f_lite_tpu.models.dit import DiTConfig as JaxDiTConfig
from f_lite_tpu.pipeline import FLitePipeline as JaxPipeline
from f_lite_tpu.text import encoder as jenc
from f_lite_tpu.text import qwen2 as jq2
from f_lite_tpu_torch.pipeline import FLitePipeline
from f_lite_tpu_torch.text import encoder as penc
from f_lite_tpu_torch.text import qwen2 as pq2
from test_torch_dit import random_jax_params, unflatten
from test_torch_text import CHAT_TEMPLATE, _word_tokenizer

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = str(ROOT / "artifacts" / "fixture_run" / "pipeline")
WIDTH = 64  # the text towers' width = the tiny DiT's cross_attn_input_size

PROMPTS = ["a red circle", "a big green triangle on the left of a small "
           "blue square photo"]
NEGATIVES = {
    "none": None,
    "longer": ["a small red square on the right of a big blue circle photo "
               "on the left"] * 2,
    "shorter": ["blue", "red"],
}


def _hf_text_encoder(kind, seed):
    torch.manual_seed(seed)
    if kind == "t5":
        from transformers import T5Config, T5EncoderModel

        return T5EncoderModel(T5Config(
            vocab_size=100, d_model=WIDTH, d_kv=16, d_ff=96, num_layers=3,
            num_heads=4, relative_attention_num_buckets=8,
            relative_attention_max_distance=20,
            feed_forward_proj="gated-gelu", dropout_rate=0.0))
    from transformers import Qwen2Config, Qwen2Model

    model = Qwen2Model(Qwen2Config(
        vocab_size=128, hidden_size=WIDTH, intermediate_size=128,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256))
    with torch.no_grad():  # HF zero-inits biases
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.1)
    return model


@pytest.fixture(scope="module")
def text_dirs(tmp_path_factory):
    """{kind: a tiny latent pipeline written by the JAX package's
    save_pretrained, with text_encoder/, tokenizer/ and model_index.json's
    text_encoder_type = kind, return_index -2}."""
    cfg = JaxDiTConfig(in_channels=4, patch_size=2, hidden_size=64, depth=3,
                       num_heads=4, mlp_ratio=2.0, cross_attn_input_size=WIDTH,
                       residual_v=True, cross_attn_first_n=1,
                       cross_attn_period=2)
    params = {"params": unflatten(random_jax_params(cfg, seed=12))}
    vcfg = jvae.VAEConfig.tiny()
    vae = jvae.AutoencoderKL(vcfg)
    vparams = jax.jit(vae.init)(jax.random.key(1), jnp.zeros((1, 8, 8, 3)))
    dirs = {}
    for seed, kind in enumerate(("t5", "qwen2")):
        path = tmp_path_factory.mktemp(f"pipe_{kind}")
        JaxPipeline(JaxDiT(cfg), params, vae, vparams).save_pretrained(path)
        _hf_text_encoder(kind, seed).save_pretrained(
            path / "text_encoder", safe_serialization=True)
        _word_tokenizer(path / "tokenizer",
                        CHAT_TEMPLATE if kind == "qwen2" else None)
        index = json.loads((path / "model_index.json").read_text())
        index.update(text_encoder_type=kind, return_index=-2)
        (path / "model_index.json").write_text(json.dumps(index))
        dirs[kind] = path
    return dirs


def _fp32_encoders(kind, path):
    te, tok = str(path / "text_encoder"), str(path / "tokenizer")
    if kind == "t5":
        return (jenc.T5TextEncoder(te, tok, return_index=-2, dtype=jnp.float32),
                penc.T5TextEncoder(te, tok, return_index=-2, dtype=torch.float32,
                                   device="cpu"))
    return (jq2.Qwen2TextEncoder(te, tok, return_index=-2, dtype=jnp.float32),
            pq2.Qwen2TextEncoder(te, tok, return_index=-2, dtype=torch.float32,
                                 device="cpu"))


def _pipelines(path, kind=None, **kw):
    """(JAX pipeline, port pipeline) of `path` (fp32 DiTs); with `kind`,
    each package's fp32 encoder passed as `text_encoder=`."""
    jte = pte = None
    if kind is not None:
        jte, pte = _fp32_encoders(kind, path)
    jpipe = JaxPipeline.from_pretrained(path, dtype=jnp.float32, text_encoder=jte, **kw)
    pipe = FLitePipeline.from_pretrained(path, dtype=torch.float32, device="cpu",
                                         text_encoder=pte, **kw)
    return jpipe, pipe


@pytest.mark.parametrize("negative", list(NEGATIVES))
def test_encode_prompt_matches_jax(text_dirs, negative):
    jpipe, pipe = _pipelines(text_dirs["t5"], "t5")
    want = jpipe.encode_prompt(PROMPTS, NEGATIVES[negative])
    got = pipe.encode_prompt(PROMPTS, NEGATIVES[negative])
    embeds, neg, mask, neg_mask = got
    assert embeds.shape == neg.shape and mask.shape == neg_mask.shape
    if negative == "none":
        assert not neg.any() and neg_mask.all() and not mask.all()
    else:
        assert neg.any() and not np.array_equal(neg_mask, mask)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.asarray(w).dtype
    np.testing.assert_array_equal(mask, want[2])
    np.testing.assert_array_equal(neg_mask, want[3])
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * max(float(np.abs(w).max()), 1e-30))


def test_fixture_prompt_path_matches_jax():
    captions = ["a red circle", "a blue square"]
    latents = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    jpipe = JaxPipeline.from_pretrained(
        FIXTURE, dtype=jnp.float32, text_encoder=jenc.ZeroTextEncoder(64, seq_len=32))
    want = np.asarray(jpipe(prompt=captions, latents=jnp.asarray(latents),
                            num_inference_steps=10, guidance_scale=6.0,
                            output_type="np").images)
    pipe = FLitePipeline.from_pretrained(
        FIXTURE, dtype=torch.float32, device="cpu",
        text_encoder=penc.ZeroTextEncoder(64, seq_len=32))
    got = pipe(prompt=captions, latents=latents, num_inference_steps=10,
               guidance_scale=6.0, output_type="np").images
    assert got.shape == want.shape == (2, 64, 64, 3)
    mse = float(((got - want) ** 2).mean())
    assert mse < 1e-6, mse


@pytest.mark.parametrize("kind", ["t5", "qwen2"])
def test_from_pretrained_loads_the_text_encoder_as_jax(text_dirs, kind):
    path = text_dirs[kind]
    jpipe, pipe = _pipelines(path)
    cls = {"t5": penc.T5TextEncoder, "qwen2": pq2.Qwen2TextEncoder}[kind]
    jcls = {"t5": jenc.T5TextEncoder, "qwen2": jq2.Qwen2TextEncoder}[kind]
    assert type(pipe.text_encoder) is cls and type(jpipe.text_encoder) is jcls
    assert pipe.text_encoder.return_index == -2
    assert next(pipe.text_encoder.stack.parameters()).dtype == torch.bfloat16
    embeds, _, mask, _ = pipe.encode_prompt(PROMPTS)
    want, _, want_mask, _ = jpipe.encode_prompt(PROMPTS)
    np.testing.assert_array_equal(mask, want_mask)
    real = want_mask.astype(bool)
    err = float(np.abs(embeds[real] - want[real]).max())
    assert err <= 0.05 * float(np.sqrt(np.mean(want[real].astype(np.float64) ** 2))), err


@pytest.mark.parametrize("kind", ["t5", "qwen2"])
def test_prompt_images_match_jax(text_dirs, kind):
    jpipe, pipe = _pipelines(text_dirs[kind], kind)
    latents = np.random.RandomState(3).randn(4, 8, 8, 4).astype(np.float32)
    kw = dict(prompt=PROMPTS, negative_prompt=NEGATIVES["longer"],
              num_images_per_prompt=2, num_inference_steps=6,
              guidance_scale=4.0, height=16, width=16)
    want = np.stack([np.asarray(im) for im in jpipe(
        **kw, latents=jnp.asarray(latents), output_type="pil").images])
    got = pipe(**kw, latents=latents, output_type="uint8").images
    assert got.dtype == np.uint8 and got.shape == want.shape == (4, 16, 16, 3)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() > 0.99


def test_load_text_encoder_false_leaves_none(text_dirs):
    jpipe, pipe = _pipelines(text_dirs["t5"], load_text_encoder=False)
    assert pipe.text_encoder is None and jpipe.text_encoder is None
    with pytest.raises(ValueError, match="no text encoder"):
        pipe(prompt="a red circle", num_inference_steps=1, height=16, width=16)
    with pytest.raises(ValueError, match="no text encoder"):
        jpipe(prompt="a red circle", num_inference_steps=1, height=16, width=16)
    with pytest.raises(ValueError, match="prompt or prompt_embeds"):
        pipe(num_inference_steps=1, height=16, width=16)


def test_text_encoder_argument_is_used_as_given(text_dirs):
    te = penc.ZeroTextEncoder(WIDTH, seq_len=8)
    pipe = FLitePipeline.from_pretrained(text_dirs["qwen2"], dtype=torch.float32,
                                         device="cpu", text_encoder=te)
    assert pipe.text_encoder is te
    jte = jenc.ZeroTextEncoder(WIDTH, seq_len=8)
    jpipe = JaxPipeline.from_pretrained(text_dirs["qwen2"], dtype=jnp.float32,
                                        text_encoder=jte)
    assert jpipe.text_encoder is jte
    for g, w in zip(pipe.encode_prompt("a red circle", "blue"),
                    jpipe.encode_prompt("a red circle", "blue")):
        np.testing.assert_array_equal(g, w)
