"""The port's text encoders (`f_lite_tpu_torch/text/`) against the JAX
package's on the CPU, fp32 unless a test says otherwise.

- Relative-position buckets equal JAX's exactly.
- The T5 stack (relu, gelu, gated-gelu; num_heads * d_kv != d_model; right
  padding) and the Qwen2 tower (GQA 4/2 heads, padding) equal
  `T5EncoderStack` / `Qwen2Encoder` on the same weights within
  1e-5 * max|ref| at return_index -1, -2, -8 and 0.
- Both towers load from HF folders that `transformers` writes (safetensors,
  index-sharded, `pytorch_model.bin` beside a decoy `training_args.bin`; a
  VL checkpoint's prefixed keys) into the weights that
  `*_state_dict_from_jax` gives for the JAX package's conversion.
- The text encoders against the JAX classes on one folder and one
  `tokenizers` WordLevel tokenizer: masks equal, embeddings within
  1e-5 * max in fp32 and within 5% of the rms in bf16.
- `PrecomputedTextEncoder`, `_pad_to_multiple` and the templates equal
  the JAX ones bit for bit.
- `tools/text_precision.py`'s "jax" recipe is the stacks' computation
  (equal to them with fp32 weights, where nothing is rounded).
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f_lite_tpu.text import encoder as jenc
from f_lite_tpu.text import qwen2 as jq2
from f_lite_tpu.text import t5 as jt5
from f_lite_tpu.text import templates as jtpl
from f_lite_tpu_torch.convert.from_jax import (
    qwen2_state_dict_from_jax,
    t5_state_dict_from_jax,
)
from f_lite_tpu_torch.convert.hf_weights import weight_files
from f_lite_tpu_torch.text import encoder as penc
from f_lite_tpu_torch.text import qwen2 as pq2
from f_lite_tpu_torch.text import t5 as pt5
from f_lite_tpu_torch.text import templates as ptpl
from f_lite_tpu_torch.utils.safetensors import save_file

# num_heads * d_kv = 64 != d_model = 48; depth 8 so that index -8 is block 0
T5_TINY = dict(vocab_size=100, d_model=48, d_kv=16, d_ff=96, num_layers=8,
               num_heads=4, relative_attention_num_buckets=8,
               relative_attention_max_distance=20)
QWEN_TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                 num_hidden_layers=8, num_attention_heads=4,
                 num_key_value_heads=2, rope_theta=1e6, rms_norm_eps=1e-6)
RETURN_INDICES = [-1, -2, -8, 0]
WORDS = ["a", "red", "green", "blue", "circle", "square", "triangle", "big",
         "small", "on", "the", "left", "right", "of", "photo"]
CHAT_TEMPLATE = (
    "{% for m in messages %}{{ m['role'] }}: "
    "{% if m['content'] is string %}{{ m['content'] }}"
    "{% else %}{% for c in m['content'] %}{{ c['text'] }}{% endfor %}{% endif %}"
    "\n{% endfor %}{% if add_generation_prompt %}assistant:{% endif %}")


def _max_err_bar(got, want, rel=1e-5):
    err = float(np.abs(got - want).max())
    bar = rel * float(np.abs(want).max())
    assert err <= bar, (err, bar)


def _rms_bar(got, want, mask, fraction=0.05):
    """bf16 bar: the largest abs error on the real rows within `fraction`
    of the reference's rms there."""
    g, w = got[mask], want[mask]
    err = float(np.abs(g - w).max())
    bar = fraction * float(np.sqrt(np.mean(w.astype(np.float64) ** 2)))
    assert err <= bar, (err, bar)


def _numpy_params(tree, seed):
    """The JAX tree's leaves replaced by seeded numpy draws: kernels
    N(0, 1/fan_in), norm weights 1 + N(0, 0.1^2), biases N(0, 0.1^2),
    embeddings and the position-bias table N(0, 1)."""
    rs = np.random.RandomState(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        shape = x.shape
        if name.endswith("['kernel']"):
            return (rs.randn(*shape) / np.sqrt(shape[0])).astype(np.float32)
        if len(shape) == 2:
            return rs.randn(*shape).astype(np.float32)
        if name.endswith("['bias']"):
            return (0.1 * rs.randn(*shape)).astype(np.float32)
        return (1.0 + 0.1 * rs.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _ids_and_mask(vocab, lens, s, seed):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (len(lens), s))
    mask = np.arange(s)[None, :] < np.asarray(lens)[:, None]
    return ids, mask


# --------------------------------------------------------------------------
# stacks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nb,md", [(32, 128), (8, 20)])
def test_relative_position_buckets_equal_jax(nb, md):
    rel = np.arange(-600, 601, dtype=np.int32)
    want = np.asarray(jt5._relative_position_bucket(jnp.asarray(rel), nb, md))
    got = pt5.relative_position_bucket(torch.from_numpy(rel), nb, md).numpy()
    np.testing.assert_array_equal(got, want)


def _t5_pair(ff, seed=0):
    cfg = jt5.T5Config(**T5_TINY, feed_forward_proj=ff)
    ids = jnp.zeros((1, 4), jnp.int32)
    params = _numpy_params(jt5.T5EncoderStack(cfg).init(jax.random.key(0), ids), seed)
    pcfg = pt5.T5Config(**T5_TINY, feed_forward_proj=ff)
    stack = pt5.T5EncoderStack(pcfg)
    stack.load_state_dict(t5_state_dict_from_jax(params, pcfg))
    return cfg, params, stack.eval()


@pytest.mark.parametrize("return_index", RETURN_INDICES)
@pytest.mark.parametrize("ff", ["relu", "gelu", "gated-gelu"])
def test_t5_stack_matches_jax(ff, return_index):
    cfg, params, stack = _t5_pair(ff)
    ids, mask = _ids_and_mask(T5_TINY["vocab_size"], [12, 7], 12, seed=1)
    want = np.asarray(jt5.T5EncoderStack(cfg, return_index=return_index).apply(
        params, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = stack(torch.from_numpy(ids), torch.from_numpy(mask),
                    return_index=return_index).numpy()
    assert got.shape == want.shape == (2, 12, 48)
    _max_err_bar(got, want)


def _qwen_pair(seed=0):
    cfg = jq2.Qwen2Config(**QWEN_TINY)
    ids = jnp.zeros((1, 4), jnp.int32)
    params = _numpy_params(jq2.Qwen2Encoder(cfg).init(jax.random.key(0), ids), seed)
    pcfg = pq2.Qwen2Config(**QWEN_TINY)
    stack = pq2.Qwen2Encoder(pcfg)
    stack.load_state_dict(qwen2_state_dict_from_jax(params, pcfg))
    return cfg, params, stack.eval()


@pytest.mark.parametrize("return_index", RETURN_INDICES)
def test_qwen2_tower_matches_jax(return_index):
    cfg, params, stack = _qwen_pair()
    ids, mask = _ids_and_mask(QWEN_TINY["vocab_size"], [14, 9], 14, seed=2)
    want = np.asarray(jq2.Qwen2Encoder(cfg, return_index=return_index).apply(
        params, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = stack(torch.from_numpy(ids), torch.from_numpy(mask),
                    return_index=return_index).numpy()
    assert got.shape == want.shape == (2, 14, 64)
    _max_err_bar(got, want)


def test_return_index_outside_the_states_raises():
    _, _, stack = _qwen_pair()
    ids = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(IndexError):
        stack(ids, return_index=9)
    with pytest.raises(IndexError):
        stack(ids, return_index=-10)


# --------------------------------------------------------------------------
# HF folders
# --------------------------------------------------------------------------

def _hf_t5(seed=0):
    from transformers import T5Config, T5EncoderModel

    torch.manual_seed(seed)
    cfg = T5Config(vocab_size=100, d_model=48, d_kv=16, d_ff=96, num_layers=3,
                   num_heads=4, relative_attention_num_buckets=8,
                   relative_attention_max_distance=20,
                   feed_forward_proj="gated-gelu", dropout_rate=0.0)
    return T5EncoderModel(cfg).eval()


def _hf_qwen2(seed=0):
    from transformers import Qwen2Config, Qwen2ForCausalLM

    torch.manual_seed(seed)
    cfg = Qwen2Config(**QWEN_TINY, max_position_embeddings=256,
                      tie_word_embeddings=False)
    model = Qwen2ForCausalLM(cfg).eval()
    with torch.no_grad():  # HF zero-inits biases
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.1)
    return model


class _Decoy:
    """A pickled object that `torch.load(weights_only=True)` refuses."""


def _save(model, path, layout):
    if layout == "safetensors":
        model.save_pretrained(path, safe_serialization=True)
    elif layout == "sharded":
        model.save_pretrained(path, safe_serialization=True, max_shard_size="40KB")
    else:
        model.save_pretrained(path, safe_serialization=False)
        torch.save({"args": _Decoy()}, path / "training_args.bin")
    return path


def _numpy_sd(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


LAYOUTS = ["safetensors", "sharded", "bin"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_t5_loads_hf_folder(tmp_path, layout):
    model = _hf_t5()
    path = _save(model, tmp_path, layout)
    files = weight_files(path)
    assert len(files) > 1 if layout == "sharded" else len(files) == 1
    assert all(f.name != "training_args.bin" for f in files)
    stack = pt5.load_t5_encoder(path, dtype=torch.float32, device="cpu")
    cfg = pt5.T5Config.from_hf(json.loads((path / "config.json").read_text()))
    want = t5_state_dict_from_jax(jt5.convert_t5_state_dict(
        _numpy_sd(model), jt5.T5Config.from_hf(model.config.to_dict())), cfg)
    got = stack.state_dict()
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_qwen2_loads_hf_folder(tmp_path, layout):
    model = _hf_qwen2()
    path = _save(model, tmp_path, layout)
    stack = pq2.load_qwen2_encoder(path, dtype=torch.float32, device="cpu")
    cfg = pq2.Qwen2Config.from_hf(json.loads((path / "config.json").read_text()))
    want = qwen2_state_dict_from_jax(jq2.convert_qwen2_state_dict(
        _numpy_sd(model), jq2.Qwen2Config(**QWEN_TINY)), cfg)
    got = stack.state_dict()
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0)


def test_qwen2_loads_vl_language_tower_keys(tmp_path):
    """A Qwen2.5-VL checkpoint's keys (`model.language_model.`, with
    `visual` and `lm_head` beside the tower, config under `text_config`)
    load, and the tower matches the JAX package's on the same file."""
    _, params, stack = _qwen_pair(seed=3)
    sd = {f"model.language_model.{k}": v.numpy() for k, v in stack.state_dict().items()}
    sd["lm_head.weight"] = np.zeros((128, 64), np.float32)
    sd["model.visual.patch_embed.proj.weight"] = np.zeros((8, 3), np.float32)
    save_file(sd, tmp_path / "model.safetensors")
    (tmp_path / "config.json").write_text(json.dumps({"text_config": QWEN_TINY}))
    loaded = pq2.load_qwen2_encoder(tmp_path, dtype=torch.float32, device="cpu")
    cfg = jq2.Qwen2Config.from_hf(json.loads((tmp_path / "config.json").read_text()))
    jparams = jq2.convert_qwen2_state_dict(sd, cfg)
    ids, mask = _ids_and_mask(128, [10, 6], 10, seed=4)
    want = np.asarray(jq2.Qwen2Encoder(cfg, return_index=-2).apply(
        jparams, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = loaded(torch.from_numpy(ids), torch.from_numpy(mask),
                     return_index=-2).numpy()
    _max_err_bar(got, want)


def test_loader_is_strict(tmp_path):
    """A parameter with no weight, or a tower key the module lacks, raises."""
    model = _hf_t5()
    sd = {k: v.numpy().astype(np.float32) for k, v in model.state_dict().items()}
    model.config.to_json_file(tmp_path / "config.json")
    save_file({k: v for k, v in sd.items()
               if not k.endswith("block.1.layer.1.DenseReluDense.wo.weight")},
              tmp_path / "model.safetensors")
    with pytest.raises(KeyError, match="no weights for 1 parameters"):
        pt5.load_t5_encoder(tmp_path, dtype=torch.float32, device="cpu")
    save_file({**sd, "encoder.block.9.layer.0.layer_norm.weight": np.ones(48, np.float32)},
              tmp_path / "model.safetensors")
    with pytest.raises(KeyError, match="block.9"):
        pt5.load_t5_encoder(tmp_path, dtype=torch.float32, device="cpu")


def test_bf16_weights_load_without_widening(tmp_path):
    """A BF16 checkpoint's values reach a bf16 stack unchanged."""
    model = _hf_t5().to(torch.bfloat16)
    model.save_pretrained(tmp_path, safe_serialization=True)
    stack = pt5.load_t5_encoder(tmp_path, dtype=torch.bfloat16, device="cpu")
    got = stack.state_dict()
    for k, v in model.state_dict().items():
        if k != "encoder.embed_tokens.weight":
            torch.testing.assert_close(got[k], v, atol=0, rtol=0)


# --------------------------------------------------------------------------
# text encoders
# --------------------------------------------------------------------------

def _word_tokenizer(path, chat_template=None):
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {w: i for i, w in enumerate(WORDS)}
    vocab["[UNK]"] = len(vocab)
    vocab["[PAD]"] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="[UNK]",
                                   pad_token="[PAD]")
    if chat_template:
        fast.chat_template = chat_template
    fast.save_pretrained(path)
    return fast


@pytest.fixture(scope="module")
def t5_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("t5")
    _hf_t5(seed=5).save_pretrained(path, safe_serialization=True)
    _word_tokenizer(path)
    return path


@pytest.fixture(scope="module")
def qwen2_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("qwen2")
    _hf_qwen2(seed=6).save_pretrained(path, safe_serialization=True)
    _word_tokenizer(path, CHAT_TEMPLATE)
    return path


PROMPTS = ["a red circle on the left", "blue square", "a big green triangle "
           "on the right of a small red square photo"]


def _encoder_pair(kind, path, dtype):
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    if kind == "t5":
        return (jenc.T5TextEncoder(str(path), return_index=-2, dtype=jdtype),
                penc.T5TextEncoder(str(path), return_index=-2, dtype=dtype,
                                   device="cpu"))
    if kind == "qwen2":
        return (jq2.Qwen2TextEncoder(str(path), return_index=-2, dtype=jdtype),
                pq2.Qwen2TextEncoder(str(path), return_index=-2, dtype=dtype,
                                     device="cpu"))
    return (jenc.TorchTextEncoder(str(path), return_index=-2),
            penc.TorchTextEncoder(str(path), return_index=-2, device="cpu"))


@pytest.mark.parametrize("kind", ["t5", "qwen2", "torch"])
def test_text_encoder_matches_jax(kind, t5_dir, qwen2_dir):
    path = t5_dir if kind == "t5" else qwen2_dir
    jte, pte = _encoder_pair(kind, path, torch.float32)
    want_emb, want_mask = jte.encode(PROMPTS)
    got_emb, got_mask = pte.encode(PROMPTS)
    assert pte.embed_dim == jte.embed_dim
    assert got_emb.dtype == np.float32 and got_mask.dtype == bool
    np.testing.assert_array_equal(got_mask, want_mask)
    assert got_emb.shape == want_emb.shape and got_emb.shape[1] % 8 == 0
    _max_err_bar(got_emb, want_emb)


@pytest.mark.parametrize("kind", ["t5", "qwen2"])
def test_text_encoder_bf16_matches_jax(kind, t5_dir, qwen2_dir):
    path = t5_dir if kind == "t5" else qwen2_dir
    jte, pte = _encoder_pair(kind, path, torch.bfloat16)
    want_emb, want_mask = jte.encode(PROMPTS)
    got_emb, got_mask = pte.encode(PROMPTS)
    assert next(pte.stack.parameters()).dtype == torch.bfloat16
    np.testing.assert_array_equal(got_mask, want_mask)
    _rms_bar(got_emb, want_emb, want_mask)


def test_qwen2_encoder_renders_the_chat_template(qwen2_dir):
    """With a chat template the tokenizer sees the inference messages; the
    ids the port feeds its tower equal the JAX encoder's."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(qwen2_dir)
    _, _, stack = _qwen_pair()
    te = pq2.Qwen2TextEncoder.from_stack(stack, tok, return_index=-2)
    text = te.render("a red circle")
    assert text == tok.apply_chat_template(
        jtpl.inference_chat_messages("a red circle"), tokenize=False,
        add_generation_prompt=True)
    assert jtpl.INFERENCE_SYSTEM_PROMPT in text
    ids, mask = te.tokenize(["a red circle"])
    want = tok([text], padding="longest", pad_to_multiple_of=8,
               max_length=512, truncation=True, return_tensors="np")
    np.testing.assert_array_equal(ids, want["input_ids"])
    np.testing.assert_array_equal(mask, want["attention_mask"])


def test_precomputed_encoder_equals_jax(tmp_path):
    from f_lite_tpu.data.precomputed import PrecomputedCacheWriter

    rs = np.random.RandomState(7)
    w = PrecomputedCacheWriter(tmp_path)
    captions = ["a red cat", "a blue dog", "an orange fish"]
    for i, (c, n) in enumerate(zip(captions, (5, 11, 8))):
        w.add(f"id{i}", c, rs.randn(8, 8, 4).astype(np.float32),
              rs.randn(n, 16).astype(np.float32))
    w.finalize()
    jte = jenc.PrecomputedTextEncoder(tmp_path)
    pte = penc.PrecomputedTextEncoder(tmp_path)
    assert pte.embed_dim == jte.embed_dim == 16
    assert pte.mapping == jte.mapping
    for c in (*captions, "unknown"):
        assert pte.has(c) == jte.has(c)
    for got, want in zip(pte.encode(captions), jte.encode(captions)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(KeyError):
        pte.encode(["unknown"])


def test_templates_and_padding_equal_jax():
    for name in ("INFERENCE_SYSTEM_PROMPT", "TRAIN_SYSTEM_PROMPT_REAL",
                 "TRAIN_SYSTEM_PROMPT_NONREAL"):
        assert getattr(ptpl, name) == getattr(jtpl, name)
    for caption in ("a red circle", ""):
        assert ptpl.inference_chat_messages(caption) == jtpl.inference_chat_messages(caption)
        for meta in (None, {"media_type": "real"}, {"media_type": "anime"}):
            assert (ptpl.training_chat_messages(caption, meta)
                    == jtpl.training_chat_messages(caption, meta))
    ids_list = [[3, 4, 5], list(range(1, 20)), [7]]
    for multiple, max_len in ((8, 512), (8, 10), (4, 3)):
        got = penc._pad_to_multiple(ids_list, 0, multiple, max_len)
        want = jenc._pad_to_multiple(ids_list, 0, multiple, max_len)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["t5", "qwen2"])
def test_precision_tool_jax_recipe_computes_the_stack(kind):
    """`tools/text_precision.py`'s "jax" recipe (every activation in the
    weights' dtype) is the stack's own computation: with fp32 weights,
    where nothing is rounded, it equals the stack within 1e-5 * max, at
    the final norm's index and before it."""
    from f_lite_tpu_torch.tools import text_precision

    _, _, stack = _t5_pair("gated-gelu") if kind == "t5" else _qwen_pair()
    vocab = T5_TINY["vocab_size"] if kind == "t5" else QWEN_TINY["vocab_size"]
    ids, mask = (torch.from_numpy(a) for a in _ids_and_mask(vocab, [12, 7], 12, seed=5))
    for return_index in (-1, -2):
        got = text_precision.jax_recipe(stack, ids, mask, return_index).numpy()
        with torch.no_grad():
            want = stack(ids, mask, return_index=return_index).numpy()
        _max_err_bar(got, want)
    errs = text_precision.errors(torch.from_numpy(got) + 1.0, torch.from_numpy(want),
                                 mask)
    assert errs["rms_err_over_rms"] > 0 and errs["err_over_tol"] > 0
