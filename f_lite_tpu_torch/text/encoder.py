"""Text encoders producing (embeddings (B, S, C) float32, mask (B, S) bool)
pairs (counterpart of `f_lite_tpu/text/encoder.py`).

The DiT conditions on hidden layer -8 of a large frozen text encoder.
- `T5TextEncoder`: the released models' T5-XXL path, the port's own stack
  (`text/t5.py`), hidden_states[-8].
- `Qwen2TextEncoder` (`text/qwen2.py`): the HEAD pipeline's Qwen2.5-VL
  language tower, chat-template wrapped.
- `TorchTextEncoder`: any `transformers` AutoModel, chat-template wrapped.
- `PrecomputedTextEncoder`: cached embeddings keyed by the caption's md5.
- `ZeroTextEncoder`: deterministic hermetic encoder for tests and benches.

All pad on the right to a multiple of `pad_to_multiple_of` (8) and truncate
at `max_sequence_length` (512), so masks are prefix masks. Tokenizing runs
on the host (`transformers`, imported only where a tokenizer is loaded from
a path); the stacks take token ids (`encode_ids`) on their device, so the
card can be fed ids without a tokenizer.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Protocol, Sequence

import numpy as np
import torch

from f_lite_tpu_torch.text.t5 import load_t5_encoder
from f_lite_tpu_torch.text.templates import inference_chat_messages
from f_lite_tpu_torch.utils.device import resolve_device


class TextEncoder(Protocol):
    embed_dim: int

    def encode(self, prompts: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        """-> (embeddings (B, S, C) float32, mask (B, S) bool)."""
        ...


def _pad_to_multiple(ids_list, pad_id, multiple, max_len):
    """Token id lists -> (ids (B, S) int32, mask (B, S) bool): truncated at
    max_len, right-padded with pad_id to a multiple of `multiple`."""
    longest = min(max(len(i) for i in ids_list), max_len)
    target = -(-longest // multiple) * multiple
    ids = np.full((len(ids_list), target), pad_id, np.int32)
    mask = np.zeros((len(ids_list), target), bool)
    for r, seq in enumerate(ids_list):
        seq = seq[:max_len]
        ids[r, : len(seq)] = seq
        mask[r, : len(seq)] = True
    return ids, mask


class TokenizedTextEncoder:
    """tokenize on the host -> a stack on its device ->
    hidden_states[return_index], as float32 numpy.

    `stack(input_ids, attention_mask, return_index=...)` is a
    `T5EncoderStack` or `Qwen2Encoder`; `tokenizer` is any object with the
    subset of the HF tokenizer call used here (`padding="longest"`,
    `pad_to_multiple_of`, `max_length`, `truncation`, `return_tensors="np"`,
    returning `input_ids` and `attention_mask`)."""

    def __init__(self, stack, tokenizer, *, return_index: int = -8,
                 max_sequence_length: int = 512, pad_to_multiple_of: int = 8):
        self.stack = stack
        self.tokenizer = tokenizer
        self.return_index = return_index
        self.max_sequence_length = max_sequence_length
        self.pad_to_multiple_of = pad_to_multiple_of
        self.embed_dim = stack.embed_dim

    @classmethod
    def from_stack(cls, stack, tokenizer, **kw):
        """The encoder on a built stack and tokenizer object (`kw`: the
        keyword arguments of `__init__` above)."""
        self = cls.__new__(cls)
        TokenizedTextEncoder.__init__(self, stack, tokenizer, **kw)
        return self

    @property
    def device(self) -> torch.device:
        return next(self.stack.parameters()).device

    def render(self, prompt: str) -> str:
        """The text the tokenizer sees for `prompt`."""
        return prompt

    def tokenize(self, prompts: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        enc = self.tokenizer(
            [self.render(p) for p in prompts],
            padding="longest",
            pad_to_multiple_of=self.pad_to_multiple_of,
            max_length=self.max_sequence_length,
            truncation=True,
            return_tensors="np",
        )
        return np.asarray(enc["input_ids"]), np.asarray(enc["attention_mask"])

    @torch.no_grad()
    def encode_ids(self, input_ids, attention_mask) -> tuple[np.ndarray, np.ndarray]:
        """Token ids (B, S) and their mask -> (embeddings float32, mask
        bool), the stack run on its device."""
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long,
                              device=self.device)
        mask = torch.as_tensor(np.asarray(attention_mask).astype(bool),
                               device=self.device)
        out = self.stack(ids, mask, return_index=self.return_index)
        return out.float().cpu().numpy(), mask.cpu().numpy()

    def encode(self, prompts: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        return self.encode_ids(*self.tokenize(list(prompts)))


class T5TextEncoder(TokenizedTextEncoder):
    """The port's T5 stack on raw captions.

    `T5TextEncoder(model_path, tokenizer_path)` loads the stack from an HF
    folder in `dtype` (bf16, as the JAX package) on `device` and the
    tokenizer (`transformers`); `T5TextEncoder.from_stack(stack, tokenizer)`
    takes built ones."""

    def __init__(self, model_path: str, tokenizer_path: str | None = None, *,
                 return_index: int = -8, max_sequence_length: int = 512,
                 pad_to_multiple_of: int = 8, dtype=torch.bfloat16,
                 device="cuda"):
        stack = load_t5_encoder(model_path, dtype=dtype, device=device)
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(tokenizer_path or model_path)
        super().__init__(stack, tokenizer, return_index=return_index,
                         max_sequence_length=max_sequence_length,
                         pad_to_multiple_of=pad_to_multiple_of)


class TorchTextEncoder:
    """A `transformers` AutoModel (any encoder the port has no stack for),
    prompts wrapped in the processor's chat template when it has one.

    `TorchTextEncoder(model_path, processor_path)` loads both (the model in
    fp32, as the JAX package); `TorchTextEncoder.from_model(model,
    processor)` takes built ones."""

    def __init__(self, model_path: str, processor_path: str | None = None, *,
                 return_index: int = -8, max_sequence_length: int = 512,
                 pad_to_multiple_of: int = 8, use_chat_template: bool = True,
                 message_fn=inference_chat_messages, device="cuda"):
        device = resolve_device(device)
        from transformers import AutoModel, AutoProcessor

        processor = AutoProcessor.from_pretrained(processor_path or model_path)
        model = AutoModel.from_pretrained(model_path, torch_dtype=torch.float32)
        self._setup(model.to(device), processor, return_index,
                    max_sequence_length, pad_to_multiple_of,
                    use_chat_template, message_fn)

    @classmethod
    def from_model(cls, model, processor, *, return_index: int = -8,
                   max_sequence_length: int = 512, pad_to_multiple_of: int = 8,
                   use_chat_template: bool = True,
                   message_fn=inference_chat_messages) -> "TorchTextEncoder":
        self = cls.__new__(cls)
        self._setup(model, processor, return_index, max_sequence_length,
                    pad_to_multiple_of, use_chat_template, message_fn)
        return self

    def _setup(self, model, processor, return_index, max_sequence_length,
               pad_to_multiple_of, use_chat_template, message_fn):
        self.model = model.eval()
        self.processor = processor
        self.return_index = return_index
        self.max_sequence_length = max_sequence_length
        self.pad_to_multiple_of = pad_to_multiple_of
        self.use_chat_template = use_chat_template
        self.message_fn = message_fn
        self.embed_dim = model.config.hidden_size

    def render(self, prompt: str) -> str:
        if self.use_chat_template and hasattr(self.processor, "apply_chat_template"):
            return self.processor.apply_chat_template(
                self.message_fn(prompt), tokenize=False,
                add_generation_prompt=True)
        return prompt

    def tokenize(self, prompts: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        enc = self.processor(
            text=[self.render(p) for p in prompts],
            padding="longest",
            pad_to_multiple_of=self.pad_to_multiple_of,
            max_length=self.max_sequence_length,
            truncation=True,
            return_attention_mask=True,
            return_tensors="np",
        )
        return np.asarray(enc["input_ids"]), np.asarray(enc["attention_mask"])

    @torch.no_grad()
    def encode_ids(self, input_ids, attention_mask) -> tuple[np.ndarray, np.ndarray]:
        device = next(self.model.parameters()).device
        mask = torch.as_tensor(np.asarray(attention_mask), device=device)
        out = self.model(
            input_ids=torch.as_tensor(np.asarray(input_ids), device=device),
            attention_mask=mask, use_cache=False, return_dict=True,
            output_hidden_states=True)
        emb = out.hidden_states[self.return_index].float().cpu().numpy()
        return emb, mask.cpu().numpy().astype(bool)

    def encode(self, prompts: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        return self.encode_ids(*self.tokenize(list(prompts)))


def caption_cache_key(caption: str) -> str:
    """md5 of the caption: the key of the precomputed-embedding cache."""
    return hashlib.md5(caption.encode("utf-8")).hexdigest()


class PrecomputedTextEncoder:
    """Serves embeddings from a precompute cache directory:
      {root}/text_embeddings/embedding_<md5>.npy
      {root}/precomputed_mapping.json
    """

    def __init__(self, root: str | Path, embed_dim: int | None = None):
        self.root = Path(root)
        mapping_file = self.root / "precomputed_mapping.json"
        self.mapping = (json.loads(mapping_file.read_text())
                        if mapping_file.exists() else {})
        self.embed_dim = embed_dim or self._infer_dim()

    def _path(self, prompt: str) -> Path:
        return self.root / "text_embeddings" / f"embedding_{caption_cache_key(prompt)}.npy"

    def _infer_dim(self):
        d = self.root / "text_embeddings"
        for f in sorted(d.glob("embedding_*.npy")):
            return int(np.load(f, mmap_mode="r").shape[-1])
        raise FileNotFoundError(f"no embeddings under {d}")

    def has(self, prompt: str) -> bool:
        """Whether `prompt` is cached (nothing is loaded): a server's check
        before it loads a model."""
        return self._path(prompt).exists()

    def encode(self, prompts):
        embs = []
        for p in prompts:
            f = self._path(p)
            if not f.exists():
                raise KeyError(f"no precomputed embedding for caption {p!r} ({f.name})")
            e = np.load(f).astype(np.float32)
            if e.ndim == 3:
                e = e[0]
            embs.append(e)
        longest = max(e.shape[0] for e in embs)
        target = -(-longest // 8) * 8
        out = np.zeros((len(embs), target, self.embed_dim), np.float32)
        mask = np.zeros((len(embs), target), bool)
        for i, e in enumerate(embs):
            out[i, : e.shape[0]] = e
            mask[i, : e.shape[0]] = True
        return out, mask


# the pseudo context length the trainer's hermetic encoder gives a run
# without a text encoder (`f_lite_tpu/train/trainer.py:280`); the port's
# front-ends attach it at that length, so such a model is served the
# context it was trained on. The JAX front-ends attach 128, which such a
# model never saw; 32 is the repair of that mismatch, not a divergence
PSEUDO_TEXT_LEN = 32


class ZeroTextEncoder:
    """Deterministic hermetic encoder: md5-seeded pseudo-embeddings, bit
    for bit those of the JAX package's `ZeroTextEncoder`."""

    def __init__(self, embed_dim: int = 4096, seq_len: int = 128,
                 random: bool = True):
        self.embed_dim = embed_dim
        self.seq_len = seq_len
        self.random = random

    def encode(self, prompts):
        b = len(prompts)
        out = np.zeros((b, self.seq_len, self.embed_dim), np.float32)
        if self.random:
            for i, p in enumerate(prompts):
                seed = int(hashlib.md5(p.encode()).hexdigest()[:8], 16)
                rs = np.random.RandomState(seed)
                out[i] = rs.randn(self.seq_len, self.embed_dim) * 0.02
        mask = np.ones((b, self.seq_len), bool)
        return out, mask
