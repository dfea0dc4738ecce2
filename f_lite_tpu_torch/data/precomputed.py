"""Precomputed-data training path: cache layout, dataset, loader
(counterpart of `f_lite_tpu/data/precomputed.py`).

A cache directory holds `vae_latents/latent_<md5>.npy` (normalized latents,
or pixels for pixel-space runs, NHWC), `text_embeddings/embedding_<md5>.npy`
(one per distinct caption) and `precomputed_mapping.json` listing the
entries; numpy reads all of it. The loader runs in-process (no worker pool,
no resolution buckets yet) and yields collated numpy batches.
"""

from __future__ import annotations

import json
import random
from pathlib import Path

import numpy as np

from f_lite_tpu_torch.data.samplers import StatefulDistributedSampler
from f_lite_tpu_torch.text.encoder import caption_cache_key


class PrecomputedCacheWriter:
    """Writes the cache: one latent per item, one embedding per caption."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        (self.root / "vae_latents").mkdir(parents=True, exist_ok=True)
        (self.root / "text_embeddings").mkdir(parents=True, exist_ok=True)
        self.entries: list[dict] = []
        self._caption_seen: set[str] = set()

    def add(self, item_id: str, caption: str, latent: np.ndarray,
            embedding: np.ndarray | None):
        key = caption_cache_key(caption)
        lat_name = f"latent_{caption_cache_key(item_id + caption)}.npy"
        np.save(self.root / "vae_latents" / lat_name, latent)
        if embedding is not None and key not in self._caption_seen:
            np.save(self.root / "text_embeddings" / f"embedding_{key}.npy",
                    embedding)
            self._caption_seen.add(key)
        self.entries.append({
            "id": item_id,
            "caption": caption,
            "latent_file": lat_name,
            "embedding_file": f"embedding_{key}.npy",
            "latent_shape": list(latent.shape),
        })

    def finalize(self):
        (self.root / "precomputed_mapping.json").write_text(
            json.dumps({"entries": self.entries}, indent=2))


class PrecomputedDataset:
    """Latent / embedding pairs, with an optional latent h-flip."""

    def __init__(self, root: str | Path, *, latent_flip: bool = False):
        self.root = Path(root)
        mapping = json.loads((self.root / "precomputed_mapping.json").read_text())
        self.entries = mapping["entries"]
        self.latent_flip = latent_flip

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, idx: int) -> dict:
        e = self.entries[idx]
        latent = np.load(self.root / "vae_latents" / e["latent_file"])
        emb = np.load(self.root / "text_embeddings" / e["embedding_file"])
        if emb.ndim == 3:
            emb = emb[0]
        if self.latent_flip and random.random() < 0.5:
            latent = latent[:, ::-1, :].copy()  # h-flip on W axis (NHWC)
        return {
            "vae_latent": latent.astype(np.float32),
            "text_embedding": emb.astype(np.float32),
            "caption": e["caption"],
            "_id": e["id"],
        }

    def collate_fn(self, items: list[dict]) -> dict:
        """Pad the embeddings to the batch's longest, rounded up to a
        multiple of 8, with masks (True = real token)."""
        max_s = max(it["text_embedding"].shape[0] for it in items)
        max_s = -(-max_s // 8) * 8
        embs, masks = [], []
        for it in items:
            e = it["text_embedding"]
            pad = max_s - e.shape[0]
            masks.append(np.concatenate([np.ones(e.shape[0], bool),
                                         np.zeros(pad, bool)]))
            embs.append(np.pad(e, ((0, pad), (0, 0))))
        return {
            "text_embedding": np.stack(embs),
            "text_mask": np.stack(masks),
            "vae_latent": np.stack([it["vae_latent"] for it in items]),
            "caption": [it["caption"] for it in items],
            "_id": [it["_id"] for it in items],
        }


class PrecomputedLoader:
    """Batches of `batch_size` items in the sampler's order, collated;
    an incomplete last batch is dropped."""

    def __init__(self, dataset: PrecomputedDataset, batch_size: int, sampler):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler

    def __len__(self):
        return len(self.sampler) // self.batch_size

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(self.dataset[idx])
            if len(batch) == self.batch_size:
                yield self.dataset.collate_fn(batch)
                batch = []


def create_precomputed_data_loader(root, batch_size, *, shuffle=True, seed=0,
                                   latent_flip=False):
    """(loader, sampler) over the cache at `root`."""
    ds = PrecomputedDataset(root, latent_flip=latent_flip)
    sampler = StatefulDistributedSampler(ds, shuffle=shuffle, seed=seed)
    return PrecomputedLoader(ds, batch_size, sampler), sampler
