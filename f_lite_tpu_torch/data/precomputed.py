"""Precomputed-data training path: cache layout, dataset, loader
(counterpart of `f_lite_tpu/data/precomputed.py`).

A cache directory holds `vae_latents/latent_<md5>.npy` (normalized latents,
or pixels for pixel-space runs, NHWC), `text_embeddings/embedding_<md5>.npy`
(one per distinct caption) and `precomputed_mapping.json` listing the
entries; numpy reads all of it. The loader runs in-process (no worker pool)
and yields collated numpy batches: fixed batches in the item sampler's
order, or, with `use_buckets`, the resolution bucket sampler's batches of
one latent shape each (`setup_latent_buckets`).
"""

from __future__ import annotations

import json
import random
from pathlib import Path

import numpy as np

from f_lite_tpu_torch.data.samplers import (
    ResolutionBucketSampler,
    StatefulDistributedSampler,
)
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

    def latent_shape(self, idx: int) -> tuple:
        """The entry's latent shape, from the mapping (or, for a cache
        written without it, the file's header)."""
        e = self.entries[idx]
        if "latent_shape" in e:
            return tuple(e["latent_shape"])
        return np.load(self.root / "vae_latents" / e["latent_file"],
                       mmap_mode="r").shape

    def setup_latent_buckets(self) -> dict:
        """{latent shape: [indices]} in first-seen order, as the bucket
        sampler's `aspect_ratio_buckets`."""
        buckets: dict[tuple, list[int]] = {}
        for i in range(len(self)):
            buckets.setdefault(self.latent_shape(i), []).append(i)
        self.aspect_ratio_buckets = buckets
        return buckets

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
    """Collated batches: of `batch_size` items in the sampler's order (an
    incomplete last batch dropped), or, without a batch size, the index
    lists the sampler yields (a batch sampler)."""

    def __init__(self, dataset: PrecomputedDataset, batch_size: int | None,
                 sampler):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler

    def __len__(self):
        if self.batch_size is None:
            return len(self.sampler)
        return len(self.sampler) // self.batch_size

    def __iter__(self):
        if self.batch_size is None:
            for indices in self.sampler:
                yield self.dataset.collate_fn([self.dataset[i] for i in indices])
            return
        batch = []
        for idx in self.sampler:
            batch.append(self.dataset[idx])
            if len(batch) == self.batch_size:
                yield self.dataset.collate_fn(batch)
                batch = []


def create_precomputed_data_loader(root, batch_size, *, shuffle=True, seed=0,
                                   use_buckets=False, latent_flip=False,
                                   sampler_state=None, num_replicas=1, rank=0):
    """(loader, sampler) over the cache at `root`; `use_buckets` batches
    within latent-shape buckets; `sampler_state` (a sampler's
    `state_dict`) resumes inside the saved epoch; replica `rank` of
    `num_replicas` (a node) takes its stride of the items or batches."""
    ds = PrecomputedDataset(root, latent_flip=latent_flip)
    if use_buckets:
        ds.setup_latent_buckets()
        sampler = ResolutionBucketSampler(ds, batch_size, num_replicas=num_replicas,
                                          rank=rank, shuffle=shuffle, seed=seed)
        loader = PrecomputedLoader(ds, None, sampler)
    else:
        sampler = StatefulDistributedSampler(ds, batch_size,
                                             num_replicas=num_replicas, rank=rank,
                                             shuffle=shuffle, seed=seed)
        loader = PrecomputedLoader(ds, batch_size, sampler)
    if sampler_state:
        sampler.load_state_dict(sampler_state)
    return loader, sampler
