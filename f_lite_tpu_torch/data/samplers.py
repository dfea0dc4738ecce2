"""Resumable samplers, for one replica (counterparts of
`f_lite_tpu/data/samplers.py`): the per-item shuffler and the resolution
bucket sampler.

The order of epoch e comes from numpy `RandomState(seed + e)`, the JAX
package's draws. `state_dict(global_step)` writes the JAX samplers' JSON,
key for key, and `load_state_dict` resumes inside the saved epoch:
- `StatefulDistributedSampler` skips `start_index = global_step *
  batch_size % N` items;
- `ResolutionBucketSampler` (whole batches of one latent shape) skips
  `start_batch_index = global_step % batches per epoch` batches.
`reset(0)` drops the offset again for the epochs after the resumed one.
"""

from __future__ import annotations

import numpy as np


class StatefulDistributedSampler:
    """Item indices: a seeded per-epoch permutation (or 0..N-1)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0):
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.start_index = 0
        self.num_samples = len(dataset)

    def __iter__(self):
        if self.shuffle:
            rs = np.random.RandomState(self.seed + self.epoch)
            indices = rs.permutation(self.num_samples)
        else:
            indices = np.arange(self.num_samples)
        return iter(indices[self.start_index:].tolist())

    def __len__(self):
        return max(0, self.num_samples - self.start_index)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def state_dict(self, global_step: int) -> dict:
        return {
            "start_index": (global_step * self.batch_size) % self.num_samples,
            "epoch": self.epoch,
            "seed": self.seed,
            "shuffle": self.shuffle,
        }

    def load_state_dict(self, state: dict):
        self.start_index = state.get("start_index", 0)
        self.epoch = state.get("epoch", 0)
        self.seed = state.get("seed", self.seed)
        self.shuffle = state.get("shuffle", self.shuffle)

    def reset(self, specific_index: int = 0):
        self.start_index = specific_index


class ResolutionBucketSampler:
    """Index batches, each from one bucket (`dataset.aspect_ratio_buckets`:
    {key: [indices]}, made by `setup_aspect_ratio_buckets` when missing):
    each bucket shuffled and cut into batches, then the batch list
    shuffled, with one `RandomState(seed + epoch)`."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0):
        if getattr(dataset, "aspect_ratio_buckets", None) is None:
            dataset.setup_aspect_ratio_buckets()
        self.buckets = dataset.aspect_ratio_buckets
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.start_batch_index = 0

    def __iter__(self):
        rs = np.random.RandomState(self.seed + self.epoch)
        batches = []
        for indices in self.buckets.values():
            idx = np.asarray(indices)
            if self.shuffle:
                idx = idx[rs.permutation(len(idx))]
            for i in range(0, len(idx), self.batch_size):
                b = idx[i: i + self.batch_size]
                if len(b) == self.batch_size or not self.drop_last:
                    batches.append(b.tolist())
        if self.shuffle:
            batches = [batches[i] for i in rs.permutation(len(batches))]
        return iter(batches[self.start_batch_index:])

    def _total_batches(self) -> int:
        """Batches in a whole epoch, whatever the resume offset."""
        bs = self.batch_size
        if self.drop_last:
            return sum(len(v) // bs for v in self.buckets.values())
        return sum(-(-len(v) // bs) for v in self.buckets.values())

    def __len__(self):
        return max(0, self._total_batches() - self.start_batch_index)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def state_dict(self, global_step: int) -> dict:
        # modulo a whole epoch: len(self) shrinks by a restored offset
        n = self._total_batches()
        return {
            "start_batch_index": global_step % n if n else 0,
            "epoch": self.epoch,
            "seed": self.seed,
            "shuffle": self.shuffle,
        }

    def load_state_dict(self, state: dict):
        self.start_batch_index = state.get("start_batch_index", 0)
        self.epoch = state.get("epoch", 0)
        self.seed = state.get("seed", self.seed)
        self.shuffle = state.get("shuffle", self.shuffle)

    def reset(self, specific_batch_index: int = 0):
        self.start_batch_index = specific_batch_index
