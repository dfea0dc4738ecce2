"""Resumable samplers, strided over data replicas (counterparts of
`f_lite_tpu/data/samplers.py`): the per-item shuffler and the resolution
bucket sampler.

The order of epoch e comes from numpy `RandomState(seed + e)`, the JAX
package's draws, the same on every replica; replica `rank` of
`num_replicas` (a node, as a JAX host is one) takes every
`num_replicas`-th item or batch from its own offset. `state_dict(
global_step)` writes the JAX samplers' JSON, key for key, and
`load_state_dict` resumes inside the saved epoch:
- `StatefulDistributedSampler` skips `start_index = global_step *
  batch_size % N` of its own items (`start_index * num_replicas` of the
  permutation);
- `ResolutionBucketSampler` (whole batches of one latent shape) skips
  `start_batch_index = global_step % batches per epoch` of its own
  batches.
`reset(0)` drops the offset again for the epochs after the resumed one.
The trainer passes the batches a replica ran in the epoch as the step, so
the offset counts the replica's own batches (`batches_skipped()` reads
it back).
`len()` is what this replica yields, where JAX's item sampler counts the
unstrided items and its bucket sampler rounds every replica's batches up.
The defaults `(1, 0)` are one replica.
"""

from __future__ import annotations

import numpy as np


class StatefulDistributedSampler:
    """Item indices: a seeded per-epoch permutation (or 0..N-1)."""

    def __init__(self, dataset, batch_size: int, num_replicas: int = 1,
                 rank: int = 0, shuffle: bool = False, seed: int = 0):
        self.batch_size = batch_size
        self.num_replicas = num_replicas
        self.rank = rank
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
        first = self.start_index * self.num_replicas + self.rank
        return iter(indices[first::self.num_replicas].tolist())

    def __len__(self):
        first = self.start_index * self.num_replicas + self.rank
        return len(range(first, self.num_samples, self.num_replicas))

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

    def batches_skipped(self) -> int:
        """This replica's batches that the restored offset skips."""
        return self.start_index // self.batch_size


class ResolutionBucketSampler:
    """Index batches, each from one bucket (`dataset.aspect_ratio_buckets`:
    {key: [indices]}, made by `setup_aspect_ratio_buckets` when missing):
    each bucket shuffled and cut into batches, then the batch list
    shuffled, with one `RandomState(seed + epoch)`."""

    def __init__(self, dataset, batch_size: int, num_replicas: int = 1,
                 rank: int = 0, shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0):
        if getattr(dataset, "aspect_ratio_buckets", None) is None:
            dataset.setup_aspect_ratio_buckets()
        self.buckets = dataset.aspect_ratio_buckets
        self.batch_size = batch_size
        self.num_replicas = num_replicas
        self.rank = rank
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
        return iter(batches[self.rank::self.num_replicas][self.start_batch_index:])

    def _all_batches(self) -> int:
        """Batches of all replicas in a whole epoch."""
        bs = self.batch_size
        if self.drop_last:
            return sum(len(v) // bs for v in self.buckets.values())
        return sum(-(-len(v) // bs) for v in self.buckets.values())

    def _total_batches(self) -> int:
        """A replica's batches in a whole epoch, rounded up (JAX's count),
        whatever the resume offset."""
        return -(-self._all_batches() // self.num_replicas)

    def __len__(self):
        own = len(range(self.rank, self._all_batches(), self.num_replicas))
        return max(0, own - self.start_batch_index)

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

    def batches_skipped(self) -> int:
        """This replica's batches that the restored offset skips."""
        return self.start_batch_index
