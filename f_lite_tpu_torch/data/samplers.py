"""Per-epoch shuffling sampler (counterpart of `StatefulDistributedSampler`
in `f_lite_tpu/data/samplers.py`, for one replica; its resume state and the
bucketed sampler are not ported yet).

The order of epoch e is numpy `RandomState(seed + e).permutation(N)`, the
JAX package's order.
"""

from __future__ import annotations

import numpy as np


class StatefulDistributedSampler:
    def __init__(self, dataset, shuffle: bool = False, seed: int = 0):
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.num_samples = len(dataset)

    def __iter__(self):
        if self.shuffle:
            rs = np.random.RandomState(self.seed + self.epoch)
            return iter(rs.permutation(self.num_samples).tolist())
        return iter(range(self.num_samples))

    def __len__(self):
        return self.num_samples

    def set_epoch(self, epoch: int):
        self.epoch = epoch
