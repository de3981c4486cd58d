"""Deterministic synthetic image stream, port of
revisiting_at_tpu/data/synthetic.py: the same numpy draw, so both packages
see the same images and labels for a seed."""

from __future__ import annotations

import numpy as np


class SyntheticData:
    """`n_batches` batches of (images NHWC float32 [0, 1], int labels)."""

    def __init__(self, batch_size: int, resolution: int = 224, num_classes: int = 1000,
                 seed: int = 0, n_batches: int = 64):
        rng = np.random.RandomState(seed)
        self.images = rng.uniform(
            0, 1, size=(n_batches, batch_size, resolution, resolution, 3)
        ).astype(np.float32)
        self.labels = rng.randint(0, num_classes, size=(n_batches, batch_size)).astype(
            np.int32
        )
        self.n_batches = n_batches

    def __len__(self):
        return self.n_batches

    def __iter__(self):
        for i in range(self.n_batches):
            yield self.images[i], self.labels[i]
