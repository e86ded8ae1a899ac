"""Data-module base: the host loads raw bytes, the device does the math
(mirrors ``dmme_tpu/data/data_module.py``).

The host only shuffles indices and slices uint8 numpy arrays; augmentation
(:meth:`DataModule.augment`) and normalisation (:meth:`DataModule.process`)
are tensor functions that run on the batch's device inside the train step.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from dmme_tpu_torch.utils.norm import norm


class DataModule:
    """Base class; subclasses fill ``self.train_data`` / ``self.test_data``
    with uint8 NHWC numpy arrays in :meth:`setup_train` / :meth:`setup_test`."""

    #: image side length, known without loading the dataset
    img_size: Optional[int] = None

    def __init__(self, batch_size: int = 128):
        self.batch_size = batch_size
        self.train_data: Optional[np.ndarray] = None
        self.test_data: Optional[np.ndarray] = None
        # optional labels; when set, the iterators yield (images, labels)
        self.train_labels: Optional[np.ndarray] = None
        self.test_labels: Optional[np.ndarray] = None

    def prepare_data(self) -> None:
        """One-time host-side preparation. No-op: datasets must be on disk."""

    def setup(self, stage: str) -> None:
        if stage in ("fit", "train"):
            self.setup_train()
        elif stage == "test":
            self.setup_test()
        else:
            raise ValueError(f"unknown stage: {stage}")

    def setup_train(self) -> None:
        raise NotImplementedError

    def setup_test(self) -> None:
        raise NotImplementedError

    def train_iter(self, seed: int = 0) -> Iterator[np.ndarray]:
        """Infinite shuffled uint8 batches: a fresh ``default_rng(seed)``
        permutation per epoch, the ragged tail dropped (the JAX package's
        stream for one process)."""
        if self.train_data is None:
            raise RuntimeError("call setup('fit') first")
        data, labels = self.train_data, self.train_labels
        n = data.shape[0]
        rng = np.random.default_rng(seed)
        while True:
            perm = rng.permutation(n)
            for i in range(0, n - self.batch_size + 1, self.batch_size):
                idx = perm[i : i + self.batch_size]
                yield data[idx] if labels is None else (data[idx], labels[idx])

    def test_iter(self) -> Iterator[np.ndarray]:
        """One sequential pass over the test split (no shuffle, no augmentation)."""
        if self.test_data is None:
            raise RuntimeError("call setup('test') first")
        data, labels = self.test_data, self.test_labels
        for i in range(0, data.shape[0] - self.batch_size + 1, self.batch_size):
            sl = slice(i, i + self.batch_size)
            yield data[sl] if labels is None else (data[sl], labels[sl])

    def process(self, batch: torch.Tensor) -> torch.Tensor:
        """uint8 [0, 255] → float32 [−1, 1]."""
        return norm(batch.to(torch.float32) / 255.0)

    def augment(self, generator: torch.Generator, batch: torch.Tensor) -> torch.Tensor:
        """Train-time augmentation on the batch's device. Default: identity."""
        return batch

    def train_transform(self, generator: torch.Generator, batch: torch.Tensor) -> torch.Tensor:
        return self.process(self.augment(generator, batch))


def random_horizontal_flip(generator: torch.Generator, batch: torch.Tensor,
                           p: float = 0.5) -> torch.Tensor:
    """Flip each NHWC sample along W with probability ``p``, drawn from
    ``generator`` (on the batch's device)."""
    flip = torch.rand((batch.shape[0],) + (1,) * (batch.dim() - 1), generator=generator,
                      device=batch.device) < p
    return torch.where(flip, batch.flip(2), batch)
