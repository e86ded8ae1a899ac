"""ImageNet-64 (downsampled-ImageNet) data module (mirrors ``dmme_tpu/data/imagefolder.py``).

Reads the downsampled-ImageNet archives (``train_data_batch_{1..10}.npz`` or
``.npy``, with ``data`` rows of 3·64·64 channel-planar uint8 and 1-based
``labels``, as image-net.org distributes them) from local disk; nothing is
downloaded. ``synthetic=True`` makes a deterministic uint8 dataset of the
right shape from ``numpy.random.default_rng(0)``, the same bytes as the JAX
package's. Archives load with ``allow_pickle=False``: the real ones hold
plain arrays, and no object array from outside is unpickled. Used by
configs/iddpm/imagenet64.yaml.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from dmme_tpu_torch.data.data_module import DataModule, random_horizontal_flip


def _read_archive(path: str):
    """(images NHWC uint8, labels 0-based int32) of one archive: an ``.npz``
    with ``data`` (and ``labels``), or an ``.npy`` of rows (labels 0)."""
    d = np.load(path, allow_pickle=False)
    if isinstance(d, np.ndarray):
        data, labels = d, np.zeros(len(d), np.int32)
    else:
        with d:
            data = d["data"]
            labels = (np.asarray(d["labels"], np.int32) - 1 if "labels" in d
                      else np.zeros(len(data), np.int32))
    return np.asarray(data, np.uint8).reshape(-1, 3, 64, 64).transpose(0, 2, 3, 1), labels


class ImageFolder64(DataModule):
    img_size = 64

    def __init__(self, data_dir: str = ".", batch_size: int = 128, horizontal_flip: bool = True,
                 synthetic: bool = False, synthetic_size: int = 10_000,
                 with_labels: bool = False):
        super().__init__(batch_size)
        self.data_dir = data_dir
        self.horizontal_flip = horizontal_flip
        self.synthetic = synthetic
        self.synthetic_size = synthetic_size
        self.with_labels = with_labels

    def _load(self):
        if self.synthetic:
            rng = np.random.default_rng(0)
            images = rng.integers(0, 256, (self.synthetic_size, 64, 64, 3), np.uint8)
            labels = rng.integers(0, 1000, (self.synthetic_size,), np.int32)
            return images, labels

        paths = sorted(glob.glob(os.path.join(self.data_dir, "train_data_batch_*.np[yz]")))
        if not paths:
            raise FileNotFoundError(
                f"ImageNet-64 not found under {self.data_dir!r} (expected "
                "train_data_batch_*.npz). No network egress — place the "
                "downsampled-ImageNet archives on disk or pass synthetic=True."
            )
        parts, labels = zip(*(_read_archive(p) for p in paths))
        return np.concatenate(parts), np.concatenate(labels)

    def setup_train(self) -> None:
        if self.train_data is None:
            self.train_data, labels = self._load()
            if self.with_labels:
                self.train_labels = labels

    def setup_test(self) -> None:
        # the test stage reuses the train set without augmentation, as in JAX
        self.setup_train()
        self.test_data = self.train_data
        self.test_labels = self.train_labels

    def augment(self, generator: torch.Generator, batch: torch.Tensor) -> torch.Tensor:
        if not self.horizontal_flip:
            return batch
        return random_horizontal_flip(generator, batch)
