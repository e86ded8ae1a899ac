"""CIFAR-10 data module (mirrors ``dmme_tpu/data/cifar10.py``).

Reads the standard on-disk formats directly (no torchvision):

* python version: ``cifar-10-batches-py/data_batch_{1..5}`` pickle dicts with
  (N, 3072) uint8 rows in R|G|B channel-plane order;
* binary version: ``cifar-10-batches-bin/data_batch_{1..5}.bin`` records of
  1 label byte + 3072 image bytes.

Nothing is downloaded: the dataset must already be under ``data_dir``
(``download=True`` raises where it is not, naming the missing network).
``synthetic=True`` makes a deterministic uint8 dataset of the right shape
from ``numpy.random.default_rng(0)``, the same bytes as the JAX package's.
Augmentation: a random horizontal flip on the batch's device.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from dmme_tpu_torch.data.data_module import DataModule, random_horizontal_flip

_TRAIN_PICKLES = [f"data_batch_{i}" for i in range(1, 6)]
_TRAIN_BINS = [f"data_batch_{i}.bin" for i in range(1, 6)]


def _from_planes(flat: np.ndarray) -> np.ndarray:
    """(N, 3072) channel-plane rows → (N, 32, 32, 3) NHWC uint8."""
    return flat.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)


class CIFAR10(DataModule):
    img_size = 32

    def __init__(self, data_dir: str = ".", batch_size: int = 128,
                 horizontal_flip: bool = True, synthetic: bool = False,
                 synthetic_size: int = 50_000, with_labels: bool = False,
                 download: bool = False):
        super().__init__(batch_size)
        self.download = download
        self.data_dir = data_dir
        self.horizontal_flip = horizontal_flip
        self.synthetic = synthetic
        self.synthetic_size = synthetic_size
        self.with_labels = with_labels

    def prepare_data(self) -> None:
        """With ``download``, check that the dataset is on disk: this package
        fetches nothing (the JAX package downloads it here)."""
        if self.synthetic or not self.download or self._find() is not None:
            return
        raise FileNotFoundError(
            f"CIFAR10(download=True): the dataset is not under {self.data_dir!r} and "
            "dmme_tpu_torch downloads nothing (no network access is assumed); place "
            "cifar-10-batches-py/ or cifar-10-batches-bin/ there or pass synthetic=True")

    def _find(self):
        """(kind, directory) of the on-disk dataset under ``data_dir``, or None."""
        py_dir = os.path.join(self.data_dir, "cifar-10-batches-py")
        if os.path.isdir(py_dir):
            return "py", py_dir
        for bin_dir in (os.path.join(self.data_dir, "cifar-10-batches-bin"),
                        os.path.join(self.data_dir, "cifar-10-binary", "cifar-10-batches-bin")):
            if os.path.isdir(bin_dir):
                return "bin", bin_dir
        return None

    def _load(self):
        if self.synthetic:
            rng = np.random.default_rng(0)
            images = rng.integers(0, 256, (self.synthetic_size, 32, 32, 3), dtype=np.uint8)
            labels = rng.integers(0, 10, (self.synthetic_size,), dtype=np.int32)
            return images, labels

        found = self._find()
        if found is not None and found[0] == "py":
            py_dir = found[1]
            parts, labels = [], []
            for name in _TRAIN_PICKLES:
                with open(os.path.join(py_dir, name), "rb") as f:
                    d = pickle.load(f, encoding="bytes")
                parts.append(_from_planes(np.asarray(d[b"data"], np.uint8)))
                labels.append(np.asarray(d[b"labels"], np.int32))
            return np.concatenate(parts), np.concatenate(labels)

        if found is not None:
            parts, labels = [], []
            for name in _TRAIN_BINS:
                rec = np.fromfile(os.path.join(found[1], name), np.uint8).reshape(-1, 3073)
                labels.append(rec[:, 0].astype(np.int32))
                parts.append(_from_planes(rec[:, 1:]))
            return np.concatenate(parts), np.concatenate(labels)

        raise FileNotFoundError(
            f"CIFAR-10 not found under {self.data_dir!r} (expected cifar-10-batches-py/ "
            "or cifar-10-batches-bin/); place the dataset on disk or pass synthetic=True")

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
