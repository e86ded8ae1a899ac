"""Data modules (mirrors ``dmme_tpu.data``; CIFAR-10 so far)."""

from dmme_tpu_torch.data.cifar10 import CIFAR10
from dmme_tpu_torch.data.data_module import DataModule, random_horizontal_flip

__all__ = ["DataModule", "CIFAR10", "random_horizontal_flip"]
