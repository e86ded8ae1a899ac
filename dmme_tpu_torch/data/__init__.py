"""Data modules (mirrors ``dmme_tpu.data``): CIFAR-10 and the procedural shapes."""

from dmme_tpu_torch.data.cifar10 import CIFAR10
from dmme_tpu_torch.data.data_module import DataModule, random_horizontal_flip
from dmme_tpu_torch.data.shapes import Shapes, render_shapes

__all__ = ["DataModule", "CIFAR10", "Shapes", "render_shapes", "random_horizontal_flip"]
