"""Data modules (mirrors ``dmme_tpu.data``): CIFAR-10, ImageNet-64, LSUN over
the LMDB reader, and the procedural shapes."""

from dmme_tpu_torch.data.cifar10 import CIFAR10
from dmme_tpu_torch.data.data_module import DataModule, random_horizontal_flip
from dmme_tpu_torch.data.imagefolder import ImageFolder64
from dmme_tpu_torch.data.lmdb_reader import LMDBReader
from dmme_tpu_torch.data.lsun import LSUN
from dmme_tpu_torch.data.shapes import Shapes, render_shapes

__all__ = ["DataModule", "CIFAR10", "ImageFolder64", "LSUN", "LMDBReader", "Shapes",
           "render_shapes", "random_horizontal_flip"]
