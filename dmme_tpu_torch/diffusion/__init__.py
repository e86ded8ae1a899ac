"""Diffusion sampling algorithms (mirrors ``dmme_tpu.diffusion``)."""

from dmme_tpu_torch.diffusion.ddim import DDIM
from dmme_tpu_torch.diffusion.ddpm import DDPM

__all__ = ["DDPM", "DDIM"]
