"""Schedule and reverse-process math on tensors (mirrors ``dmme_tpu.equations``)."""

from dmme_tpu_torch.equations import ddim, ddpm, iddpm
from dmme_tpu_torch.equations.gaussian import Gaussian, kl_divergence

__all__ = ["ddpm", "ddim", "iddpm", "Gaussian", "kl_divergence"]
