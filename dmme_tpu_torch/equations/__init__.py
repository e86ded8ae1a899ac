"""Schedule and reverse-process math on tensors (mirrors ``dmme_tpu.equations``)."""

from dmme_tpu_torch.equations import ddim, ddpm
from dmme_tpu_torch.equations.gaussian import Gaussian

__all__ = ["ddpm", "ddim", "Gaussian"]
