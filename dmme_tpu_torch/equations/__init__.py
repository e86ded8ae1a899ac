"""Schedule and reverse-process math on tensors (mirrors ``dmme_tpu.equations``)."""

from dmme_tpu_torch.equations import ddim, ddpm, edm, flow, iddpm
from dmme_tpu_torch.equations.gaussian import Gaussian, kl_divergence

__all__ = ["ddpm", "ddim", "iddpm", "edm", "flow", "Gaussian", "kl_divergence"]
