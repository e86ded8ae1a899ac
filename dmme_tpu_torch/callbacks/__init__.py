"""Training callbacks (mirrors ``dmme_tpu.callbacks``).

EMA is not a callback: it is part of the optimizer step
(:mod:`dmme_tpu_torch.training.ema`).
"""

from dmme_tpu_torch.callbacks.generate import GenerateImage
from dmme_tpu_torch.callbacks.profile import ProfileTrace

__all__ = ["GenerateImage", "ProfileTrace"]
