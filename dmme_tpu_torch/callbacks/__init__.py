"""Training callbacks (mirrors ``dmme_tpu.callbacks``).

EMA is not a callback: it is part of the optimizer step
(:mod:`dmme_tpu_torch.training.ema`). ``ProfileTrace`` is not ported yet
(ROADMAP A.12).
"""

from dmme_tpu_torch.callbacks.generate import GenerateImage

__all__ = ["GenerateImage"]
