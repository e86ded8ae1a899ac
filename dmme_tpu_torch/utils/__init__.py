"""Noise, range and visualisation helpers (mirrors ``dmme_tpu.utils``)."""

from dmme_tpu_torch.utils.noise import pad
from dmme_tpu_torch.utils.norm import denorm, norm
from dmme_tpu_torch.utils.vis import make_grid, make_history

__all__ = ["pad", "norm", "denorm", "make_grid", "make_history"]
