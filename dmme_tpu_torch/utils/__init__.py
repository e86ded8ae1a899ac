"""Noise, range and visualisation helpers (mirrors ``dmme_tpu.utils``)."""

from dmme_tpu_torch.utils.noise import gaussian, gaussian_like, pad, uniform_int
from dmme_tpu_torch.utils.norm import denorm, norm
from dmme_tpu_torch.utils.vis import make_grid, make_history

__all__ = ["gaussian", "gaussian_like", "uniform_int", "pad", "norm", "denorm", "make_grid",
           "make_history"]
