"""DeepCache-style fast sampling, opt-in and approximate (mirrors
``dmme_tpu/diffusion/deep_cache.py``; "DeepCache", Ma et al. 2023; block
caching, Wimbauer et al. 2023).

Along the reverse trajectory the UNet's deep features change slowly, while
the shallow, high-resolution layers drive each step's refinement. At key
steps the full network runs and the output of its deep core (resolution
depths > ``cache_depth``: down-path suffix, middle, up-path prefix) is
kept; between them only the shallow layers run, on the kept core output,
with fresh skips and the current timestep embedding. Where
:class:`~dmme_tpu_torch.diffusion.fast.CachedDDIM` keeps the down path and
recomputes the decoder, this keeps the core and recomputes both shallow
ends. ``refresh_interval=1`` is exactly the canonical DDIM (``deep``) or
DPM-Solver++(2M) (``deep_dpm``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from dmme_tpu_torch.diffusion.ddim import DDIM
from dmme_tpu_torch.diffusion.dpm_solver import DPMSolverPP
from dmme_tpu_torch.diffusion.fast import FeatureCache, _fields
from dmme_tpu_torch.equations.ddpm import Schedule


def _deep_cache(module, refresh_interval: int, cache_depth: int) -> FeatureCache:
    return FeatureCache(module, refresh_interval, {"cache_depth": cache_depth},
                        {"return_deep": True}, "deep_cache")


@dataclasses.dataclass(frozen=True)
class DeepCachedDDIM(DDIM):
    """Deterministic DDIM that refreshes the UNet's deep core every
    ``refresh_interval`` steps and reuses its output between."""

    refresh_interval: int = 2
    cache_depth: int = 1

    @classmethod
    def create(cls, timesteps: int = 1000, sub_timesteps: int = 50,
               tau_schedule: str = "quadratic", refresh_interval: int = 2,
               cache_depth: int = 1, parameterization: str = "eps") -> "DeepCachedDDIM":
        base = DDIM.create(timesteps, sub_timesteps, tau_schedule, variant="canonical",
                           parameterization=parameterization)
        return cls(**_fields(base), refresh_interval=refresh_interval, cache_depth=cache_depth)

    def generate(self, module: torch.nn.Module, params: Any,
                 generator: Optional[torch.Generator], img_shape: Tuple[int, ...], *,
                 x_T: Optional[torch.Tensor] = None, history_length: Optional[int] = None):
        """x_T → x_0 as :meth:`DDIM.generate`; the deep core runs on key steps only."""
        fn = _deep_cache(module, self.refresh_interval, self.cache_depth)
        return DDIM.generate(self, fn, params, generator, img_shape, x_T=x_T,
                             history_length=history_length)


@dataclasses.dataclass(frozen=True)
class DeepCachedDPM(DPMSolverPP):
    """DPM-Solver++(2M) with the deep-core cache: the solver reaches DDIM-50's
    quality in about 20 evaluations, and the cache makes the non-key ones
    cheap. Its loop is :meth:`DPMSolverPP.generate`'s, step for step."""

    refresh_interval: int = 2
    cache_depth: int = 1

    @classmethod
    def create(cls, timesteps: int = 1000, sub_timesteps: int = 20,
               tau_schedule: str = "quadratic", refresh_interval: int = 2,
               cache_depth: int = 1, order: int = 2, schedule: Optional[Schedule] = None,
               parameterization: str = "eps") -> "DeepCachedDPM":
        base = DPMSolverPP.create(timesteps, sub_timesteps, tau_schedule, order=order,
                                  schedule=schedule, parameterization=parameterization)
        return cls(**_fields(base), refresh_interval=refresh_interval, cache_depth=cache_depth)

    def generate(self, module: torch.nn.Module, params: Any,
                 generator: Optional[torch.Generator], img_shape: Tuple[int, ...], *,
                 x_T: Optional[torch.Tensor] = None, history_length: Optional[int] = None):
        """x_T → x_0 as :meth:`DPMSolverPP.generate`; the deep core runs on
        key steps only."""
        fn = _deep_cache(module, self.refresh_interval, self.cache_depth)
        return DPMSolverPP.generate(self, fn, params, generator, img_shape, x_T=x_T,
                                    history_length=history_length)
