"""Encoder-reuse fast sampling, opt-in and approximate (mirrors
``dmme_tpu/diffusion/fast.py``; "Faster Diffusion: Rethinking the Role of
the UNet Encoder", Li et al., arXiv:2312.09608).

Along the reverse trajectory the UNet's encoder features change slowly.
At key steps the full network runs and its encoder state is kept; at the
steps between, the down path is skipped and the decoder runs on the kept
state with the current timestep embedding. ``refresh_interval=1`` is
exactly the canonical DDIM.

The samplers drive the UNet module itself (its feature-capture arguments),
not a bare ``model_fn``. Which steps are key steps is decided on the host
from the step index; the kept tensors are outputs of earlier forwards, which
no later forward writes into (every kernel wrapper allocates its outputs).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Optional, Tuple

import torch
from torch.func import functional_call

from dmme_tpu_torch.diffusion.ddim import DDIM


class FeatureCache:
    """The ``model_fn`` a caching sampler hands to its parent's loop, which
    calls it once a step. Call k (from 0) is a key step when k is a multiple
    of ``refresh_interval``: the module runs with ``base`` and ``capture``
    keyword arguments and its second output is kept; the other calls pass
    ``base`` and the kept tensor as ``reuse``. A module without those
    keyword arguments (a DiT has no feature capture) is refused here, before
    any forward."""

    def __init__(self, module: torch.nn.Module, refresh_interval: int, base: dict,
                 capture: dict, reuse: str):
        if refresh_interval < 1:
            raise ValueError(f"refresh_interval must be >= 1, got {refresh_interval}")
        taken = inspect.signature(module.forward).parameters
        needed = [k for k in (*base, *capture, reuse) if k not in taken]
        if needed:
            raise ValueError(f"the caching samplers drive the UNet's feature capture "
                             f"({', '.join(needed)}), which {type(module).__name__} does not "
                             "have; use ddim or dpm")
        self.module, self.refresh_interval = module, refresh_interval
        self.base, self.capture, self.reuse = base, capture, reuse
        self.calls, self.cache = 0, None

    def __call__(self, params: Any, x: torch.Tensor, t: torch.Tensor, **kwargs) -> torch.Tensor:
        key = self.calls % self.refresh_interval == 0
        self.calls += 1
        kwargs.update(self.base)
        if key:
            out, self.cache = functional_call(self.module, params, (x, t),
                                              {**kwargs, **self.capture})
            return out
        return functional_call(self.module, params, (x, t), {**kwargs, self.reuse: self.cache})


def _fields(algo) -> dict:
    return {f.name: getattr(algo, f.name) for f in dataclasses.fields(algo)}


@dataclasses.dataclass(frozen=True)
class CachedDDIM(DDIM):
    """Deterministic DDIM that refreshes the encoder features every
    ``refresh_interval`` steps and runs only the decoder between."""

    refresh_interval: int = 2

    @classmethod
    def create(cls, timesteps: int = 1000, sub_timesteps: int = 50,
               tau_schedule: str = "quadratic", refresh_interval: int = 2,
               parameterization: str = "eps") -> "CachedDDIM":
        base = DDIM.create(timesteps, sub_timesteps, tau_schedule, variant="canonical",
                           parameterization=parameterization)
        return cls(**_fields(base), refresh_interval=refresh_interval)

    def generate(self, module: torch.nn.Module, params: Any,
                 generator: Optional[torch.Generator], img_shape: Tuple[int, ...], *,
                 x_T: Optional[torch.Tensor] = None, history_length: Optional[int] = None):
        """x_T → x_0 as :meth:`DDIM.generate`; the encoder runs on key steps only."""
        fn = FeatureCache(module, self.refresh_interval, {}, {"return_features": True},
                          "cached")
        return DDIM.generate(self, fn, params, generator, img_shape, x_T=x_T,
                             history_length=history_length)
