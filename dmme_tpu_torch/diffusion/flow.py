"""Flow matching / rectified flow: straight-path velocity regression with an
Euler or midpoint ODE sampler (mirrors ``dmme_tpu/diffusion/flow.py``;
Lipman et al. 2023, arXiv:2210.02747; Liu et al. 2022, arXiv:2209.03003;
the timestep density and resolution shift of SD3, Esser et al. 2024,
arXiv:2403.03206).

The velocity network is the UNet of every other algorithm, conditioned on
the float ``t · time_scale`` (t ∈ [0, 1] alone would use only the time
embedding's low frequencies; 1000 matches the discrete models' range).
Sampling is a Python loop down the host's t grid: ``order=1`` takes
``steps`` network evaluations, ``order=2`` (explicit midpoint) ``2·steps``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from dmme_tpu_torch import equations as eq
from dmme_tpu_torch.diffusion.ddpm import HistoryCapture, ModelFn, _start
from dmme_tpu_torch.diffusion.edm import _per_sample


@dataclasses.dataclass(frozen=True)
class FlowMatching:
    """Rectified-flow training and ODE sampling. ``ts`` is the descending
    grid 1 → 0 (optionally resolution-shifted); training draws t from
    ``t_sample`` ∈ {"uniform", "logit_normal"}."""

    ts: torch.Tensor  # (steps+1,) float32 on the CPU, ts[0] = 1, ts[-1] = 0
    steps: int = 25
    order: int = 2
    shift: float = 1.0
    t_sample: str = "logit_normal"
    logit_mean: float = 0.0
    logit_std: float = 1.0
    time_scale: float = 1000.0

    @classmethod
    def create(cls, steps: int = 25, order: int = 2, shift: float = 1.0,
               t_sample: str = "logit_normal", logit_mean: float = 0.0,
               logit_std: float = 1.0, time_scale: float = 1000.0) -> "FlowMatching":
        if order not in (1, 2) or t_sample not in ("uniform", "logit_normal"):
            raise ValueError(f"order {order} / t_sample {t_sample!r}")
        return cls(ts=eq.flow.time_grid(steps, shift), steps=steps, order=order, shift=shift,
                   t_sample=t_sample, logit_mean=logit_mean, logit_std=logit_std,
                   time_scale=time_scale)

    def velocity(self, model_fn: ModelFn, params: Any, x: torch.Tensor, t, *,
                 train: bool = False,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """v_θ(x, t): the raw network output, with no preconditioning (the
        target x₁ − x₀ is O(1) at every t). ``t`` is a scalar or (N,)."""
        return model_fn(params, x, _per_sample(t, x) * self.time_scale, train=train,
                        generator=generator).to(x.dtype)

    # ------------------------------------------------------------------ train
    def loss(self, model_fn: ModelFn, params: Any, generator: torch.Generator,
             x_0: torch.Tensor, *, train: bool = True) -> torch.Tensor:
        """E_{t, x₁}‖v_θ(x_t, t) − (x₁ − x₀)‖²: t, then x₁, then the model's
        dropout drawn from ``generator``."""
        if self.t_sample == "logit_normal":
            t = eq.flow.sample_t_logit_normal(generator, x_0.shape[0], self.logit_mean,
                                              self.logit_std)
        else:
            t = eq.flow.sample_t_uniform(generator, x_0.shape[0])
        x_1 = torch.randn(x_0.shape, generator=generator, dtype=x_0.dtype,
                          device=generator.device)
        return self.loss_given(model_fn, params, x_0, t, x_1, train=train, generator=generator)

    def loss_given(self, model_fn: ModelFn, params: Any, x_0: torch.Tensor, t: torch.Tensor,
                   x_1: torch.Tensor, *, train: bool = False,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The loss with injected (N,) t and noise endpoint x₁: the
        deterministic core of :meth:`loss`."""
        x_t = eq.flow.interpolate(x_0, x_1, t)
        v = self.velocity(model_fn, params, x_t, t, train=train, generator=generator)
        target = eq.flow.velocity_target(x_0, x_1)
        return torch.mean(torch.square(v - target.to(v.dtype)))

    # ----------------------------------------------------------------- sample
    def sampling_step(self, model_fn: ModelFn, params: Any, x: torch.Tensor, i: int,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One ODE step t_i → t_{i+1}; deterministic (``generator`` is taken
        for the samplers' common signature). The midpoint t_i + Δ/2 lies
        strictly inside (0, 1), so no step needs special-casing."""
        t = self.ts[i]
        dt = self.ts[i + 1] - t  # negative: noise → data
        v = self.velocity(model_fn, params, x, t)
        if self.order == 1:
            return x + dt * v
        x_mid = x + 0.5 * dt * v
        v_mid = self.velocity(model_fn, params, x_mid, t + 0.5 * dt)
        return x + dt * v_mid

    @torch.no_grad()
    def generate(self, model_fn: ModelFn, params: Any,
                 generator: Optional[torch.Generator], img_shape: Tuple[int, ...], *,
                 x_T: Optional[torch.Tensor] = None, history_length: Optional[int] = None):
        """x ~ N(0, I) at t = 1 (``x_T`` or a draw from ``generator``) → x₀;
        with ``history_length``, ``(x_0, history)`` as :meth:`DDPM.generate`
        returns it."""
        x = _start(img_shape, generator, x_T)
        capture = None if history_length is None else HistoryCapture(self.steps,
                                                                     history_length, x)
        for i in range(self.steps):
            x = self.sampling_step(model_fn, params, x, i)
            if capture is not None:
                capture(i, x)
        return x if capture is None else (x, capture.frames)
