"""Improved DDPM: cosine schedule, learned variance, hybrid loss (mirrors
``dmme_tpu/diffusion/iddpm.py``).

The model emits 2·C channels: ε_θ, then the variance-interpolation
coefficient v. The hybrid objective is L = L_simple + γ·L_vlb, with ε_θ
detached inside L_vlb.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from dmme_tpu_torch import equations as eq
from dmme_tpu_torch.diffusion.ddpm import DDPM, ModelFn, _bcast, _timesteps
from dmme_tpu_torch.utils.noise import pad


class NoiseVariance(NamedTuple):
    noise: torch.Tensor
    variance: torch.Tensor


@dataclasses.dataclass(frozen=True)
class IDDPM(DDPM):
    """Improved DDPM (Nichol & Dhariwal 2021)."""

    loss_type: str = "hybrid"
    gamma: float = 0.001
    #: set by :meth:`strided`: the original timestep of each respaced index,
    #: which conditions the network (it was trained on the original grid)
    timestep_map: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, timesteps: int = 1000, loss_type: str = "hybrid", gamma: float = 0.001,
               schedule: str = "cosine", offset: float = 0.008, start: float = 0.0001,
               end: float = 0.02) -> "IDDPM":
        if schedule == "cosine":
            sched = eq.iddpm.cosine_beta_schedule(timesteps, offset)
        elif schedule == "linear":
            sched = eq.ddpm.schedule_from_beta(eq.ddpm.linear_schedule(timesteps, start, end))
        else:
            raise NotImplementedError(f"unknown schedule: {schedule}")
        if loss_type not in ("hybrid", "simple", "vlb"):
            raise ValueError(f"unknown loss_type: {loss_type}")
        return cls(schedule=sched, timesteps=timesteps, loss_type=loss_type, gamma=gamma)

    def to(self, device) -> "IDDPM":
        tm = None if self.timestep_map is None else self.timestep_map.to(device)
        return dataclasses.replace(self, schedule=self.schedule.to(device), timestep_map=tm)

    # ------------------------------------------------------------------ model
    def forward_model(self, model_fn: ModelFn, params: Any, x_t: torch.Tensor,
                      t: torch.Tensor, beta_t, alpha_bar_t, alpha_bar_t_minus_one,
                      **model_kwargs) -> NoiseVariance:
        """Split the network output into (ε, v) along channels and interpolate
        the variance between β_t and β̃_t. The output is cast to x_t's dtype
        (f32) before the split, so the variance's exp never runs in bf16."""
        t_model = t if self.timestep_map is None else self.timestep_map.to(t.device)[t]
        out = model_fn(params, x_t, t_model, **model_kwargs).to(x_t.dtype)
        eps_hat, v = torch.chunk(out, 2, dim=-1)
        bt = eq.iddpm.beta_tilde(beta_t, alpha_bar_t, alpha_bar_t_minus_one)
        return NoiseVariance(eps_hat, eq.iddpm.interpolate_variance(v, beta_t, bt))

    def _constants(self, t: torch.Tensor, ndim: int):
        sched = self.schedule.to(t.device)
        return (_bcast(sched.beta[t], ndim), _bcast(sched.alpha[t], ndim),
                _bcast(sched.alpha_bar[t], ndim), _bcast(sched.alpha_bar[t - 1], ndim))

    # ------------------------------------------------------------------ train
    def loss_given(self, model_fn: ModelFn, params: Any, x_0: torch.Tensor,
                   t: torch.Tensor, noise: torch.Tensor, *, train: bool = False,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The hybrid / simple / vlb objective with injected t and ε; the
        model's dropout, with ``train``, is drawn from ``generator``.
        :meth:`DDPM.loss` draws t, ε and dropout in that order and calls it."""
        beta_t, alpha_t, ab_t, ab_prev = self._constants(t, x_0.dim())
        x_t = eq.ddpm.q_sample(x_0, ab_t, noise)
        out = self.forward_model(model_fn, params, x_t, t, beta_t, ab_t, ab_prev,
                                 train=train, generator=generator)
        if self.loss_type == "simple":
            return eq.ddpm.simple_loss(noise, out.noise)
        vlb = eq.iddpm.loss_vlb(out.noise, out.variance, x_t, t, x_0, beta_t, alpha_t, ab_t,
                                ab_prev)
        if self.loss_type == "vlb":
            return vlb
        return eq.ddpm.simple_loss(noise, out.noise) + self.gamma * vlb

    # ----------------------------------------------------------------- respace
    def strided(self, sub_timesteps: int, tau_schedule: str = "linear") -> "IDDPM":
        """The process respaced onto a ``sub_timesteps``-step τ sub-sequence
        (IDDPM §4: with learned variances a strided sampler keeps most of the
        full-T quality). β^S_i = 1 − ᾱ_{τ_i}/ᾱ_{τ_{i−1}} keeps ᾱ at the kept
        points, and ``timestep_map`` conditions the network on the original
        timesteps. For sampling only: its loss would train on the respaced grid.

        The ratio is taken in float64 on the host: with a cosine schedule
        ᾱ_T ≈ 1e-15, and in f32 β would round to exactly 1 (α = 0, an
        infinite reverse mean); it is clipped to 0.999 as the cosine
        schedule itself is."""
        tau = {"linear": eq.ddim.linear_tau,
               "quadratic": eq.ddim.quadratic_tau}[tau_schedule](self.timesteps, sub_timesteps)
        ab = self.schedule.alpha_bar.cpu().numpy().astype(np.float64)[tau.numpy()]
        beta = torch.from_numpy(np.minimum(1.0 - ab[1:] / ab[:-1], 0.999).astype(np.float32))
        return IDDPM(
            schedule=eq.ddpm.schedule_from_beta(pad(beta, 0.0)),
            timesteps=sub_timesteps,
            parameterization=self.parameterization,
            snr_gamma=self.snr_gamma,
            loss_type=self.loss_type,
            gamma=self.gamma,
            timestep_map=tau,
        )

    # ----------------------------------------------------------------- sample
    def sampling_step(self, model_fn: ModelFn, params: Any, x_t: torch.Tensor, t,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One ancestral step with the learned variance; the mean at t == 1.
        ``noise`` replaces the draw from ``generator``."""
        t = _timesteps(t, x_t)
        beta_t, alpha_t, ab_t, ab_prev = self._constants(t, x_t.dim())
        out = self.forward_model(model_fn, params, x_t, t, beta_t, ab_t, ab_prev)
        p = eq.ddpm.reverse_process(x_t, beta_t, alpha_t, ab_t, out.noise, out.variance)
        x_prev = p.sample(generator, noise)
        return torch.where(_bcast(t, x_t.dim()) == 1, p.mean, x_prev)
