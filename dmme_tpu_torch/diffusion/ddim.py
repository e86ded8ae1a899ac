"""DDIM sampling over a trained DDPM (mirrors ``dmme_tpu/diffusion/ddim.py``).
Training is DDPM's, inherited.

``variant="canonical"`` (default) is the paper's Eq. 12, η-parameterised;
``variant="reference"`` divides x̂_0 by √ᾱ_{τ_{i−1}} and drops the
direction term, as the original reference code does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from dmme_tpu_torch import equations as eq
from dmme_tpu_torch.diffusion.ddpm import DDPM, ModelFn, _bcast, _start, _timesteps


@dataclasses.dataclass(frozen=True)
class DDIM(DDPM):
    """Denoising Diffusion Implicit Model (Song et al. 2021)."""

    tau: torch.Tensor = None  # (S+1,) int64, tau[0] == 0
    sub_timesteps: int = 50
    eta: float = 0.0
    variant: str = "canonical"
    #: clamp x̂₀ to [−1, 1] before the update
    clip_x0: bool = False

    @classmethod
    def create(cls, timesteps: int = 1000, sub_timesteps: int = 50,
               tau_schedule: str = "quadratic", start: float = 0.0001, end: float = 0.02,
               eta: float = 0.0, variant: str = "canonical",
               parameterization: str = "eps", snr_gamma: Optional[float] = None) -> "DDIM":
        assert parameterization in ("eps", "v"), parameterization
        beta = eq.ddpm.linear_schedule(timesteps, start, end)
        return cls(
            schedule=eq.ddpm.schedule_from_beta(beta),
            timesteps=timesteps,
            parameterization=parameterization,
            snr_gamma=snr_gamma,
            tau=eq.ddim.make_tau(tau_schedule, timesteps, sub_timesteps),
            sub_timesteps=sub_timesteps,
            eta=eta,
            variant=variant,
        )

    def to(self, device) -> "DDIM":
        return dataclasses.replace(self, schedule=self.schedule.to(device),
                                   tau=self.tau.to(device))

    def clipped_eps(self, x_t: torch.Tensor, ab_t: torch.Tensor,
                    eps_hat: torch.Tensor) -> torch.Tensor:
        """With ``clip_x0``: clamp the data prediction to [−1, 1] and re-derive
        the ε consistent with it. At a degenerate ᾱ_t = 1 entry the model's own
        ε is kept; the update multiplies it by an exact zero there."""
        if not self.clip_x0:
            return eps_hat
        x0 = torch.clamp(eq.ddim.predict_x0(x_t, ab_t, eps_hat), -1.0, 1.0)
        rederived = (x_t - torch.sqrt(ab_t) * x0) / torch.sqrt(
            torch.clamp(1.0 - ab_t, min=1e-20)
        )
        return torch.where(ab_t >= 1.0, eps_hat, rederived)

    def sampling_step(self, model_fn: ModelFn, params: Any, x_tau_i: torch.Tensor, i,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One strided step x_{τ_i} → x_{τ_{i−1}}; ``i`` indexes the τ table.
        With η = 0 the step is deterministic and draws nothing."""
        algo = self.to(x_tau_i.device)
        i = _timesteps(i, x_tau_i)
        tau_i = algo.tau[i]
        ab_t = _bcast(algo.schedule.alpha_bar[tau_i], x_tau_i.dim())
        ab_prev = _bcast(algo.schedule.alpha_bar[algo.tau[i - 1]], x_tau_i.dim())

        out = model_fn(params, x_tau_i, tau_i).to(x_tau_i.dtype)
        eps_hat = self.clipped_eps(x_tau_i, ab_t, self.to_eps(out, x_tau_i, ab_t))
        if self.variant == "reference":
            return eq.ddim.reverse_process(x_tau_i, ab_t, ab_prev, eps_hat).mean
        p = eq.ddim.reverse_process_canonical(x_tau_i, ab_t, ab_prev, eps_hat, self.eta)
        if self.eta == 0.0:
            return p.mean
        x_prev = p.sample(generator, noise)
        return torch.where(_bcast(i, x_tau_i.dim()) == 1, p.mean, x_prev)

    @torch.no_grad()
    def generate(self, model_fn: ModelFn, params: Any,
                 generator: Optional[torch.Generator], img_shape: Tuple[int, ...], *,
                 x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
        """S-step strided reverse process from x_T (drawn from ``generator``
        on its device unless given)."""
        x = _start(img_shape, generator, x_T)
        algo = self.to(x.device)
        for i in range(self.sub_timesteps, 0, -1):
            x = algo.sampling_step(model_fn, params, x, i, generator)
        return x
