"""DDPM equations (mirrors ``dmme_tpu/equations/ddpm.py``).

Schedules follow the 1-based timestep convention: tensors of length ``T+1``
with a sentinel at index 0, so ``schedule[t]`` is the paper's value at ``t``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dmme_tpu_torch.equations.gaussian import Gaussian
from dmme_tpu_torch.utils.noise import pad


class Schedule(NamedTuple):
    """Diffusion constants, each of shape ``(T+1,)``, float32."""

    beta: torch.Tensor
    alpha: torch.Tensor
    alpha_bar: torch.Tensor

    @property
    def timesteps(self) -> int:
        return self.beta.shape[0] - 1

    def to(self, device) -> "Schedule":
        return Schedule(*(a.to(device) for a in self))


def linear_schedule(timesteps: int, start: float = 0.0001, end: float = 0.02) -> torch.Tensor:
    """β_t increasing linearly from ``start`` to ``end``; length ``T+1``, β_0 = 0."""
    beta = torch.linspace(start, end, timesteps, dtype=torch.float32)
    return pad(beta, 0.0)


def schedule_from_beta(beta: torch.Tensor) -> Schedule:
    """α = 1 − β and ᾱ = cumprod(α); with β_0 = 0 the sentinel leaves ᾱ unchanged."""
    alpha = 1.0 - beta
    return Schedule(beta=beta, alpha=alpha, alpha_bar=torch.cumprod(alpha, dim=0))


def forward_process(x_0: torch.Tensor, alpha_bar_t: torch.Tensor) -> Gaussian:
    """q(x_t | x_0) = N(√ᾱ_t · x_0, (1 − ᾱ_t) I)."""
    mean = torch.sqrt(alpha_bar_t) * x_0
    return Gaussian(mean, torch.sqrt(1.0 - alpha_bar_t).expand_as(mean))


def q_sample(x_0: torch.Tensor, alpha_bar_t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """x_t = √ᾱ_t · x_0 + √(1 − ᾱ_t) · ε, the sampling form of :func:`forward_process`."""
    return torch.sqrt(alpha_bar_t) * x_0 + torch.sqrt(1.0 - alpha_bar_t) * noise


def v_target(x_0: torch.Tensor, alpha_bar_t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Velocity target v = √ᾱ_t·ε − √(1−ᾱ_t)·x₀ (Salimans & Ho 2022)."""
    return torch.sqrt(alpha_bar_t) * noise - torch.sqrt(1.0 - alpha_bar_t) * x_0


def eps_from_v(v: torch.Tensor, x_t: torch.Tensor, alpha_bar_t: torch.Tensor) -> torch.Tensor:
    """ε = √ᾱ_t·v + √(1−ᾱ_t)·x_t, the inverse of the v-parameterisation."""
    return torch.sqrt(alpha_bar_t) * v + torch.sqrt(1.0 - alpha_bar_t) * x_t


def simple_loss(noise: torch.Tensor, estimated_noise: torch.Tensor) -> torch.Tensor:
    """L_simple: the mean squared error between true and predicted noise."""
    return torch.mean(torch.square(noise - estimated_noise))


def snr(alpha_bar_t: torch.Tensor) -> torch.Tensor:
    """Signal-to-noise ratio SNR(t) = ᾱ_t / (1 − ᾱ_t)."""
    return alpha_bar_t / torch.clamp(1.0 - alpha_bar_t, min=1e-20)


def min_snr_weight(alpha_bar_t: torch.Tensor, gamma: float,
                   parameterization: str = "eps") -> torch.Tensor:
    """Min-SNR-γ loss weight (Hang et al. 2023): min(SNR, γ)/SNR on the
    ε-objective, min(SNR, γ)/(SNR + 1) on the v-objective."""
    s = snr(alpha_bar_t)
    clipped = torch.clamp(s, max=gamma)
    if parameterization == "v":
        return clipped / (s + 1.0)
    return clipped / torch.clamp(s, min=1e-20)


def reverse_process(
    x_t: torch.Tensor,
    beta_t: torch.Tensor,
    alpha_t: torch.Tensor,
    alpha_bar_t: torch.Tensor,
    noise_in_x_t: torch.Tensor,
    variance: torch.Tensor,
) -> Gaussian:
    """p_θ(x_{t−1} | x_t): mean = 1/√α_t · (x_t − β_t/√(1 − ᾱ_t) · ε_θ)."""
    mean = torch.rsqrt(alpha_t) * (
        x_t - beta_t * torch.rsqrt(1.0 - alpha_bar_t) * noise_in_x_t
    )
    return Gaussian(mean, torch.sqrt(variance).expand_as(mean))
