"""DDIM equations (mirrors ``dmme_tpu/equations/ddim.py``): τ sub-sequences
and the implicit reverse process, in the reference-compatible and the
canonical (paper Eq. 12) forms."""

from __future__ import annotations

import torch

from dmme_tpu_torch.equations import ddpm as eq_ddpm
from dmme_tpu_torch.equations.gaussian import Gaussian


def linear_tau(timesteps: int, sub_timesteps: int) -> torch.Tensor:
    """τ_i = round(T/S · i), length ``S+1``, τ_0 = 0 (round half to even)."""
    all_i = torch.arange(0, sub_timesteps + 1, dtype=torch.float32)
    return torch.round((timesteps / sub_timesteps) * all_i).to(torch.int64)


def quadratic_tau(timesteps: int, sub_timesteps: int) -> torch.Tensor:
    """τ_i = round(T/S² · i²), length ``S+1``, τ_0 = 0 (round half to even)."""
    all_i = torch.arange(0, sub_timesteps + 1, dtype=torch.float32)
    return torch.round((timesteps / sub_timesteps**2) * torch.square(all_i)).to(torch.int64)


def make_tau(name: str, timesteps: int, sub_timesteps: int) -> torch.Tensor:
    """τ table by spacing name: linear | quadratic."""
    name = name.lower()
    if name == "linear":
        return linear_tau(timesteps, sub_timesteps)
    if name == "quadratic":
        return quadratic_tau(timesteps, sub_timesteps)
    raise NotImplementedError(f"tau schedule {name!r} is not ported")


def predict_x0(x_t: torch.Tensor, alpha_bar_t: torch.Tensor,
               noise_in_x_t: torch.Tensor) -> torch.Tensor:
    """x̂_0 = (x_t − √(1 − ᾱ_t) · ε_θ) / √ᾱ_t."""
    return (x_t - torch.sqrt(1.0 - alpha_bar_t) * noise_in_x_t) * torch.rsqrt(alpha_bar_t)


def reverse_process(
    x_t: torch.Tensor,
    alpha_bar_t: torch.Tensor,
    alpha_bar_t_minus_one: torch.Tensor,
    noise_in_x_t: torch.Tensor,
) -> Gaussian:
    """Reference-compatible deterministic step: divides x̂_0 by
    ``√ᾱ_{τ_{i−1}}``; callers take only the mean."""
    predicted_x_0 = (
        x_t - torch.sqrt(1.0 - alpha_bar_t) * noise_in_x_t
    ) * torch.rsqrt(alpha_bar_t_minus_one)
    return eq_ddpm.forward_process(predicted_x_0, alpha_bar_t_minus_one)


def reverse_process_canonical(
    x_t: torch.Tensor,
    alpha_bar_t: torch.Tensor,
    alpha_bar_t_minus_one: torch.Tensor,
    noise_in_x_t: torch.Tensor,
    eta: float = 0.0,
) -> Gaussian:
    """Canonical DDIM update (paper Eq. 12), η-parameterised.

    mean = √ᾱ_{t−1} · x̂_0 + √(1 − ᾱ_{t−1} − σ²) · ε_θ
    σ    = η · √((1 − ᾱ_{t−1})/(1 − ᾱ_t)) · √(1 − ᾱ_t/ᾱ_{t−1})

    Quadratic τ tables have τ_1 = 0 whenever T/S² < 0.5 (T=1000, S=50), so
    ᾱ_t = 1 at the last step. The clamped denominator and the clips keep
    σ = 0 there instead of η·inf = NaN, even for η = 0.
    """
    x0 = predict_x0(x_t, alpha_bar_t, noise_in_x_t)
    sigma = (
        eta
        * torch.sqrt(
            (1.0 - alpha_bar_t_minus_one)
            / torch.clamp(1.0 - alpha_bar_t, min=1e-20)
        )
        * torch.sqrt(torch.clamp(1.0 - alpha_bar_t / alpha_bar_t_minus_one, min=0.0))
    )
    direction = torch.sqrt(
        torch.clamp(1.0 - alpha_bar_t_minus_one - torch.square(sigma), min=0.0)
    )
    mean = torch.sqrt(alpha_bar_t_minus_one) * x0 + direction * noise_in_x_t
    return Gaussian(mean, sigma.expand_as(mean))
