"""DDIM equations (mirrors ``dmme_tpu/equations/ddim.py``): τ sub-sequences
and the implicit reverse process, in the reference-compatible and the
canonical (paper Eq. 12) forms."""

from __future__ import annotations

from typing import Optional

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


def karras_tau(alpha_bar: torch.Tensor, sub_timesteps: int, rho: float = 7.0,
               sigma_max: float = 80.0) -> torch.Tensor:
    """τ table (length ``S+1``, τ_0 = 0) from the Karras et al. 2022 σ
    spacing, snapped onto the trained discrete schedule.

    S points evenly spaced in σ^{1/ρ} between min(σ(T), ``sigma_max``) and
    σ(1), σ(t) = √(1−ᾱ_t)/√ᾱ_t, each snapped to the timestep nearest in
    log σ. The σ_max clamp matters for cosine schedules, whose ᾱ_T ≈ 2e-15
    puts σ(T) near 2·10⁷: a grid anchored there would collapse most of its
    points onto the last timesteps. Snaps may repeat a timestep at small T;
    the samplers take a repeated τ entry as an identity step."""
    ab = alpha_bar.to(torch.float32)
    # σ over the real timesteps 1..T (index 0 is the ᾱ = 1 sentinel, σ = 0)
    sigma = torch.sqrt((1.0 - ab[1:]) / torch.clamp(ab[1:], min=1e-38))
    s_min, s_max = sigma[0], torch.clamp(sigma[-1], max=sigma_max)
    i = torch.arange(sub_timesteps, dtype=torch.float32, device=ab.device) / max(
        sub_timesteps - 1, 1)
    grid = (s_max ** (1.0 / rho) + i * (s_min ** (1.0 / rho) - s_max ** (1.0 / rho))) ** rho
    t_of = torch.argmin(torch.abs(torch.log(sigma)[None, :] - torch.log(grid)[:, None]),
                        dim=1) + 1
    return torch.cat([torch.zeros((1,), dtype=torch.int64, device=ab.device),
                      t_of.flip(0).to(torch.int64)])


def lambda_coeffs(alpha_bar: torch.Tensor, t):
    """(α_t, σ_t, λ_t) at integer timestep(s) ``t`` for the λ = log(α/σ)
    solvers (DPM-Solver++, UniPC), f32. The σ clamp makes λ(τ=0) finite but
    huge; the solvers' lower-order final steps rely on exp(−h) underflowing
    to exactly 0 there."""
    ab = alpha_bar[t]
    alpha = torch.sqrt(ab)
    sigma = torch.sqrt(1.0 - ab)
    lam = torch.log(alpha) - torch.log(torch.clamp(sigma, min=1e-38))
    return alpha, sigma, lam


def make_tau(name: str, timesteps: int, sub_timesteps: int,
             alpha_bar: Optional[torch.Tensor] = None) -> torch.Tensor:
    """τ table by spacing name: linear | quadratic | karras (which needs the
    schedule's ``alpha_bar``)."""
    name = name.lower()
    if name == "linear":
        return linear_tau(timesteps, sub_timesteps)
    if name == "quadratic":
        return quadratic_tau(timesteps, sub_timesteps)
    if name == "karras":
        if alpha_bar is None:
            raise ValueError("karras tau spacing needs the schedule's alpha_bar")
        return karras_tau(alpha_bar, sub_timesteps)
    raise NotImplementedError(f"unknown tau schedule: {name}")


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
