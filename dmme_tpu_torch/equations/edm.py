"""EDM equations (mirrors ``dmme_tpu/equations/edm.py``; Karras et al. 2022,
arXiv:2206.00364).

Diffusion in the continuous noise level σ with the preconditioned denoiser

    D_θ(x; σ) = c_skip(σ)·x + c_out(σ)·F_θ(c_in(σ)·x, c_noise(σ))

trained with the σ-weighted objective E_{σ,n}[λ(σ)·‖D_θ(x₀ + n; σ) − x₀‖²],
n ~ N(0, σ² I). Constants follow the paper's Table 1, "EDM" column. Every
function is pure and float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def karras_sigmas(steps: int, sigma_min: float = 0.002, sigma_max: float = 80.0,
                  rho: float = 7.0) -> torch.Tensor:
    """σ_0 > σ_1 > … > σ_{N−1}, then σ_N = 0: σ_i = (σ_max^{1/ρ} + i/(N−1)·
    (σ_min^{1/ρ} − σ_max^{1/ρ}))^ρ (paper eq. 5). Shape ``(steps + 1,)``."""
    i = torch.arange(steps, dtype=torch.float32)
    inv_rho = 1.0 / rho
    base = sigma_max ** inv_rho + i / max(steps - 1, 1) * (sigma_min ** inv_rho
                                                           - sigma_max ** inv_rho)
    # the power in float64, rounded once: f32 pow lands an ulp or two away
    sig = (base.double() ** rho).float()
    return torch.cat([sig, torch.zeros((1,), dtype=torch.float32)])


class Precond(NamedTuple):
    """The four σ-dependent preconditioning coefficients (paper Table 1)."""

    c_skip: torch.Tensor
    c_out: torch.Tensor
    c_in: torch.Tensor
    c_noise: torch.Tensor


def precond(sigma: torch.Tensor, sigma_data: float = 0.5) -> Precond:
    """Keeps the network's input and target at unit variance at every σ
    (paper §5): c_noise = ¼·ln σ is the float the UNet is conditioned on."""
    s2 = torch.square(sigma)
    d2 = sigma_data * sigma_data
    denom = s2 + d2
    return Precond(c_skip=d2 / denom, c_out=sigma * sigma_data * torch.rsqrt(denom),
                   c_in=torch.rsqrt(denom),
                   c_noise=0.25 * torch.log(torch.clamp(sigma, min=1e-38)))


def loss_weight(sigma: torch.Tensor, sigma_data: float = 0.5) -> torch.Tensor:
    """λ(σ) = (σ² + σ_d²)/(σ·σ_d)², so that λ·c_out² = 1: the weight on the
    raw network output is 1 at every σ."""
    s2 = torch.square(sigma)
    d2 = sigma_data * sigma_data
    return (s2 + d2) / torch.clamp(s2 * d2, min=1e-38)


def sample_sigma_lognormal(generator: torch.Generator, batch: int, p_mean: float = -1.2,
                           p_std: float = 1.2) -> torch.Tensor:
    """ln σ ~ N(P_mean, P_std²) (paper Table 1), (batch,) float32 on the
    generator's device."""
    z = torch.randn((batch,), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return torch.exp(p_mean + p_std * z)
