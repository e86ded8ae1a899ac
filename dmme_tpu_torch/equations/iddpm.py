"""Improved DDPM equations (mirrors ``dmme_tpu/equations/iddpm.py``): the
cosine schedule, the learned-variance interpolation and the VLB loss.

The t == 1 discretized NLL and the t > 1 KL term are both computed for every
element and blended with ``torch.where``; the inputs of the branch not taken
are clamped so that its gradient stays finite.
"""

from __future__ import annotations

import math

import torch

from dmme_tpu_torch.equations import ddpm as eq_ddpm
from dmme_tpu_torch.equations.gaussian import Gaussian, kl_divergence
from dmme_tpu_torch.utils.noise import pad


def cosine_schedule(timesteps: int = 4000, offset: float = 0.008) -> torch.Tensor:
    """ᾱ_t = f(t)/f(0) with f(t) = cos²(((t/T + s)/(1 + s)) · π/2); length T+1, f32."""
    t = torch.arange(0, timesteps + 1, dtype=torch.float32)

    def f(u):
        return torch.square(torch.cos((u / timesteps + offset) / (1.0 + offset)
                                      * math.pi / 2.0))

    return f(t) / f(torch.tensor(0.0))


def cosine_beta_schedule(timesteps: int = 4000, offset: float = 0.008) -> eq_ddpm.Schedule:
    """β_t = clip(1 − ᾱ_t/ᾱ_{t−1}, 0, 0.999) padded with **1** at index 0,
    and ᾱ kept as the raw cosine curve (not the cumulative product of the
    clipped α), as the JAX package and its reference register them."""
    alpha_bar = cosine_schedule(timesteps, offset)
    beta = torch.clamp(1.0 - alpha_bar[1:] / alpha_bar[:-1], 0.0, 0.999)
    beta = pad(beta, 1.0)
    return eq_ddpm.Schedule(beta=beta, alpha=1.0 - beta, alpha_bar=alpha_bar)


def discrete_nll_loss(x_0: torch.Tensor, p: Gaussian) -> torch.Tensor:
    """Discretized Gaussian negative log-likelihood over 1/255-wide bins;
    the edge bins integrate to ±∞."""
    f_plus = torch.where(x_0 < 1.0, p.cdf(x_0 + 1.0 / 255.0), torch.ones_like(x_0))
    f_minus = torch.where(x_0 > -1.0, p.cdf(x_0 - 1.0 / 255.0), torch.zeros_like(x_0))
    return -torch.log(torch.clamp(f_plus - f_minus, min=1e-12))


def true_reverse_process(x_t, x_0, beta_t, alpha_t, alpha_bar_t,
                         alpha_bar_t_minus_one) -> Gaussian:
    """The forward-process posterior q(x_{t−1} | x_t, x_0)."""
    mean = (
        torch.sqrt(alpha_bar_t_minus_one) * beta_t / (1.0 - alpha_bar_t) * x_0
        + torch.sqrt(alpha_t) * (1.0 - alpha_bar_t_minus_one) / (1.0 - alpha_bar_t) * x_t
    )
    variance = (1.0 - alpha_bar_t_minus_one) / (1.0 - alpha_bar_t) * beta_t
    return Gaussian(mean, torch.sqrt(variance).expand_as(mean))


def beta_tilde(beta_t, alpha_bar_t, alpha_bar_t_minus_one):
    """Posterior variance β̃_t = (1 − ᾱ_{t−1})/(1 − ᾱ_t) · β_t."""
    return (1.0 - alpha_bar_t_minus_one) / (1.0 - alpha_bar_t) * beta_t


def interpolate_variance(v, beta_t, beta_tilde_t):
    """Σ_θ = exp(v · log β_t + (1 − v) · log β̃_t).

    The log-variance is clamped to [−87, 80], the finite range of the f32
    exp: at t == 1 log β̃ is the −27.6 floor, so |v| ≈ 4 already overflows,
    and an inf there makes the backward NaN even under a zero cotangent."""
    log_var = v * torch.log(beta_t) + (1.0 - v) * torch.log(torch.clamp(beta_tilde_t, min=1e-12))
    return torch.exp(torch.clamp(log_var, -87.0, 80.0))


def loss_vlb(noise_in_x_t, variance, x_t, t, x_0, beta_t, alpha_t, alpha_bar_t,
             alpha_bar_t_minus_one) -> torch.Tensor:
    """L_vlb with ε_θ detached, so only the variance head learns from it.

    ``t`` is (N,); the per-sample constants broadcast as (N, 1, 1, 1)."""
    # floor before the sqrt: sqrt(0) has an infinite derivative
    variance = torch.clamp(variance, min=1e-20)
    p = eq_ddpm.reverse_process(x_t, beta_t, alpha_t, alpha_bar_t, noise_in_x_t.detach(),
                                variance)
    # t == 1: the discretized NLL of the data under p_θ(x_0 | x_1)
    nll = discrete_nll_loss(x_0, p)
    # t > 1: KL(q(x_{t−1} | x_t, x_0) || p_θ(x_{t−1} | x_t)); q's std is 0 at
    # t == 1, so it is floored for the branch the where discards
    q = true_reverse_process(x_t, x_0, beta_t, alpha_t, alpha_bar_t, alpha_bar_t_minus_one)
    kl = kl_divergence(Gaussian(q.mean, torch.clamp(q.std, min=1e-10)), p)
    is_t1 = (t == 1).reshape((-1,) + (1,) * (x_0.dim() - 1))
    return torch.mean(torch.where(is_t1, nll, kl))
