"""Flow-matching equations (mirrors ``dmme_tpu/equations/flow.py``; Lipman et
al. 2023, arXiv:2210.02747; rectified flow, Liu et al. 2022,
arXiv:2209.03003).

A velocity field v_θ(x_t, t) is regressed onto the straight path's

    x_t = (1 − t)·x₀ + t·x₁,  t ∈ [0, 1],  x₁ ~ N(0, I),   v* = x₁ − x₀

(t = 0 is data, t = 1 is noise), and sampling integrates dx/dt = v_θ from
t = 1 down to t = 0. Every function is pure and float32.
"""

from __future__ import annotations

import torch


def _bcast(a: torch.Tensor, ndim: int) -> torch.Tensor:
    return a.reshape(a.shape + (1,) * (ndim - a.dim()))


def interpolate(x0: torch.Tensor, x1: torch.Tensor, t) -> torch.Tensor:
    """x_t = (1 − t)·x₀ + t·x₁ for a scalar or (N,) ``t``."""
    t = _bcast(torch.as_tensor(t, dtype=x0.dtype, device=x0.device), x0.dim())
    return (1.0 - t) * x0 + t * x1


def velocity_target(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """The straight path's velocity dx_t/dt = x₁ − x₀, constant in t."""
    return x1 - x0


def sample_t_uniform(generator: torch.Generator, batch: int) -> torch.Tensor:
    """t ~ U(0, 1), (batch,) float32 on the generator's device."""
    return torch.rand((batch,), generator=generator, dtype=torch.float32,
                      device=generator.device)


def sample_t_logit_normal(generator: torch.Generator, batch: int, mean: float = 0.0,
                          std: float = 1.0) -> torch.Tensor:
    """t = sigmoid(z), z ~ N(mean, std²): SD3's density (Esser et al. 2024,
    arXiv:2403.03206 §3.1), which trains most at mid-path."""
    z = torch.randn((batch,), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return torch.sigmoid(mean + std * z)


def shift_time(t, shift: float) -> torch.Tensor:
    """SD3's resolution shift t ↦ s·t/(1 + (s − 1)·t) (eq. 23): monotone on
    [0, 1], both ends fixed, s = 1 the identity."""
    t = torch.as_tensor(t, dtype=torch.float32)
    return shift * t / (1.0 + (shift - 1.0) * t)


def time_grid(steps: int, shift: float = 1.0) -> torch.Tensor:
    """Integration grid t_0 = 1 > … > t_N = 0, shape ``(steps + 1,)``:
    uniform in t, then shifted."""
    t = torch.linspace(1.0, 0.0, steps + 1, dtype=torch.float32)
    return shift_time(t, shift) if shift != 1.0 else t
