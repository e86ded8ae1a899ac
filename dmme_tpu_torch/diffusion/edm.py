"""EDM: continuous-σ diffusion with the preconditioned denoiser and Heun's
second-order sampler (mirrors ``dmme_tpu/diffusion/edm.py``; Karras et al.
2022, arXiv:2206.00364, Algorithm 2).

The denoiser network is the UNet of the discrete algorithms, conditioned on
the float c_noise(σ) = ¼·ln σ through its sinusoidal time embedding. The
preconditioning coefficients and the combination c_skip·x + c_out·F are
float32 on the device; the network output is cast back to the state's dtype
first, as in JAX.

Sampling is a Python loop over the σ grid, where JAX scans. The grid lives
on the host, so the choices JAX makes on the device (churn or not; Heun's
corrector skipped on the last, σ → 0 step) are host branches that cost no
device sync. Cost: 2·steps − 1 network evaluations; ``order=1`` (Euler)
takes ``steps``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from dmme_tpu_torch import equations as eq
from dmme_tpu_torch.diffusion.ddpm import HistoryCapture, ModelFn, _bcast


def _per_sample(value, x: torch.Tensor) -> torch.Tensor:
    """A scalar (a float or a 0-d tensor) or an (N,) tensor as an (N,) float32
    tensor on x's device."""
    if isinstance(value, torch.Tensor) and value.dim() > 0:
        return value.to(device=x.device, dtype=torch.float32).expand(x.shape[0])
    return torch.full((x.shape[0],), float(value), dtype=torch.float32, device=x.device)


@dataclasses.dataclass(frozen=True)
class EDM:
    """EDM training and Heun sampling over continuous noise levels: the
    paper's Table 1 "EDM" column, deterministic (``s_churn = 0``) unless
    ``s_churn > 0`` asks for the stochastic sampler (paper §4)."""

    sigmas: torch.Tensor  # (steps+1,) float32 Karras grid on the CPU, last entry 0
    sigma_data: float = 0.5
    #: grid-shape exponent, kept so that the grid can be rebuilt at another
    #: step count over the same σ range (diffusion/factory.py)
    rho: float = 7.0
    p_mean: float = -1.2
    p_std: float = 1.2
    steps: int = 18
    order: int = 2
    s_churn: float = 0.0
    s_min: float = 0.0
    s_max: float = float("inf")
    s_noise: float = 1.0

    @classmethod
    def create(cls, steps: int = 18, sigma_min: float = 0.002, sigma_max: float = 80.0,
               rho: float = 7.0, sigma_data: float = 0.5, p_mean: float = -1.2,
               p_std: float = 1.2, order: int = 2, s_churn: float = 0.0, s_min: float = 0.0,
               s_max: float = float("inf"), s_noise: float = 1.0) -> "EDM":
        if order not in (1, 2):
            raise ValueError(f"order must be 1 or 2, got {order}")
        return cls(sigmas=eq.edm.karras_sigmas(steps, sigma_min, sigma_max, rho),
                   sigma_data=sigma_data, rho=rho, p_mean=p_mean, p_std=p_std, steps=steps,
                   order=order, s_churn=s_churn, s_min=s_min, s_max=s_max, s_noise=s_noise)

    # --------------------------------------------------------------- denoiser
    def denoise(self, model_fn: ModelFn, params: Any, x: torch.Tensor, sigma, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """D_θ(x; σ) = c_skip·x + c_out·F_θ(c_in·x, c_noise) (paper eq. 7);
        ``sigma`` is a scalar or (N,)."""
        c = eq.edm.precond(_per_sample(sigma, x), self.sigma_data)
        f = model_fn(params, _bcast(c.c_in, x.dim()) * x, c.c_noise, train=train,
                     generator=generator).to(x.dtype)
        return _bcast(c.c_skip, x.dim()) * x + _bcast(c.c_out, x.dim()) * f

    # ------------------------------------------------------------------ train
    def loss(self, model_fn: ModelFn, params: Any, generator: torch.Generator,
             x_0: torch.Tensor, *, train: bool = True) -> torch.Tensor:
        """E[λ(σ)·‖D(x₀ + n; σ) − x₀‖²] with ln σ ~ N(P_mean, P_std²) (paper
        eq. 8): σ, then n, then the model's dropout drawn from ``generator``."""
        sigma = eq.edm.sample_sigma_lognormal(generator, x_0.shape[0], self.p_mean, self.p_std)
        noise = torch.randn(x_0.shape, generator=generator, dtype=x_0.dtype,
                            device=generator.device)
        return self.loss_given(model_fn, params, x_0, sigma, noise, train=train,
                               generator=generator)

    def loss_given(self, model_fn: ModelFn, params: Any, x_0: torch.Tensor,
                   sigma: torch.Tensor, noise: torch.Tensor, *, train: bool = False,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The loss with injected (N,) σ and unit noise: the deterministic
        core of :meth:`loss`, the entry the parity tests drive."""
        x_sig = x_0 + _bcast(sigma, x_0.dim()) * noise
        d = self.denoise(model_fn, params, x_sig, sigma, train=train, generator=generator)
        w = _bcast(eq.edm.loss_weight(sigma, self.sigma_data), x_0.dim())
        return torch.mean(w * torch.square(d - x_0.to(d.dtype)))

    # ----------------------------------------------------------------- sample
    def sampling_step(self, model_fn: ModelFn, params: Any, x: torch.Tensor, i: int,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One Heun step σ_i → σ_{i+1} (Algorithm 2, lines 3–9), with the
        churn of lines 4–6 where ``s_churn > 0`` and s_min ≤ σ_i ≤ s_max; its
        unit noise is ``noise`` or a draw from ``generator``."""
        sig, sig_next = self.sigmas[i], self.sigmas[i + 1]
        gamma = 0.0
        if self.s_min <= float(sig) <= self.s_max:
            gamma = min(self.s_churn / self.steps, math.sqrt(2.0) - 1.0)
        sig_hat = sig * (1.0 + gamma)
        x_hat = x
        if gamma > 0.0:
            if noise is None:
                noise = torch.randn(x.shape, generator=generator, dtype=torch.float32,
                                    device=x.device)
            x_hat = x + torch.sqrt(torch.clamp(sig_hat ** 2 - sig ** 2, min=0.0)) * (
                self.s_noise * noise)

        d = (x_hat - self.denoise(model_fn, params, x_hat, sig_hat)) / sig_hat
        x_euler = x_hat + (sig_next - sig_hat) * d
        # the last step (σ_next = 0) is Euler's: D(x; 0) lies outside the
        # trained σ range, and d2 would divide by zero
        if self.order == 1 or float(sig_next) <= 0.0:
            return x_euler
        d2 = (x_euler - self.denoise(model_fn, params, x_euler, sig_next)) / sig_next
        return x_hat + (sig_next - sig_hat) * 0.5 * (d + d2)

    @torch.no_grad()
    def generate(self, model_fn: ModelFn, params: Any,
                 generator: Optional[torch.Generator], img_shape: Tuple[int, ...], *,
                 x_T: Optional[torch.Tensor] = None, history_length: Optional[int] = None):
        """x ~ N(0, σ_max² I) → x₀ over the σ grid. ``x_T`` is the starting
        state itself, already σ_max-scaled; else it is σ_0 times a draw from
        ``generator``. With ``history_length``, ``(x_0, history)`` as
        :meth:`DDPM.generate` returns it."""
        if x_T is not None:
            x = x_T.to(torch.float32)
        elif generator is None:
            raise ValueError("generate needs a generator or x_T")
        else:
            x = self.sigmas[0] * torch.randn(tuple(img_shape), generator=generator,
                                             dtype=torch.float32, device=generator.device)
        capture = None if history_length is None else HistoryCapture(self.steps,
                                                                     history_length, x)
        for i in range(self.steps):
            x = self.sampling_step(model_fn, params, x, i, generator)
            if capture is not None:
                capture(i, x)
        return x if capture is None else (x, capture.frames)
