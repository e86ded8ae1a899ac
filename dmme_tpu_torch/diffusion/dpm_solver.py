"""DPM-Solver++(2M), the second-order multistep ODE sampler (mirrors
``dmme_tpu/diffusion/dpm_solver.py``; Lu et al. 2022, arXiv:2211.01095).

It integrates the probability-flow ODE in λ = log(α/σ) with a multistep
update on the data prediction x̂₀, over a τ sub-sequence of the trained
length-(T+1) schedule; α_t = √ᾱ_t, σ_t = √(1−ᾱ_t). order=1 is the canonical
η = 0 DDIM update. The first step (no history) and the last (λ₀ is huge,
σ₀ = 0) take the first-order update; a repeated τ entry is an identity step.

The trajectory is a Python loop over the τ table, where JAX scans. The
per-step scalars are f32 0-d tensors computed on the host from the
schedule, as JAX computes them in f32; only the images live on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from dmme_tpu_torch import equations as eq
from dmme_tpu_torch.diffusion.ddpm import HistoryCapture, ModelFn, _start
from dmme_tpu_torch.equations.ddpm import Schedule


def default_schedule(schedule: Optional[Schedule], timesteps: int, start: float,
                     end: float) -> Schedule:
    """``schedule``, or the linear β schedule when none is given."""
    if schedule is not None:
        return schedule
    return eq.ddpm.schedule_from_beta(eq.ddpm.linear_schedule(timesteps, start, end))


def predict_x0(model_fn: ModelFn, params: Any, x: torch.Tensor, t: int, alpha_t, sigma_t,
               parameterization: str, clip_x0: bool) -> torch.Tensor:
    """x̂₀ = (x − σ_t·ε̂)/α_t from the network at timestep ``t``, in f32,
    clamped to [−1, 1] with ``clip_x0``."""
    t_vec = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
    out = model_fn(params, x, t_vec).to(torch.float32)
    if parameterization == "v":
        out = eq.ddpm.eps_from_v(out, x, torch.square(alpha_t))
    x0 = (x - sigma_t * out) / alpha_t
    return torch.clamp(x0, -1.0, 1.0) if clip_x0 else x0


@dataclasses.dataclass(frozen=True)
class DPMSolverPP:
    """DPM-Solver++(2M) over a discrete ᾱ schedule."""

    schedule: Schedule
    tau: torch.Tensor  # (S+1,) int64, τ_0 = 0
    timesteps: int = 1000
    sub_timesteps: int = 20
    order: int = 2
    #: "eps" or "v": the network's output convention
    parameterization: str = "eps"
    #: clamp x̂₀ to [−1, 1]; needed by cosine schedules, whose ᾱ_T ≈ 2e-15
    #: makes the x̂₀ division explode at t = T
    clip_x0: bool = False

    @classmethod
    def create(cls, timesteps: int = 1000, sub_timesteps: int = 20,
               tau_schedule: str = "quadratic", order: int = 2, start: float = 0.0001,
               end: float = 0.02, schedule: Optional[Schedule] = None,
               parameterization: str = "eps") -> "DPMSolverPP":
        if order not in (1, 2) or parameterization not in ("eps", "v"):
            raise ValueError(f"order {order} / parameterization {parameterization!r}")
        schedule = default_schedule(schedule, timesteps, start, end)
        return cls(schedule=schedule,
                   tau=eq.ddim.make_tau(tau_schedule, timesteps, sub_timesteps,
                                        schedule.alpha_bar),
                   timesteps=timesteps, sub_timesteps=sub_timesteps, order=order,
                   parameterization=parameterization)

    @torch.no_grad()
    def generate(self, model_fn: ModelFn, params: Any, generator: Optional[torch.Generator],
                 img_shape: Tuple[int, ...], *, x_T: Optional[torch.Tensor] = None,
                 history_length: Optional[int] = None):
        """x_T (drawn from ``generator`` on its device unless given) → x_0 in
        ``sub_timesteps`` network evaluations; with ``history_length``,
        ``(x_0, history)`` as :meth:`DDPM.generate` returns it."""
        x = _start(img_shape, generator, x_T)
        capture = None if history_length is None else HistoryCapture(self.sub_timesteps,
                                                                     history_length, x)
        alpha_bar = self.schedule.alpha_bar.cpu()
        tau = self.tau.tolist()
        prev_x0, prev_h = torch.zeros_like(x), torch.tensor(0.0)
        for k, i in enumerate(range(self.sub_timesteps, 0, -1)):
            t, t_prev = tau[i], tau[i - 1]
            a_t, s_t, lam_t = eq.ddim.lambda_coeffs(alpha_bar, t)
            a_p, s_p, lam_p = eq.ddim.lambda_coeffs(alpha_bar, t_prev)
            x0 = predict_x0(model_fn, params, x, t, a_t, s_t, self.parameterization,
                            self.clip_x0)
            h = lam_p - lam_t  # > 0; huge on the final step
            ratio = torch.exp(-h)  # = (α_t σ_p)/(α_p σ_t)
            if t == t_prev:
                # a repeated τ entry: s_p/s_t = 0/0, the step is an identity
                new_x = x
            elif self.order == 1 or float(prev_h) == 0.0 or t_prev == 0:
                new_x = (s_p / s_t) * x - a_p * (ratio - 1.0) * x0
            else:
                c = 1.0 / (2.0 * torch.clamp(prev_h / h, min=1e-38))
                d = (1.0 + c) * x0 - c * prev_x0
                new_x = (s_p / s_t) * x - a_p * (ratio - 1.0) * d
            x, prev_x0, prev_h = new_x, x0, h
            if capture is not None:
                capture(k, x)
        return x if capture is None else (x, capture.frames)
