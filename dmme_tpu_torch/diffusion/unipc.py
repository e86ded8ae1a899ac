"""UniPC-style predictor–corrector multistep ODE sampler (mirrors
``dmme_tpu/diffusion/unipc.py``; Zhao et al. 2023, arXiv:2302.04867).

From the variation-of-constants solution in λ = log(α/σ),

    x_t = (σ_t/σ_s)·x_s + σ_t ∫_{λ_s}^{λ_t} e^λ · x̂₀(λ) dλ,

x̂₀ is fitted by a line through known nodes and the e^λ kernel integrated
exactly. The predictor takes the line through the two latest evaluations;
the corrector, once the network has been evaluated at the predicted point,
re-integrates the step that produced it through both of its endpoints. One
network evaluation a step. The first step, the last (τ = 0) and a step after
a zero λ-gap take the first-order update; a repeated τ entry is an identity.

A Python loop over the τ table, where JAX scans, with the per-step scalars
as f32 0-d tensors on the host (see :mod:`.dpm_solver`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from dmme_tpu_torch import equations as eq
from dmme_tpu_torch.diffusion.ddpm import HistoryCapture, ModelFn, _start
from dmme_tpu_torch.diffusion.dpm_solver import default_schedule, predict_x0
from dmme_tpu_torch.equations.ddpm import Schedule


def kernel_moments(h: torch.Tensor):
    """(M0, M1) = ∫_{−h}^{0} e^u du and ∫_{−h}^{0} u·e^u du, the exact e^λ
    kernel moments over one step, offsets from the step's target λ."""
    emh = torch.exp(-h)
    return 1.0 - emh, -1.0 + (h + 1.0) * emh


@dataclasses.dataclass(frozen=True)
class UniPC:
    """Predictor–corrector multistep solver over a discrete ᾱ schedule."""

    schedule: Schedule
    tau: torch.Tensor  # (S+1,) int64, τ_0 = 0
    timesteps: int = 1000
    sub_timesteps: int = 10
    order: int = 2
    #: apply the corrector (elementwise work only, no extra evaluation)
    corrector: bool = True
    #: "eps" or "v": the network's output convention
    parameterization: str = "eps"
    #: clamp x̂₀ to [−1, 1] (set by the factory on cosine schedules)
    clip_x0: bool = False

    @classmethod
    def create(cls, timesteps: int = 1000, sub_timesteps: int = 10,
               tau_schedule: str = "quadratic", order: int = 2, corrector: bool = True,
               start: float = 0.0001, end: float = 0.02, schedule: Optional[Schedule] = None,
               parameterization: str = "eps") -> "UniPC":
        if order not in (1, 2) or parameterization not in ("eps", "v"):
            raise ValueError(f"order {order} / parameterization {parameterization!r}")
        schedule = default_schedule(schedule, timesteps, start, end)
        return cls(schedule=schedule,
                   tau=eq.ddim.make_tau(tau_schedule, timesteps, sub_timesteps,
                                        schedule.alpha_bar),
                   timesteps=timesteps, sub_timesteps=sub_timesteps, order=order,
                   corrector=corrector, parameterization=parameterization)

    @torch.no_grad()
    def generate(self, model_fn: ModelFn, params: Any, generator: Optional[torch.Generator],
                 img_shape: Tuple[int, ...], *, x_T: Optional[torch.Tensor] = None,
                 history_length: Optional[int] = None):
        """x_T (drawn from ``generator`` on its device unless given) → x_0 in
        ``sub_timesteps`` network evaluations; with ``history_length``,
        ``(x_0, history)`` as :meth:`DDPM.generate` returns it."""
        x_pred = _start(img_shape, generator, x_T)
        capture = None if history_length is None else HistoryCapture(self.sub_timesteps,
                                                                     history_length, x_pred)
        alpha_bar = self.schedule.alpha_bar.cpu()
        tau = self.tau.tolist()
        tiny = 1e-38
        x_anchor, d_prev = x_pred, torch.zeros_like(x_pred)
        lam_prev, s_prev, have = torch.tensor(0.0), torch.tensor(1.0), False
        for k, i in enumerate(range(self.sub_timesteps, 0, -1)):
            t_cur, t_next = tau[i], tau[i - 1]
            a_c, s_c, lam_c = eq.ddim.lambda_coeffs(alpha_bar, t_cur)
            a_n, s_n, lam_n = eq.ddim.lambda_coeffs(alpha_bar, t_next)
            d_cur = predict_x0(model_fn, params, x_pred, t_cur, a_c, s_c,
                               self.parameterization, self.clip_x0)

            # corrector: re-integrate the step that produced x_pred through
            # both of its endpoints. Not on the first step (no anchor), after
            # a repeated τ (hc == 0), nor at τ = 0 (σ = 0 makes d_cur NaN)
            hc = lam_c - lam_prev
            x_cur = x_pred
            if self.corrector and have and float(hc) > 0.0 and t_cur != 0:
                m0c, m1c = kernel_moments(hc)
                slope_c = (d_cur - d_prev) / torch.clamp(hc, min=tiny)
                x_cur = (s_c / torch.clamp(s_prev, min=tiny)) * x_anchor + a_c * (
                    d_cur * m0c + slope_c * m1c)

            # predictor to t_next
            h = lam_n - lam_c
            m0, m1 = kernel_moments(h)
            gap = lam_c - lam_prev
            if t_cur == t_next:
                x_next = x_cur  # a repeated τ entry: h == 0, an identity step
            else:
                x_next = (s_n / torch.clamp(s_c, min=tiny)) * x_cur + a_n * (d_cur * m0)
                if self.order == 2 and have and t_next != 0 and float(gap) > 0.0:
                    # linear x̂₀ through (λ_c, d_cur) and (λ_prev, d_prev)
                    slope = (d_cur - d_prev) / torch.clamp(gap, min=tiny)
                    x_next = x_next + a_n * slope * (m1 + h * m0)

            x_pred, x_anchor, d_prev, lam_prev, s_prev, have = (x_next, x_cur, d_cur, lam_c,
                                                                 s_c, True)
            if capture is not None:
                capture(k, x_pred)
        return x_pred if capture is None else (x_pred, capture.frames)
