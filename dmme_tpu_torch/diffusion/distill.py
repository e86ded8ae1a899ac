"""Progressive distillation: halve the sampling steps each round (mirrors
``dmme_tpu/diffusion/distill.py``; Salimans & Ho 2022).

A teacher that samples in 2N deterministic DDIM steps is distilled into a
student that samples in N: the student's one step t → t_prev must land where
the teacher's two steps t → t_mid → t_prev land. The target is the x̃₀ whose
one-step DDIM update from x_t reproduces the teacher's endpoint, trained
with the truncated-SNR weight max(SNR, 1)·‖x̂₀ − x̃₀‖². The teacher runs
without gradient (JAX's ``stop_gradient``), so a UNet teacher takes the
fused ResBlock kernel. Both the teacher and the student may be ε- or
v-parameterised; the student should be v (x₀ from ε is ill-conditioned at
high noise).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from dmme_tpu_torch import equations as eq
from dmme_tpu_torch.diffusion.ddim import DDIM
from dmme_tpu_torch.diffusion.ddpm import _bcast
from dmme_tpu_torch.equations.ddpm import Schedule

ModelFn = Callable[..., torch.Tensor]


def _alpha_sigma(schedule: Schedule, t: torch.Tensor, ndim: int):
    ab = _bcast(schedule.alpha_bar[t], ndim)
    return torch.sqrt(ab), torch.sqrt(1.0 - ab), ab


def _to_x0(out, x_t, alpha, sigma, ab, parameterization: str) -> torch.Tensor:
    """Network output → x̂₀ under ``parameterization``."""
    if parameterization == "v":
        return alpha * x_t - sigma * out
    return (x_t - sigma * out) / torch.clamp(alpha, min=1e-20)


def ddim_step_from_x0(x_t, x0_hat, alpha_t, sigma_t, alpha_prev, sigma_prev) -> torch.Tensor:
    """The canonical η = 0 DDIM update in x₀ form: x_prev = α_prev·x̂₀ +
    σ_prev·ε̂ with ε̂ = (x_t − α_t·x̂₀)/σ_t."""
    eps_hat = (x_t - alpha_t * x0_hat) / torch.clamp(sigma_t, min=1e-20)
    return alpha_prev * x0_hat + sigma_prev * eps_hat


@dataclasses.dataclass(frozen=True)
class ProgressiveDistillation:
    """One round: the teacher on a 2N-step τ grid, the student on N. The
    student's τ is the teacher's every other point, so each student step
    spans exactly two teacher steps."""

    schedule: Schedule
    teacher_tau: torch.Tensor  # (2N+1,) int64
    student_tau: torch.Tensor  # (N+1,) int64
    timesteps: int = 1000
    student_steps: int = 512
    teacher_parameterization: str = "v"
    student_parameterization: str = "v"

    @classmethod
    def create(cls, timesteps: int = 1000, student_steps: int = 512, start: float = 0.0001,
               end: float = 0.02, teacher_parameterization: str = "v",
               student_parameterization: str = "v",
               schedule: Optional[Schedule] = None) -> "ProgressiveDistillation":
        assert student_steps >= 1
        # with 2N > T the linear grid repeats τ values and the teacher's two
        # steps degenerate to one there
        assert 2 * student_steps <= timesteps, (
            f"teacher grid 2·{student_steps} exceeds timesteps={timesteps}; "
            f"start distillation at student_steps <= timesteps // 2")
        if schedule is None:
            schedule = eq.ddpm.schedule_from_beta(eq.ddpm.linear_schedule(timesteps, start, end))
        teacher_tau = eq.ddim.linear_tau(timesteps, 2 * student_steps)
        return cls(schedule=schedule, teacher_tau=teacher_tau, student_tau=teacher_tau[::2],
                   timesteps=timesteps, student_steps=student_steps,
                   teacher_parameterization=teacher_parameterization,
                   student_parameterization=student_parameterization)

    def to(self, device) -> "ProgressiveDistillation":
        """This round with its tables on ``device``."""
        return dataclasses.replace(self, schedule=self.schedule.to(device),
                                   teacher_tau=self.teacher_tau.to(device),
                                   student_tau=self.student_tau.to(device))

    @torch.no_grad()
    def teacher_target_x0(self, teacher_fn: ModelFn, teacher_params: Any, x_t: torch.Tensor,
                          i: torch.Tensor) -> torch.Tensor:
        """x̃₀ such that one student DDIM step from (x_t, τ_s[i]) lands on the
        teacher's two-step endpoint (paper eq. 9 on the discrete grid)."""
        algo = self.to(x_t.device)
        i = i.to(x_t.device)
        ndim = x_t.dim()
        t, t_mid, t_prev = algo.student_tau[i], algo.teacher_tau[2 * i - 1], algo.student_tau[i - 1]
        a_t, s_t, ab_t = _alpha_sigma(algo.schedule, t, ndim)
        a_m, s_m, ab_m = _alpha_sigma(algo.schedule, t_mid, ndim)
        a_p, s_p, _ = _alpha_sigma(algo.schedule, t_prev, ndim)

        out1 = teacher_fn(teacher_params, x_t, t).to(x_t.dtype)
        x0_1 = _to_x0(out1, x_t, a_t, s_t, ab_t, self.teacher_parameterization)
        x_mid = ddim_step_from_x0(x_t, x0_1, a_t, s_t, a_m, s_m)

        out2 = teacher_fn(teacher_params, x_mid, t_mid).to(x_t.dtype)
        x0_2 = _to_x0(out2, x_mid, a_m, s_m, ab_m, self.teacher_parameterization)
        x_pp = ddim_step_from_x0(x_mid, x0_2, a_m, s_m, a_p, s_p)

        # invert the one-step update: x_pp = α_p·x̃₀ + (σ_p/σ_t)(x_t − α_t·x̃₀)
        ratio = s_p / torch.clamp(s_t, min=1e-20)
        denom = a_p - ratio * a_t
        return (x_pp - ratio * x_t) / torch.clamp(denom, min=1e-20)

    def loss_given(self, teacher_fn: ModelFn, teacher_params: Any, student_fn: ModelFn,
                   student_params: Any, x_0: torch.Tensor, i: torch.Tensor,
                   noise: torch.Tensor, *, train: bool = False,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The truncated-SNR-weighted x₀ regression with injected student grid
        indices ``i`` (N,) in [1, N] and noise; the student's dropout, with
        ``train``, is drawn from ``generator``."""
        algo = self.to(x_0.device)
        i = i.to(x_0.device)
        ndim = x_0.dim()
        t = algo.student_tau[i]
        a_t, s_t, ab_t = _alpha_sigma(algo.schedule, t, ndim)
        x_t = eq.ddpm.q_sample(x_0, ab_t, noise)

        x0_target = self.teacher_target_x0(teacher_fn, teacher_params, x_t, i)
        out = student_fn(student_params, x_t, t, train=train, generator=generator)
        x0_hat = _to_x0(out.to(x_0.dtype), x_t, a_t, s_t, ab_t, self.student_parameterization)
        w = torch.clamp(ab_t / torch.clamp(1.0 - ab_t, min=1e-20), min=1.0)  # max(SNR, 1)
        return torch.mean(w * torch.square(x0_hat - x0_target))

    def loss(self, teacher_fn: ModelFn, teacher_params: Any, student_fn: ModelFn,
             student_params: Any, generator: torch.Generator, x_0: torch.Tensor, *,
             train: bool = True) -> torch.Tensor:
        """:meth:`loss_given` with i ~ Uniform{1, …, N}, then ε, then the
        student's dropout drawn from ``generator``, in that order (JAX's
        key split)."""
        i = torch.randint(1, self.student_steps + 1, (x_0.shape[0],), generator=generator,
                          device=generator.device)
        noise = torch.randn(x_0.shape, generator=generator, dtype=x_0.dtype,
                            device=generator.device)
        return self.loss_given(teacher_fn, teacher_params, student_fn, student_params, x_0, i,
                               noise, train=train, generator=generator)

    def student_sampler(self) -> DDIM:
        """The N-step DDIM on the student grid: canonical, η = 0, the
        student's parameterization."""
        return DDIM(schedule=self.schedule, timesteps=self.timesteps, tau=self.student_tau,
                    sub_timesteps=self.student_steps, eta=0.0, variant="canonical",
                    parameterization=self.student_parameterization)

    def next_round(self) -> "ProgressiveDistillation":
        """The student becomes the teacher; the steps halve (N must be even)."""
        assert self.student_steps % 2 == 0, self.student_steps
        return ProgressiveDistillation(
            schedule=self.schedule, teacher_tau=self.student_tau,
            student_tau=self.student_tau[::2], timesteps=self.timesteps,
            student_steps=self.student_steps // 2,
            teacher_parameterization=self.student_parameterization,
            student_parameterization=self.student_parameterization)
