"""Classifier guidance (mirrors ``dmme_tpu/diffusion/guidance.py``).

A noisy classifier p_φ(y | x_t, t) (``models.adm.EncoderUNet``, trained by
``training.LitClassifier``) steers a denoiser's sampling toward labels ``y``
through its gradient ∇ₓ log p_φ(y | x, t), taken with ``torch.autograd``
inside the step. The samplers run under ``torch.no_grad()``;
:func:`classifier_grad` opens ``torch.enable_grad()`` for the classifier
alone, and the denoiser call stays without grad. Nothing here may run under
``torch.inference_mode()``, whose tensors cannot enter autograd.

The label of each sample is its own (``log_probs[arange(N), y]``), as in
JAX. Both ``create``s build a linear-β schedule whatever the denoiser was
trained on, as JAX's do; a denoiser trained on another schedule is sampled
by building the dataclass with that schedule
(``dataclasses.replace(algo, schedule=...)``, JAX's ``.replace``). The
samplers take an ε model function: drive a variance-learning model (ADM's
ε ‖ v output) through ``models.eps_only``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from dmme_tpu_torch.diffusion.ddim import DDIM
from dmme_tpu_torch.diffusion.ddpm import DDPM, ModelFn, _bcast, _start, _timesteps


def classifier_grad(classifier_fn: ModelFn, classifier_params: Any, y, x_t: torch.Tensor,
                    t: torch.Tensor) -> torch.Tensor:
    """∇_{x_t} Σₙ log_softmax(classifier_fn(params, x_t, t))[n, yₙ], in
    x_t's dtype. The log-softmax runs in the logits' dtype (the classifier's
    compute dtype), as in JAX; works inside a ``torch.no_grad()`` sampler."""
    y = torch.as_tensor(y, dtype=torch.int64, device=x_t.device).reshape(x_t.shape[0])
    with torch.enable_grad():
        x = x_t.detach().requires_grad_(True)
        log_probs = torch.log_softmax(classifier_fn(classifier_params, x, t), dim=-1)
        picked = torch.gather(log_probs, -1, y[:, None])
        (grad,) = torch.autograd.grad(torch.sum(picked), x)
    return grad


@dataclasses.dataclass(frozen=True)
class ClassifierGuidedDDPM(DDPM):
    """DDPM ancestral sampling nudged by a noisy classifier: one reverse
    step, then x += s·∇ log p_φ(y | x, t) at the new x and the same t."""

    guidance_scale: float = 10.0

    @classmethod
    def create(cls, timesteps: int = 1000, guidance_scale: float = 10.0,
               start: float = 0.0001, end: float = 0.02) -> "ClassifierGuidedDDPM":
        base = DDPM.create(timesteps, start, end)
        return cls(schedule=base.schedule, timesteps=timesteps, guidance_scale=guidance_scale)

    def guided_sampling_step(self, model_fn: ModelFn, params: Any, classifier_fn: ModelFn,
                             classifier_params: Any, y, x_t: torch.Tensor, t,
                             generator: Optional[torch.Generator] = None,
                             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One guided step x_t → x_{t−1}; ``noise`` replaces the step's draw
        from ``generator``."""
        t_vec = _timesteps(t, x_t)
        x = self.sampling_step(model_fn, params, x_t, t_vec, generator, noise)
        grad = classifier_grad(classifier_fn, classifier_params, y, x, t_vec)
        return x + self.guidance_scale * grad

    @torch.no_grad()
    def guided_generate(self, model_fn: ModelFn, params: Any, classifier_fn: ModelFn,
                        classifier_params: Any, y, generator: Optional[torch.Generator],
                        img_shape: Tuple[int, ...], *,
                        x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The guided reverse process from x_T (drawn from ``generator`` on
        its device unless given), then each step's noise from ``generator``."""
        x = _start(img_shape, generator, x_T)
        algo = self.to(x.device)
        for t in range(self.timesteps, 0, -1):
            x = algo.guided_sampling_step(model_fn, params, classifier_fn, classifier_params, y,
                                          x, t, generator)
        return x


@dataclasses.dataclass(frozen=True)
class ClassifierGuidedDDIM(DDIM):
    """Deterministic DDIM (η = 0, canonical) with a classifier-corrected ε:
    ε̂ = ε_θ(x, τᵢ) − √(1−ᾱ_τᵢ)·s·∇ log p_φ(y | x, τᵢ), then x̂₀ and the
    direction term, unclipped."""

    guidance_scale: float = 10.0

    @classmethod
    def create(cls, timesteps: int = 1000, sub_timesteps: int = 50,
               tau_schedule: str = "quadratic",
               guidance_scale: float = 10.0) -> "ClassifierGuidedDDIM":
        base = DDIM.create(timesteps, sub_timesteps, tau_schedule)
        return cls(schedule=base.schedule, timesteps=timesteps, tau=base.tau,
                   sub_timesteps=sub_timesteps, eta=0.0, variant="canonical",
                   guidance_scale=guidance_scale)

    def guided_sampling_step(self, model_fn: ModelFn, params: Any, classifier_fn: ModelFn,
                             classifier_params: Any, y, x: torch.Tensor, i) -> torch.Tensor:
        """One guided step x_{τᵢ} → x_{τᵢ₋₁}; ``i`` indexes the τ table."""
        algo = self.to(x.device)
        i = _timesteps(i, x)
        tau_i = algo.tau[i]
        ab_t = _bcast(algo.schedule.alpha_bar[tau_i], x.dim())
        ab_prev = _bcast(algo.schedule.alpha_bar[algo.tau[i - 1]], x.dim())
        grad = classifier_grad(classifier_fn, classifier_params, y, x, tau_i)
        eps = model_fn(params, x, tau_i).to(x.dtype)
        eps = eps - torch.sqrt(1.0 - ab_t) * self.guidance_scale * grad
        x0 = (x - torch.sqrt(1.0 - ab_t) * eps) * torch.rsqrt(ab_t)
        return torch.sqrt(ab_prev) * x0 + torch.sqrt(1.0 - ab_prev) * eps

    @torch.no_grad()
    def guided_generate(self, model_fn: ModelFn, params: Any, classifier_fn: ModelFn,
                        classifier_params: Any, y, generator: Optional[torch.Generator],
                        img_shape: Tuple[int, ...], *,
                        x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
        """S guided steps from x_T (drawn from ``generator`` unless given)."""
        x = _start(img_shape, generator, x_T)
        algo = self.to(x.device)
        for i in range(self.sub_timesteps, 0, -1):
            x = algo.guided_sampling_step(model_fn, params, classifier_fn, classifier_params, y,
                                          x, i)
        return x
