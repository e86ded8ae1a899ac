"""DDPM training loss and sampling (mirrors ``dmme_tpu/diffusion/ddpm.py``).

Denoiser contract: ``model_fn(params, x, t, *, train=False, generator=None)``
returning the network output for NHWC ``x`` and integer ``t`` of shape (N,);
with ``train`` the model draws its dropout from ``generator``. The schedule
is held in float32 with the 1-based indexing of
:mod:`dmme_tpu_torch.equations.ddpm`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from dmme_tpu_torch import equations as eq
from dmme_tpu_torch.equations.ddpm import Schedule

ModelFn = Callable[..., torch.Tensor]


def _bcast(a: torch.Tensor, ndim: int) -> torch.Tensor:
    """Reshape a (N,)-vector of per-sample constants to broadcast over NHWC."""
    return a.reshape(a.shape + (1,) * (ndim - a.dim()))


def _timesteps(t, x: torch.Tensor) -> torch.Tensor:
    """``t`` (an int or a tensor) as an int64 (N,) tensor on x's device."""
    if isinstance(t, int):
        return torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
    return torch.as_tensor(t, dtype=torch.int64, device=x.device).expand(x.shape[0])


def _start(img_shape, generator: Optional[torch.Generator],
           x_T: Optional[torch.Tensor]) -> torch.Tensor:
    if x_T is not None:
        return x_T.to(torch.float32)
    if generator is None:
        raise ValueError("generate needs a generator or x_T")
    return torch.randn(tuple(img_shape), generator=generator, dtype=torch.float32,
                       device=generator.device)


def history_slots(n_steps: int, history_length: int) -> Dict[int, int]:
    """{0-based step index: frame} of the ``history_length`` contract of
    ``make_history_capture``: frames at the steps that ``jnp.linspace(0,
    n_steps − 1, history_length)`` rounds to (float32, half to even), in
    order: the final x₀ among them unless there is one frame; where two
    round to one step, the frames past the distinct steps stay zero."""
    if history_length > 1:
        # jnp.linspace as XLA compiles it, in float32: i · (stop · (1 / div))
        stop = np.float32(n_steps - 1)
        c = stop * (np.float32(1.0) / np.float32(history_length - 1))
        idx = np.append(np.arange(history_length - 1, dtype=np.float32) * c, stop)
    else:
        idx = np.zeros((history_length,), np.float32)
    idx = np.round(idx)
    return {int(k): slot for slot, k in enumerate(sorted(set(idx.astype(np.int64).tolist())))}


class HistoryCapture:
    """Frames of a trajectory as the sampler steps, into one (L, *shape)
    float32 buffer on the trajectory's device."""

    def __init__(self, n_steps: int, history_length: int, x: torch.Tensor):
        self.slots = history_slots(n_steps, history_length)
        self.frames = torch.zeros((history_length,) + tuple(x.shape), dtype=torch.float32,
                                  device=x.device)

    def __call__(self, k: int, x: torch.Tensor) -> None:
        """Keep ``x``, the state after 0-based step ``k``, if it is a frame."""
        slot = self.slots.get(k)
        if slot is not None:
            self.frames[slot] = x


@dataclasses.dataclass(frozen=True)
class DDPM:
    """Denoising Diffusion Probabilistic Model (Ho et al. 2020)."""

    schedule: Schedule
    timesteps: int = 1000
    #: network output convention: "eps" or "v" (velocity)
    parameterization: str = "eps"
    #: Min-SNR-γ loss weighting (Hang et al. 2023); None = uniform L_simple
    snr_gamma: Optional[float] = None

    @classmethod
    def create(cls, timesteps: int = 1000, start: float = 0.0001, end: float = 0.02,
               parameterization: str = "eps", snr_gamma: Optional[float] = None) -> "DDPM":
        assert parameterization in ("eps", "v"), parameterization
        beta = eq.ddpm.linear_schedule(timesteps, start, end)
        return cls(schedule=eq.ddpm.schedule_from_beta(beta), timesteps=timesteps,
                   parameterization=parameterization, snr_gamma=snr_gamma)

    def to(self, device) -> "DDPM":
        """This algorithm with its tables on ``device``."""
        return dataclasses.replace(self, schedule=self.schedule.to(device))

    def to_eps(self, out: torch.Tensor, x_t: torch.Tensor,
               alpha_bar_t: torch.Tensor) -> torch.Tensor:
        """Map the network's output to ε under the active parameterisation."""
        if self.parameterization == "v":
            return eq.ddpm.eps_from_v(out, x_t, alpha_bar_t)
        return out

    # ------------------------------------------------------------------ train
    def sample_timesteps(self, generator: torch.Generator, batch: int) -> torch.Tensor:
        """t ~ Uniform{1, …, T−1} as int64 on the generator's device (T itself
        is never drawn, as in the JAX package and its reference)."""
        return torch.randint(1, self.timesteps, (batch,), generator=generator,
                             device=generator.device)

    def loss(self, model_fn: ModelFn, params: Any, generator: torch.Generator,
             x_0: torch.Tensor, *, train: bool = True) -> torch.Tensor:
        """L_simple = E‖ε − ε_θ(x_t, t)‖², with t, then ε, then the model's
        dropout drawn from ``generator`` in that order (the JAX package's
        t/ε/dropout key split)."""
        t = self.sample_timesteps(generator, x_0.shape[0])
        noise = torch.randn(x_0.shape, generator=generator, dtype=x_0.dtype,
                            device=generator.device)
        return self.loss_given(model_fn, params, x_0, t, noise, train=train,
                               generator=generator)

    def loss_given(self, model_fn: ModelFn, params: Any, x_0: torch.Tensor,
                   t: torch.Tensor, noise: torch.Tensor, *, train: bool = False,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The loss with injected t and ε: the deterministic core of
        :meth:`loss`, the entry the parity tests drive. The network output is
        cast to x_0's dtype before the loss, which is taken in that dtype."""
        alpha_bar_t = _bcast(self.schedule.alpha_bar.to(x_0.device)[t], x_0.dim())
        x_t = eq.ddpm.q_sample(x_0, alpha_bar_t, noise)
        out = model_fn(params, x_t, t, train=train, generator=generator).to(x_0.dtype)
        if self.parameterization == "v":
            target = eq.ddpm.v_target(x_0, alpha_bar_t, noise)
        else:
            target = noise
        if self.snr_gamma is None:
            return eq.ddpm.simple_loss(target, out)
        w = eq.ddpm.min_snr_weight(alpha_bar_t, self.snr_gamma, self.parameterization)
        return torch.mean(w * torch.square(target - out))

    # ----------------------------------------------------------------- sample
    def sampling_step(self, model_fn: ModelFn, params: Any, x_t: torch.Tensor, t,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One ancestral step x_t → x_{t−1} with variance β_t; the noise is
        dropped at t == 1. ``noise`` replaces the draw from ``generator``."""
        sched = self.schedule.to(x_t.device)
        t = _timesteps(t, x_t)
        beta_t = _bcast(sched.beta[t], x_t.dim())
        alpha_t = _bcast(sched.alpha[t], x_t.dim())
        alpha_bar_t = _bcast(sched.alpha_bar[t], x_t.dim())

        out = model_fn(params, x_t, t).to(x_t.dtype)
        eps_hat = self.to_eps(out, x_t, alpha_bar_t)
        p = eq.ddpm.reverse_process(x_t, beta_t, alpha_t, alpha_bar_t, eps_hat, beta_t)
        x_prev = p.sample(generator, noise)
        return torch.where(_bcast(t, x_t.dim()) == 1, p.mean, x_prev)

    @torch.no_grad()
    def generate(self, model_fn: ModelFn, params: Any,
                 generator: Optional[torch.Generator], img_shape: Tuple[int, ...], *,
                 x_T: Optional[torch.Tensor] = None, history_length: Optional[int] = None):
        """Full reverse process x_T → x_0. x_T is drawn from ``generator`` (on
        the generator's device) unless given. With ``history_length``,
        returns ``(x_0, history)``, history (history_length, *img_shape): the
        frames of :func:`history_slots`, the last one x_0."""
        x = _start(img_shape, generator, x_T)
        algo = self.to(x.device)
        capture = None if history_length is None else HistoryCapture(self.timesteps,
                                                                     history_length, x)
        for k, t in enumerate(range(self.timesteps, 0, -1)):
            x = algo.sampling_step(model_fn, params, x, t, generator)
            if capture is not None:
                capture(k, x)
        return x if capture is None else (x, capture.frames)
