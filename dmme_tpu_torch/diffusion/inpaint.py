"""Mask-conditioned generation, RePaint inpainting with any trained DDPM or
IDDPM (mirrors ``dmme_tpu/diffusion/inpaint.py``; Lugmayr et al. 2022).

An unconditional model is conditioned at sampling time: after every reverse
step the known region is overwritten by its forward-diffused value at t−1,

    x_{t−1} = mask · q_sample(known, ᾱ_{t−1}, n) + (1 − mask) · step(x_t).

The schedules keep the ᾱ₀ = 1 sentinel, so the last composite (t − 1 = 0)
is √1·known + √0·n: the known pixels come back bit for bit.
``resample_steps > 1`` adds RePaint's harmonisation (jump length 1): the
composite is re-noised one step forward, √(1−β_t)·x + √β_t·n, and the
reverse step runs again, ``resample_steps`` times a timestep in all.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from dmme_tpu_torch import equations as eq

#: ``draws(t, u) -> (step noise, known-region noise, re-noise)``: the three
#: (N, H, W, C) draws of reverse step t's u-th repeat (the re-noise is not
#: read at the last repeat)
Draws = Callable[[int, int], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


@torch.no_grad()
def inpaint(algo, model_fn: Callable[..., torch.Tensor], params: Any,
            generator: Optional[torch.Generator], known: torch.Tensor, mask: torch.Tensor, *,
            resample_steps: int = 1, x_T: Optional[torch.Tensor] = None,
            draws: Optional[Draws] = None) -> torch.Tensor:
    """Generate images matching ``known`` where ``mask`` is 1.

    ``algo``: a trained ancestral algorithm (``DDPM`` or ``IDDPM``: its
    ``sampling_step``, ``schedule`` and ``timesteps``). ``known``: (N, H, W,
    C) images in the model's [−1, 1] domain, read only where ``mask`` (which
    broadcasts to it) is 1; 0 = generate. Every draw comes from
    ``generator`` (x_T first, then per step: the step's noise, the known
    region's, the re-noise) unless ``x_T`` and ``draws`` inject them.
    Returns (N, H, W, C) samples with the known region restored exactly."""
    assert resample_steps >= 1, resample_steps
    device = known.device if generator is None else generator.device
    known = known.to(device=device, dtype=torch.float32)
    mask = mask.to(device=device, dtype=torch.float32)
    if x_T is None:
        x_T = torch.randn(known.shape, generator=generator, dtype=torch.float32, device=device)
    x = x_T.to(device=device, dtype=torch.float32)
    algo = algo.to(device)
    ab, beta = algo.schedule.alpha_bar, algo.schedule.beta

    def normal():
        return torch.randn(known.shape, generator=generator, dtype=torch.float32,
                           device=device)

    for t in range(algo.timesteps, 0, -1):
        for u in range(resample_steps):
            last = u == resample_steps - 1
            if draws is not None:
                n_step, n_known, n_renoise = draws(t, u)
            else:
                n_step, n_known = normal(), normal()
                n_renoise = None if last else normal()
            x = algo.sampling_step(model_fn, params, x, t, noise=n_step.to(device))
            # overwrite the known region with its forward-diffused value at t−1
            x_known = eq.ddpm.q_sample(known, ab[t - 1], n_known.to(device))
            x = mask * x_known + (1.0 - mask) * x
            if not last:  # harmonise: one forward step t−1 → t, then reverse again
                x = torch.sqrt(1.0 - beta[t]) * x + torch.sqrt(beta[t]) * n_renoise.to(device)
    return x
