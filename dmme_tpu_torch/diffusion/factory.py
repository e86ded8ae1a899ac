"""The sampler override at generation time (mirrors ``dmme_tpu/diffusion/factory.py``).

One factory for the ``sample`` subcommand and the HTTP server, so the
sampler names mean the same in both. The override reuses the trained
model's schedule and output parameterization (a cosine-schedule IDDPM must
be integrated on the ᾱ it was trained on), and adapts the ε ‖ v output of a
variance-learning model to ε (``models.eps_only``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

from dmme_tpu_torch import equations as eq
from dmme_tpu_torch.diffusion.ddim import DDIM
from dmme_tpu_torch.diffusion.dpm_solver import DPMSolverPP
from dmme_tpu_torch.diffusion.iddpm import IDDPM
from dmme_tpu_torch.diffusion.unipc import UniPC
from dmme_tpu_torch.models import eps_only

#: network evaluations by default; unipc's 10 is the low-NFE regime its corrector targets
STEP_DEFAULTS = {"ddim": 50, "dpm": 20, "unipc": 10}
#: the JAX package's other sampler names, with the ROADMAP item that ports them
NOT_PORTED = {
    "edm": "A.6: the LitEDM harness",
    "flow": "A.6: the LitFlow harness",
    "cached": "A.5: the UNet's feature-capture entry points",
    "deep": "A.5: the UNet's feature-capture entry points",
    "deep_dpm": "A.5: the UNet's feature-capture entry points",
}


def check_sampler(name: str) -> None:
    """Raise for a name that :func:`make_sampler` does not take:
    ``NotImplementedError`` naming the ROADMAP item for the JAX package's
    other samplers, ``ValueError`` for any other name."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"sampler {name!r} is not yet ported (ROADMAP {NOT_PORTED[name]})")
    if name not in STEP_DEFAULTS:
        raise ValueError(f"unknown sampler {name!r} ({'|'.join(STEP_DEFAULTS)})")


def make_sampler(base, name: str, steps: Optional[int] = None) -> Tuple[object, Callable]:
    """(algorithm, model_fn adapter) to sample the model trained with ``base``
    (the source of the schedule, T and the parameterization) by ``name`` ∈
    ddim | dpm | unipc in ``steps`` evaluations.

    The adapter is the identity but for an IDDPM model, whose ε ‖ v output
    it slices to ε. Where ᾱ_T < 1e-6 (cosine schedules: ≈ 2e-15, against
    ≈ 4e-5 for the linear one) the x̂₀ division at t = T amplifies the ε
    error by 1/√ᾱ_T, so x̂₀ is clamped to [−1, 1] there (``clip_x0``)."""
    check_sampler(name)
    steps = int(steps or STEP_DEFAULTS[name])
    schedule = getattr(base, "schedule", None)
    if schedule is None:
        raise ValueError(f"sampler={name!r} needs a discrete-schedule model; "
                         f"{type(base).__name__} has none")
    timesteps = int(base.timesteps)
    par = getattr(base, "parameterization", "eps")
    adapter = eps_only if isinstance(base, IDDPM) else _identity
    clip_x0 = bool(float(schedule.alpha_bar[-1]) < 1e-6)
    if name == "ddim":
        algo = DDIM(schedule=schedule, timesteps=timesteps,
                    tau=eq.ddim.quadratic_tau(timesteps, steps), sub_timesteps=steps,
                    eta=0.0, variant="canonical", parameterization=par, clip_x0=clip_x0)
    else:
        solver = UniPC if name == "unipc" else DPMSolverPP
        algo = dataclasses.replace(
            solver.create(timesteps, sub_timesteps=steps, schedule=schedule,
                          parameterization=par), clip_x0=clip_x0)
    return algo, adapter


def _identity(fn):
    return fn
