"""The sampler override at generation time (mirrors ``dmme_tpu/diffusion/factory.py``).

One factory for the ``sample`` subcommand and the HTTP server, so the
sampler names mean the same in both. The override reuses the trained
model's schedule and output parameterization (a cosine-schedule IDDPM must
be integrated on the ᾱ it was trained on), and adapts the ε ‖ v output of a
variance-learning model to ε (``models.eps_only``). EDM and flow-matching
models are rebuilt at the new step count with their trained
hyperparameters.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

from dmme_tpu_torch import equations as eq
from dmme_tpu_torch.diffusion.ddim import DDIM
from dmme_tpu_torch.diffusion.deep_cache import DeepCachedDDIM, DeepCachedDPM
from dmme_tpu_torch.diffusion.dpm_solver import DPMSolverPP
from dmme_tpu_torch.diffusion.edm import EDM
from dmme_tpu_torch.diffusion.fast import CachedDDIM
from dmme_tpu_torch.diffusion.flow import FlowMatching
from dmme_tpu_torch.diffusion.iddpm import IDDPM
from dmme_tpu_torch.diffusion.unipc import UniPC
from dmme_tpu_torch.models import eps_only

#: steps by default; unipc's 10 is the low-NFE regime its corrector targets,
#: flow's 25 midpoint steps are 50 network evaluations
STEP_DEFAULTS = {"ddim": 50, "dpm": 20, "unipc": 10, "edm": 18, "flow": 25}
#: the feature-caching samplers, which drive the UNet module, not a model_fn
MODULE_SAMPLERS = ("cached", "deep", "deep_dpm")


def check_sampler(name: str) -> None:
    """Raise ``ValueError`` for a name that neither :func:`make_sampler` nor
    :func:`make_module_sampler` takes."""
    if name not in STEP_DEFAULTS and name not in MODULE_SAMPLERS:
        raise ValueError(f"unknown sampler {name!r} "
                         f"({'|'.join((*STEP_DEFAULTS, *MODULE_SAMPLERS))})")


def default_steps(name: str) -> int:
    """The steps a sampler takes when none are asked for: ``STEP_DEFAULTS``,
    and for the module samplers DDIM's 50 (``deep_dpm``: DPM-Solver++'s 20)."""
    if name in STEP_DEFAULTS:
        return STEP_DEFAULTS[name]
    return STEP_DEFAULTS["dpm"] if name == "deep_dpm" else STEP_DEFAULTS["ddim"]


def make_module_sampler(base, name: str, steps: Optional[int] = None,
                        refresh_interval: int = 2, cache_depth: int = 1,
                        conditional: bool = False):
    """The feature-caching sampler ``name`` ∈ cached (encoder reuse,
    :class:`CachedDDIM`) | deep (deep-core caching, :class:`DeepCachedDDIM`)
    | deep_dpm (deep-core caching on DPM-Solver++(2M), :class:`DeepCachedDPM`)
    on the schedule of the model trained with ``base``. Its ``generate``
    takes the UNet module and its weights. Raises ``ValueError`` for a
    class-conditional model (the cache bypasses the guidance wrapper), a
    variance-learning one (the cached decoder yields ε ‖ v) and one with no
    discrete schedule."""
    if name not in MODULE_SAMPLERS:
        raise ValueError(f"unknown module sampler {name!r} ({'|'.join(MODULE_SAMPLERS)})")
    if conditional:
        raise ValueError(f"sampler={name!r} does not support class-conditional models "
                         "(feature caching bypasses the CFG wrapper); use ddim or dpm")
    if isinstance(base, IDDPM):
        raise ValueError(f"sampler={name!r} does not support variance-learning (ε‖v) models "
                         "— the cached decoder consumes raw ε; use ddim or dpm (which adapt "
                         "via models.eps_only)")
    schedule = getattr(base, "schedule", None)
    if schedule is None:
        raise ValueError(f"sampler={name!r} needs a discrete-schedule model")
    timesteps = int(base.timesteps)
    par = getattr(base, "parameterization", "eps")
    clip_x0 = bool(float(schedule.alpha_bar[-1]) < 1e-6)
    steps = int(steps or default_steps(name))
    if name == "deep_dpm":
        return dataclasses.replace(
            DeepCachedDPM.create(timesteps, sub_timesteps=steps, schedule=schedule,
                                 parameterization=par, refresh_interval=refresh_interval,
                                 cache_depth=cache_depth), clip_x0=clip_x0)
    common = dict(schedule=schedule, timesteps=timesteps,
                  tau=eq.ddim.quadratic_tau(timesteps, steps), sub_timesteps=steps, eta=0.0,
                  variant="canonical", parameterization=par,
                  refresh_interval=refresh_interval, clip_x0=clip_x0)
    if name == "cached":
        return CachedDDIM(**common)
    return DeepCachedDDIM(**common, cache_depth=cache_depth)


def make_sampler(base, name: str, steps: Optional[int] = None) -> Tuple[object, Callable]:
    """(algorithm, model_fn adapter) to sample the model trained with ``base``
    by ``name`` ∈ ddim | dpm | unipc | edm | flow in ``steps`` steps.

    ``edm`` and ``flow`` need a model of their family; they rebuild its grid
    at ``steps`` with the trained hyperparameters (σ range, ρ, σ_data and
    churn; shift, order and time scale). The discrete names take the trained
    schedule, T and parameterization. The adapter is the identity but for
    an IDDPM model, whose ε ‖ v output it slices to ε. Where ᾱ_T < 1e-6
    (cosine schedules: ≈ 2e-15, against ≈ 4e-5 for the linear one) the x̂₀
    division at t = T amplifies the ε error by 1/√ᾱ_T, so x̂₀ is clamped to
    [−1, 1] there (``clip_x0``)."""
    if name not in STEP_DEFAULTS:
        raise ValueError(f"unknown sampler {name!r} ({'|'.join(STEP_DEFAULTS)})")
    steps = int(steps or STEP_DEFAULTS[name])
    if name == "flow":
        if not isinstance(base, FlowMatching):
            raise ValueError("sampler=flow needs a flow-matching-trained model (velocity "
                             "network); discrete-t models can use ddim or dpm")
        return FlowMatching.create(steps=steps, order=base.order, shift=base.shift,
                                   t_sample=base.t_sample, logit_mean=base.logit_mean,
                                   logit_std=base.logit_std,
                                   time_scale=base.time_scale), _identity
    if name == "edm":
        if not isinstance(base, EDM):
            raise ValueError("sampler=edm needs an EDM-trained model (σ-conditioned network); "
                             "discrete-t models can use ddim or dpm")
        return EDM.create(steps=steps, sigma_min=float(base.sigmas[-2]),
                          sigma_max=float(base.sigmas[0]), rho=base.rho,
                          sigma_data=base.sigma_data, p_mean=base.p_mean, p_std=base.p_std,
                          order=base.order, s_churn=base.s_churn, s_min=base.s_min,
                          s_max=base.s_max, s_noise=base.s_noise), _identity
    schedule = getattr(base, "schedule", None)
    if schedule is None:
        raise ValueError(f"sampler={name!r} needs a discrete-schedule model; "
                         f"{type(base).__name__} has none (EDM models sample with "
                         "sampler=edm, flow-matching models with sampler=flow)")
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
