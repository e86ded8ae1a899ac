"""The sampler override (``make_sampler``: DDIM, DPM-Solver++, UniPC) against
the JAX package's, on the TINY DDPM and IDDPM models.

Both frameworks run the same seeded weights (``from_flax``) in f32 on the
CPU. The JAX side is its jitted ``generate`` scan with every frame
captured; the port starts from the same x_T and its Python loop must match
each frame within rtol 1e-4 / atol 1e-4, as tests/test_torch_port_sampling.py
holds DDIM. τ tables (linear, quadratic, karras) are integer and equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

import dmme_tpu.equations as jeq
from dmme_tpu.diffusion import DDPM as JaxDDPM
from dmme_tpu.diffusion import IDDPM as JaxIDDPM
from dmme_tpu.diffusion import DPMSolverPP as JaxDPM
from dmme_tpu.diffusion import UniPC as JaxUniPC
from dmme_tpu.diffusion import make_sampler as jax_make_sampler
from dmme_tpu.models import as_model_fn
from dmme_tpu.models import ddpm as jax_ddpm
from dmme_tpu.models import iddpm as jax_iddpm
from dmme_tpu_torch import equations as teq
from dmme_tpu_torch.diffusion import DDIM, DDPM, IDDPM, DPMSolverPP, UniPC, make_sampler
from dmme_tpu_torch.equations.ddpm import Schedule
from dmme_tpu_torch.models import ddpm as t_ddpm
from dmme_tpu_torch.models import eps_only
from dmme_tpu_torch.models import iddpm as t_iddpm
from dmme_tpu_torch.utils.convert import from_flax

torch.set_num_threads(1)

TINY = dict(pos_dim=4, emb_dim=8, num_groups=2, channels_per_depth=(4, 8, 16, 16),
            num_blocks=1, dropout=0.0)
SHAPE = (2, 8, 8, 3)
T = 20
TOL = dict(rtol=1e-4, atol=1e-4)


def _random_params(shapes, seed=0):
    r = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            v = r.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * r.standard_normal(leaf.shape)
        else:
            v = 0.1 * r.standard_normal(leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def models():
    """{"ddpm" | "iddpm": (JAX module, JAX params, port model, state_dict,
    JAX base algorithm, port base algorithm)}: linear β at T = 20 for DDPM,
    the cosine schedule (ᾱ_T ≈ 2e-15, so clip_x0) for IDDPM."""
    out = {}
    for kind, jmod, tmod, jbase, tbase in (
            ("ddpm", jax_ddpm, t_ddpm, JaxDDPM.create(T), DDPM.create(T)),
            ("iddpm", jax_iddpm, t_iddpm, JaxIDDPM.create(T), IDDPM.create(T))):
        jmodel = jmod.UNet(**TINY)
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros(SHAPE),
                                jnp.zeros((SHAPE[0],), jnp.int32))
        params = _random_params(shapes, seed=1 if kind == "iddpm" else 0)
        tmodel = tmod.UNet(**TINY, fused_norm=True, fused_block=True)
        sd = from_flax(params)
        tmodel.load_state_dict(sd, strict=True)
        out[kind] = (jmodel, params, tmodel, sd, jbase, tbase)
    return out


def _model_fn(model):
    def fn(params, x, t, **kw):
        return functional_call(model, params, (x, t), kw)
    return fn


def _compare(models, kind, jalgo, jadapt, talgo, tadapt, seed):
    jmodel, params, tmodel, sd, _, _ = models[kind]
    steps = talgo.sub_timesteps
    rng = jax.random.PRNGKey(seed)
    x0, hist = jax.jit(lambda p, r: jalgo.generate(jadapt(as_model_fn(jmodel)), p, r, SHAPE,
                                                   history_length=steps))(params, rng)
    x_T = np.asarray(jax.random.normal(jax.random.split(rng)[0], SHAPE, jnp.float32))
    got, frames = talgo.generate(tadapt(_model_fn(tmodel)), sd, None, SHAPE,
                                 x_T=torch.tensor(x_T), history_length=steps)
    assert torch.isfinite(got).all() and frames.shape == (steps,) + SHAPE
    hist = np.asarray(hist)
    for k in range(steps):
        np.testing.assert_allclose(frames[k].numpy(), hist[k], err_msg=f"frame {k}", **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(x0), **TOL)
    assert torch.equal(frames[-1], got)


@pytest.mark.parametrize("kind", ["ddpm", "iddpm"])
@pytest.mark.parametrize("name,steps", [("ddim", 10), ("dpm", 8), ("unipc", 6)])
def test_make_sampler_trajectory_matches(models, kind, name, steps):
    """The factory's algorithm on the trained schedule, the ε-only adapter on
    IDDPM and clip_x0 on its cosine schedule, every frame."""
    *_, jbase, tbase = models[kind]
    jalgo, jadapt = jax_make_sampler(jbase, name, steps)
    talgo, tadapt = make_sampler(tbase, name, steps)
    assert type(talgo).__name__ == type(jalgo).__name__
    assert talgo.clip_x0 == jalgo.clip_x0 == (kind == "iddpm")
    assert talgo.sub_timesteps == steps and talgo.timesteps == T
    np.testing.assert_array_equal(talgo.tau.numpy(), np.asarray(jalgo.tau))
    assert (tadapt is eps_only) == (kind == "iddpm")
    _compare(models, kind, jalgo, jadapt, talgo, tadapt, seed=steps)


@pytest.mark.parametrize("solver", ["dpm", "unipc"])
@pytest.mark.parametrize("tau", ["linear", "quadratic", "karras"])
def test_solver_tau_spacings_match(models, solver, tau):
    """DPM-Solver++(2M) and UniPC on the three τ spacings of the DDPM model
    (quadratic at T = 20, S = 8 repeats τ = 0: the identity steps)."""
    *_, jbase, tbase = models["ddpm"]
    jcls, tcls = (JaxDPM, DPMSolverPP) if solver == "dpm" else (JaxUniPC, UniPC)
    jalgo = jcls.create(T, sub_timesteps=8, tau_schedule=tau, schedule=jbase.schedule)
    talgo = tcls.create(T, sub_timesteps=8, tau_schedule=tau, schedule=tbase.schedule)
    np.testing.assert_array_equal(talgo.tau.numpy(), np.asarray(jalgo.tau))
    _compare(models, "ddpm", jalgo, lambda f: f, talgo, lambda f: f, seed=3)


@pytest.mark.parametrize("variant", ["order1", "no_corrector"])
def test_unipc_variants_match(models, variant):
    *_, jbase, tbase = models["ddpm"]
    kw = dict(order=1) if variant == "order1" else dict(corrector=False)
    jalgo = JaxUniPC.create(T, sub_timesteps=6, schedule=jbase.schedule, **kw)
    talgo = UniPC.create(T, sub_timesteps=6, schedule=tbase.schedule, **kw)
    _compare(models, "ddpm", jalgo, lambda f: f, talgo, lambda f: f, seed=4)


@pytest.mark.parametrize("schedule", ["linear", "cosine"])
@pytest.mark.parametrize("timesteps,steps", [(1000, 10), (1000, 50), (20, 10), (4000, 20)])
def test_karras_tau_tables_equal(schedule, timesteps, steps):
    """σ spacing snapped in log σ, with the σ_max = 80 clamp that keeps a
    cosine grid from collapsing onto the last timesteps."""
    jab = JaxIDDPM.create(timesteps, schedule=schedule).schedule.alpha_bar
    tab = torch.tensor(np.asarray(jab))
    got = teq.ddim.make_tau("karras", timesteps, steps, tab)
    want = np.asarray(jeq.ddim.karras_tau(jab, steps))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == 0 and got.shape == (steps + 1,) and bool((got[1:] >= 1).all())
    if schedule == "cosine" and timesteps == 1000 and steps == 10:
        # σ(t) ≤ 80 for the top entry: the clamp, not ᾱ_T ≈ 2e-15, anchors it
        ab = float(tab[int(got[-1])])
        assert ((1 - ab) / ab) ** 0.5 <= 80 * 1.5
        assert len(set(got.tolist())) == steps + 1


def test_karras_needs_alpha_bar():
    with pytest.raises(ValueError, match="alpha_bar"):
        teq.ddim.make_tau("karras", 1000, 10)


def test_eps_only_slices_the_variance_channels():
    x = torch.randn(2, 4, 4, 6)
    fn = eps_only(lambda params, x_, t, **kw: x_ * params)
    torch.testing.assert_close(fn(2.0, x, None), 2.0 * x[..., :3], rtol=0, atol=0)


def test_ddim_override_equals_the_ddim_harness(models):
    """``make_sampler(DDPM, "ddim")`` is the canonical η = 0 DDIM on quadratic τ."""
    *_, tbase = models["ddpm"]
    algo, _ = make_sampler(tbase, "ddim", 10)
    want = DDIM.create(T, 10, "quadratic")
    assert isinstance(algo, DDIM) and algo.eta == 0.0 and algo.variant == "canonical"
    assert torch.equal(algo.tau, want.tau)


@pytest.mark.parametrize("name", ["edm", "flow", "cached", "deep", "deep_dpm"])
def test_samplers_not_ported_name_their_item(models, name):
    """The five names the port once turned away, on the DDPM model: ``edm``
    and ``flow`` raise JAX's ``ValueError`` naming the family they need, and
    ``cached``/``deep``/``deep_dpm`` are module samplers, which
    ``make_sampler`` does not take and ``make_module_sampler`` builds."""
    from dmme_tpu.diffusion.factory import make_module_sampler as jax_make_module_sampler

    from dmme_tpu_torch.diffusion import CachedDDIM, DeepCachedDDIM, DeepCachedDPM
    from dmme_tpu_torch.diffusion.factory import make_module_sampler

    _, _, _, _, jbase, tbase = models["ddpm"]
    if name in ("edm", "flow"):
        with pytest.raises(ValueError) as jerr:
            jax_make_sampler(jbase, name)
        with pytest.raises(ValueError, match=f"sampler={name} needs an? "
                           + ("EDM" if name == "edm" else "flow-matching")) as terr:
            make_sampler(tbase, name)
        assert str(terr.value) == str(jerr.value)
        return
    with pytest.raises(ValueError, match="unknown sampler"):
        make_sampler(tbase, name)
    algo = make_module_sampler(tbase, name, 4)
    want = {"cached": CachedDDIM, "deep": DeepCachedDDIM, "deep_dpm": DeepCachedDPM}[name]
    assert type(algo) is want
    assert type(jax_make_module_sampler(jbase, name, 4)).__name__ == want.__name__


def test_unknown_sampler_and_scheduleless_base_raise(models):
    with pytest.raises(ValueError, match="unknown sampler"):
        make_sampler(models["ddpm"][5], "nope")

    @dataclasses.dataclass
    class NoSchedule:
        timesteps: int = 10

    with pytest.raises(ValueError, match="discrete-schedule"):
        make_sampler(NoSchedule(), "dpm")
    assert isinstance(models["ddpm"][5].schedule, Schedule)
