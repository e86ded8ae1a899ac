"""The port's DDIM and DDPM sampling trajectories against the JAX package's.

Both frameworks run the TINY UNet on the same seeded weights
(``from_flax``) in f32. The JAX side is its real jitted ``generate`` scan
with every frame captured; the port starts from the same x_T and steps through
``sampling_step``, and each of its frames must match within rtol 1e-4 /
atol 1e-4. JAX and PyTorch random streams differ, so the DDPM test injects
the JAX scan's own per-step ε, ``normal(fold_in(scan_key, t))``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmme_tpu.diffusion import DDIM as JaxDDIM
from dmme_tpu.diffusion import DDPM as JaxDDPM
from dmme_tpu.models import as_model_fn
from dmme_tpu.models import ddpm as jax_ddpm
from dmme_tpu_torch.diffusion import DDIM, DDPM
from dmme_tpu_torch.models import ddpm as t_ddpm
from dmme_tpu_torch.training import LitDDIM, TrainState
from dmme_tpu_torch.utils.convert import from_flax

torch.set_num_threads(1)

TINY = dict(pos_dim=4, emb_dim=8, num_groups=2, channels_per_depth=(4, 8, 16, 32),
            num_blocks=2, dropout=0.0)
SHAPE = (2, 8, 8, 3)
TOL = dict(rtol=1e-4, atol=1e-4)


def _random_params(shapes, seed=0):
    """Seeded numpy values for the JAX parameter tree (shapes from
    ``jax.eval_shape``, so no init program is compiled): kernels of variance
    1/fan_in, GroupNorm scales near 1, small biases."""
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
    jmodel = jax_ddpm.UNet(**TINY)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros(SHAPE),
                            jnp.zeros((2,), jnp.int32))
    params = _random_params(shapes)
    tmodel = t_ddpm.UNet(**TINY)
    sd = from_flax(params)
    tmodel.load_state_dict(sd, strict=True)
    return jmodel, params, tmodel, sd


def _jax_trajectory(algo, model_fn, params, rng, n_steps):
    x0, hist = jax.jit(
        lambda p, r: algo.generate(model_fn, p, r, SHAPE, history_length=n_steps)
    )(params, rng)
    return np.asarray(x0), np.asarray(hist)  # hist[k]: x after the k-th step


def _x_T(rng):
    x_key, scan_key = jax.random.split(rng)
    return np.asarray(jax.random.normal(x_key, SHAPE, jnp.float32)), scan_key


def _model_fn(tmodel):
    def fn(params, x, t):
        return torch.func.functional_call(tmodel, params, (x, t))
    return fn


def test_ddim_trajectory_matches(models):
    """η = 0, quadratic τ with T=20, S=10: τ_1 = round(0.2) = 0, so the last
    step runs through the degenerate-τ guards."""
    jmodel, params, tmodel, sd = models
    T, S = 20, 10
    jalgo = JaxDDIM.create(timesteps=T, sub_timesteps=S, tau_schedule="quadratic")
    talgo = DDIM.create(timesteps=T, sub_timesteps=S, tau_schedule="quadratic")
    assert int(talgo.tau[1]) == 0
    rng = jax.random.PRNGKey(5)
    x0, hist = _jax_trajectory(jalgo, as_model_fn(jmodel), params, rng, S)
    x_T, _ = _x_T(rng)

    x = torch.tensor(x_T)
    fn = _model_fn(tmodel)
    with torch.no_grad():
        for k, i in enumerate(range(S, 0, -1)):
            x = talgo.sampling_step(fn, sd, x, i)
            assert torch.isfinite(x).all(), f"step {k}"
            np.testing.assert_allclose(x.numpy(), hist[k], err_msg=f"step {k}", **TOL)
        got = talgo.generate(fn, sd, None, SHAPE, x_T=torch.tensor(x_T))
    np.testing.assert_allclose(got.numpy(), x0, **TOL)


@pytest.mark.parametrize("parameterization,clip_x0",
                         [("eps", False), ("v", False), ("eps", True), ("v", True)])
def test_ddim_single_step_matches(models, parameterization, clip_x0):
    """One DDIM step from the same x at the first, a middle and the
    degenerate last τ index, under both output conventions, with and without
    the x̂₀ clamp (x is scaled up so that the clamp binds)."""
    import dataclasses

    jmodel, params, tmodel, sd = models
    T, S = 20, 10
    jalgo = JaxDDIM.create(timesteps=T, sub_timesteps=S, tau_schedule="quadratic",
                           parameterization=parameterization).replace(clip_x0=clip_x0)
    talgo = dataclasses.replace(
        DDIM.create(timesteps=T, sub_timesteps=S, tau_schedule="quadratic",
                    parameterization=parameterization), clip_x0=clip_x0)
    x = 3.0 * np.random.default_rng(4).standard_normal(SHAPE).astype(np.float32)
    jstep = jax.jit(lambda p, x, i: jalgo.sampling_step(as_model_fn(jmodel), p, x, i,
                                                        jax.random.PRNGKey(0)))
    fn = _model_fn(tmodel)
    for i in (S, S // 2, 1):
        want = np.asarray(jstep(params, jnp.asarray(x), jnp.int32(i)))
        with torch.no_grad():
            got = talgo.sampling_step(fn, sd, torch.tensor(x), i)
        assert torch.isfinite(got).all(), f"i={i}"
        np.testing.assert_allclose(got.numpy(), want, err_msg=f"i={i}", **TOL)


def test_ddpm_ancestral_trajectory_matches(models):
    jmodel, params, tmodel, sd = models
    T = 10
    jalgo = JaxDDPM.create(timesteps=T)
    talgo = DDPM.create(timesteps=T)
    rng = jax.random.PRNGKey(11)
    _, hist = _jax_trajectory(jalgo, as_model_fn(jmodel), params, rng, T)
    x_T, scan_key = _x_T(rng)

    x = torch.tensor(x_T)
    fn = _model_fn(tmodel)
    with torch.no_grad():
        for k, t in enumerate(range(T, 0, -1)):
            eps = np.asarray(jax.random.normal(jax.random.fold_in(scan_key, t), SHAPE,
                                               jnp.float32))
            x = talgo.sampling_step(fn, sd, x, t, noise=torch.tensor(eps))
            np.testing.assert_allclose(x.numpy(), hist[k], err_msg=f"step {k}", **TOL)


def test_lit_ddim_generate_uses_ema_and_generator(models):
    _, _, tmodel, sd = models
    lit = LitDDIM(model=tmodel, timesteps=20, sample_steps=4)
    state = TrainState.create(sd, lit.make_optimizer())
    state.params = {k: torch.zeros_like(v) for k, v in sd.items()}  # EMA copy is what samples
    a = lit.generate(state, torch.Generator().manual_seed(3), SHAPE)
    b = lit.generate(state, torch.Generator().manual_seed(3), SHAPE)
    c = lit.generate(state, torch.Generator().manual_seed(4), SHAPE)
    assert a.shape == SHAPE and torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    raw = lit.generate(state, torch.Generator().manual_seed(3), SHAPE, use_ema=False)
    assert not torch.equal(a, raw)
