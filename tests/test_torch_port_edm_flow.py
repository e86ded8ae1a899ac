"""EDM and flow matching in the port against the JAX package, on the TINY UNet.

The equations' tables are held within 1e-6 abs (``torch.linspace`` and
``jnp.linspace`` may differ by ulps); the coefficients, losses, steps and
trajectories within rtol/atol 1e-4, as tests/test_torch_port_samplers.py
holds the solvers. JAX and torch draws cannot match, so σ/t, the noise and
the starting states are drawn in numpy or JAX and handed over: σ_max·z for
EDM's x_T and z for flow's, computed as JAX's ``generate`` computes them;
the churn noise goes in through ``sampling_step(noise=)``. Dropout is 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

import dmme_tpu.equations as jeq
from dmme_tpu.diffusion import EDM as JaxEDM
from dmme_tpu.diffusion import DDPM as JaxDDPM
from dmme_tpu.diffusion import FlowMatching as JaxFlow
from dmme_tpu.diffusion import make_sampler as jax_make_sampler
from dmme_tpu.models import as_model_fn
from dmme_tpu.models import ddpm as jax_ddpm
from dmme_tpu_torch import equations as teq
from dmme_tpu_torch.diffusion import DDPM, EDM, FlowMatching, make_sampler
from dmme_tpu_torch.models import ddpm as t_ddpm
from dmme_tpu_torch.utils.convert import from_flax

torch.set_num_threads(1)

TINY = dict(pos_dim=4, emb_dim=8, num_groups=2, channels_per_depth=(4, 8, 16, 16),
            num_blocks=1, dropout=0.0)
SHAPE = (2, 8, 8, 3)
TOL = dict(rtol=1e-4, atol=1e-4)
TABLE_ATOL = 1e-6


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
def nets():
    """(JAX model_fn, JAX params, port model_fn, state_dict) on the same weights."""
    jmodel = jax_ddpm.UNet(**TINY)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros(SHAPE),
                            jnp.zeros((SHAPE[0],), jnp.float32))
    params = _random_params(shapes, seed=5)
    tmodel = t_ddpm.UNet(**TINY, fused_norm=True, fused_block=True)
    sd = from_flax(params)
    tmodel.load_state_dict(sd, strict=True)

    def tfn(p, x, t, **kw):
        return functional_call(tmodel, p, (x, t), kw)

    return as_model_fn(jmodel), params, tfn, sd


def _np(x):
    return np.asarray(x)


# ----------------------------------------------------------------- equations

@pytest.mark.parametrize("steps", [1, 2, 10, 18, 35])
@pytest.mark.parametrize("smin,smax,rho", [(0.002, 80.0, 7.0), (0.01, 10.0, 3.0)])
def test_karras_sigmas_match(steps, smin, smax, rho):
    got = teq.edm.karras_sigmas(steps, smin, smax, rho)
    want = _np(jeq.edm.karras_sigmas(steps, smin, smax, rho))
    assert got.dtype == torch.float32 and got.shape == (steps + 1,) and float(got[-1]) == 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TABLE_ATOL)


@pytest.mark.parametrize("steps,shift", [(1, 1.0), (4, 1.0), (25, 1.0), (25, 3.0), (50, 2.0)])
def test_time_grid_and_shift_match(steps, shift):
    got = teq.flow.time_grid(steps, shift)
    np.testing.assert_allclose(got.numpy(), _np(jeq.flow.time_grid(steps, shift)), rtol=0,
                               atol=TABLE_ATOL)
    assert float(got[0]) == 1.0 and float(got[-1]) == 0.0
    t = np.linspace(0.0, 1.0, 11, dtype=np.float32)
    np.testing.assert_allclose(teq.flow.shift_time(torch.tensor(t), shift).numpy(),
                               _np(jeq.flow.shift_time(jnp.asarray(t), shift)), rtol=0,
                               atol=TABLE_ATOL)


def test_precond_and_loss_weight_match():
    """Every coefficient from σ = 0.002 to σ = 80 (and σ_data 0.5 and 1),
    and λ·c_out² = 1."""
    sigma = np.geomspace(0.002, 80.0, 13).astype(np.float32)
    for sd in (0.5, 1.0):
        got = teq.edm.precond(torch.tensor(sigma), sd)
        want = jeq.edm.precond(jnp.asarray(sigma), sd)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-6, atol=1e-7)
        lam = teq.edm.loss_weight(torch.tensor(sigma), sd)
        np.testing.assert_allclose(lam.numpy(), _np(jeq.edm.loss_weight(jnp.asarray(sigma), sd)),
                                   rtol=1e-6)
        np.testing.assert_allclose((lam * got.c_out ** 2).numpy(), 1.0, rtol=1e-5)


def test_interpolate_and_velocity_target_match():
    r = np.random.default_rng(0)
    x0, x1 = (r.standard_normal(SHAPE).astype(np.float32) for _ in range(2))
    t = np.array([0.0, 0.37], np.float32)
    got = teq.flow.interpolate(torch.tensor(x0), torch.tensor(x1), torch.tensor(t))
    np.testing.assert_allclose(got.numpy(), _np(jeq.flow.interpolate(x0, x1, t)), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(got[0].numpy(), x0[0])
    np.testing.assert_allclose(teq.flow.velocity_target(torch.tensor(x0), torch.tensor(x1)),
                               _np(jeq.flow.velocity_target(x0, x1)), rtol=0, atol=0)


def test_training_draws_have_their_laws():
    """σ log-normal(−1.2, 1.2), t logit-normal and uniform: shapes, dtypes and
    moments of 20,000 draws (the streams themselves cannot match JAX's)."""
    g = torch.Generator().manual_seed(0)
    sig = teq.edm.sample_sigma_lognormal(g, 20000)
    assert sig.dtype == torch.float32 and sig.shape == (20000,) and bool((sig > 0).all())
    assert abs(float(sig.log().mean()) + 1.2) < 0.05 and abs(float(sig.log().std()) - 1.2) < 0.05
    t = teq.flow.sample_t_logit_normal(g, 20000, 0.5, 2.0)
    assert bool(((t > 0) & (t < 1)).all())
    logit = torch.log(t / (1 - t))
    assert abs(float(logit.mean()) - 0.5) < 0.05 and abs(float(logit.std()) - 2.0) < 0.05
    u = teq.flow.sample_t_uniform(g, 20000)
    assert bool(((u >= 0) & (u < 1)).all()) and abs(float(u.mean()) - 0.5) < 0.01


# --------------------------------------------------------------------- losses

def test_edm_loss_given_matches(nets):
    """σ from 0.002 (λ ≈ 2.5e5) to 80, f32, dropout 0."""
    jfn, params, tfn, sd = nets
    r = np.random.default_rng(1)
    x0 = np.clip(r.standard_normal(SHAPE), -1, 1).astype(np.float32)
    noise = r.standard_normal(SHAPE).astype(np.float32)
    sigma = np.array([0.002, 80.0], np.float32)
    jalgo, talgo = JaxEDM.create(), EDM.create()
    want = float(jalgo.loss_given(jfn, params, x0, sigma, noise))
    got = talgo.loss_given(tfn, sd, torch.tensor(x0), torch.tensor(sigma), torch.tensor(noise))
    np.testing.assert_allclose(float(got), want, **TOL)
    # the gradient with respect to the data at those σ, through the training
    # forward (dropout 0; the eval forward's fused ResBlock has no backward)
    jg = jax.grad(lambda x: jalgo.loss_given(jfn, params, x, sigma, noise, train=True))(x0)
    xt = torch.tensor(x0, requires_grad=True)
    (tg,) = torch.autograd.grad(talgo.loss_given(tfn, sd, xt, torch.tensor(sigma),
                                                 torch.tensor(noise), train=True), xt)
    np.testing.assert_allclose(tg.numpy(), _np(jg), rtol=1e-3, atol=1e-3 * float(np.abs(jg).max()))


@pytest.mark.parametrize("sigma_data", [0.5, 1.0])
def test_edm_denoise_matches(nets, sigma_data):
    jfn, params, tfn, sd = nets
    x = (3.0 * np.random.default_rng(2).standard_normal(SHAPE)).astype(np.float32)
    jalgo, talgo = JaxEDM.create(sigma_data=sigma_data), EDM.create(sigma_data=sigma_data)
    for sigma in (0.01, 3.0):
        want = _np(jalgo.denoise(jfn, params, x, sigma))
        got = talgo.denoise(tfn, sd, torch.tensor(x), sigma)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("t_sample", ["uniform", "logit_normal"])
def test_flow_loss_given_matches(nets, t_sample):
    jfn, params, tfn, sd = nets
    r = np.random.default_rng(3)
    x0 = np.clip(r.standard_normal(SHAPE), -1, 1).astype(np.float32)
    x1 = r.standard_normal(SHAPE).astype(np.float32)
    t = np.array([0.001, 0.97], np.float32)
    want = float(JaxFlow.create(t_sample=t_sample).loss_given(jfn, params, x0, t, x1))
    got = FlowMatching.create(t_sample=t_sample).loss_given(tfn, sd, torch.tensor(x0),
                                                          torch.tensor(t), torch.tensor(x1))
    np.testing.assert_allclose(float(got), want, **TOL)


@pytest.mark.parametrize("family", ["edm", "flow"])
def test_loss_draws_sigma_then_noise_then_dropout(nets, family):
    """``loss`` is ``loss_given`` on σ (or t), then the noise, drawn from the
    one generator in that order."""
    *_, tfn, sd = nets
    x0 = torch.rand(SHAPE) * 2 - 1
    algo = EDM.create() if family == "edm" else FlowMatching.create()
    got = algo.loss(tfn, sd, torch.Generator().manual_seed(9), x0, train=False)
    g = torch.Generator().manual_seed(9)
    if family == "edm":
        first = teq.edm.sample_sigma_lognormal(g, SHAPE[0])
    else:
        first = teq.flow.sample_t_logit_normal(g, SHAPE[0])
    noise = torch.randn(SHAPE, generator=g)
    assert torch.equal(got, algo.loss_given(tfn, sd, x0, first, noise))


# --------------------------------------------------------------------- steps

@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("churn", [0.0, 30.0])
def test_edm_sampling_step_matches(nets, order, churn):
    """Steps 0, 3 and the last (σ_next = 0, Euler's only) of a 6-step grid;
    with churn the JAX step's draw goes in as ``noise``."""
    jfn, params, tfn, sd = nets
    kw = dict(steps=6, order=order, s_churn=churn, s_min=0.05, s_max=50.0)
    jalgo, talgo = JaxEDM.create(**kw), EDM.create(**kw)
    x = (10.0 * np.random.default_rng(4).standard_normal(SHAPE)).astype(np.float32)
    for i in (0, 3, 5):
        key = jax.random.PRNGKey(i)
        want = _np(jalgo.sampling_step(jfn, params, x, i, key))
        noise = torch.tensor(_np(jax.random.normal(key, SHAPE, jnp.float32)))
        got = talgo.sampling_step(tfn, sd, torch.tensor(x), i, noise=noise)
        np.testing.assert_allclose(got.numpy(), want, err_msg=f"step {i}", **TOL)


def test_edm_heun_skips_the_corrector_on_the_last_step(nets):
    """2·steps − 1 network evaluations for Heun, ``steps`` for Euler."""
    *_, tfn, sd = nets
    calls = []

    def counting(p, x, t, **kw):
        calls.append(float(t[0]))
        return tfn(p, x, t, **kw)

    for order, want in ((2, 7), (1, 4)):
        calls.clear()
        EDM.create(steps=4, order=order).generate(counting, sd, torch.Generator().manual_seed(0),
                                                  SHAPE)
        assert len(calls) == want and all(np.isfinite(calls))


@pytest.mark.parametrize("order", [1, 2])
def test_flow_sampling_step_matches(nets, order):
    jfn, params, tfn, sd = nets
    jalgo, talgo = JaxFlow.create(steps=5, order=order), FlowMatching.create(steps=5, order=order)
    x = np.random.default_rng(5).standard_normal(SHAPE).astype(np.float32)
    for i in (0, 4):
        want = _np(jalgo.sampling_step(jfn, params, x, i))
        got = talgo.sampling_step(tfn, sd, torch.tensor(x), i)
        np.testing.assert_allclose(got.numpy(), want, err_msg=f"step {i}", **TOL)


# --------------------------------------------------------------- trajectories

def _trajectory(jalgo, talgo, nets, x_T, seed, history_length):
    jfn, params, tfn, sd = nets
    rng = jax.random.PRNGKey(seed)
    x0, hist = jax.jit(lambda p, r: jalgo.generate(jfn, p, r, SHAPE,
                                                   history_length=history_length))(params, rng)
    got, frames = talgo.generate(tfn, sd, None, SHAPE, x_T=torch.tensor(_np(x_T)),
                                 history_length=history_length)
    assert frames.shape == (history_length,) + SHAPE and torch.isfinite(got).all()
    hist = _np(hist)
    for k in range(history_length):
        np.testing.assert_allclose(frames[k].numpy(), hist[k], err_msg=f"frame {k}", **TOL)
    np.testing.assert_allclose(got.numpy(), _np(x0), **TOL)
    assert torch.equal(frames[-1], got)


@pytest.mark.parametrize("order,history_length", [(2, 5), (2, 3), (1, 5)])
def test_edm_generate_frame_by_frame(nets, order, history_length):
    """The whole Heun (or Euler) trajectory from JAX's σ_max·z, each frame of
    the ``history_length`` contract that GenerateImage reads."""
    kw = dict(steps=5, order=order)
    jalgo, talgo = JaxEDM.create(**kw), EDM.create(**kw)
    rng = jax.random.PRNGKey(11)
    x_T = jalgo.sigmas[0] * jax.random.normal(jax.random.split(rng)[0], SHAPE, jnp.float32)
    _trajectory(jalgo, talgo, nets, x_T, 11, history_length)


@pytest.mark.parametrize("order,shift,history_length", [(2, 1.0, 4), (1, 3.0, 4), (2, 3.0, 2)])
def test_flow_generate_frame_by_frame(nets, order, shift, history_length):
    kw = dict(steps=4, order=order, shift=shift)
    jalgo, talgo = JaxFlow.create(**kw), FlowMatching.create(**kw)
    x_T = jax.random.normal(jax.random.PRNGKey(12), SHAPE, jnp.float32)
    _trajectory(jalgo, talgo, nets, x_T, 12, history_length)


@pytest.mark.parametrize("family", ["edm", "flow"])
def test_generate_draws_its_start_from_the_generator(nets, family):
    """Without x_T the start is a draw from the generator (σ_0-scaled for
    EDM): the same seed gives the same samples, another seed others."""
    *_, tfn, sd = nets
    algo = EDM.create(steps=3) if family == "edm" else FlowMatching.create(steps=3)
    a, b, c = (algo.generate(tfn, sd, torch.Generator().manual_seed(s), SHAPE) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    g = torch.Generator().manual_seed(1)
    x_T = torch.randn(SHAPE, generator=g)
    if family == "edm":
        x_T = algo.sigmas[0] * x_T  # σ_0 = σ_max as the grid rounds it
    assert torch.equal(a, algo.generate(tfn, sd, None, SHAPE, x_T=x_T))
    with pytest.raises(ValueError, match="generator or x_T"):
        algo.generate(tfn, sd, None, SHAPE)


# ------------------------------------------------------------------ overrides

def test_edm_override_rebuilds_the_trained_grid():
    """``make_sampler(EDM, "edm", n)``: JAX's grid at n steps with the trained
    σ range (σ_min = sigmas[-2], σ_max = sigmas[0]), ρ, σ_data and churn."""
    kw = dict(steps=12, sigma_min=0.01, sigma_max=40.0, rho=5.0, sigma_data=0.7, order=1,
              s_churn=2.0)
    for steps in (None, 7):
        jalgo, _ = jax_make_sampler(JaxEDM.create(**kw), "edm", steps)
        talgo, adapt = make_sampler(EDM.create(**kw), "edm", steps)
        assert isinstance(talgo, EDM) and adapt(len) is len
        assert talgo.steps == jalgo.steps == (steps or 18)
        np.testing.assert_allclose(talgo.sigmas.numpy(), _np(jalgo.sigmas), rtol=0,
                                   atol=TABLE_ATOL)
        for f in ("rho", "sigma_data", "p_mean", "p_std", "order", "s_churn", "s_min", "s_max",
                  "s_noise"):
            assert getattr(talgo, f) == getattr(jalgo, f), f


def test_flow_override_rebuilds_the_trained_grid():
    kw = dict(steps=10, order=1, shift=3.0, t_sample="uniform", time_scale=500.0)
    for steps in (None, 6):
        jalgo, _ = jax_make_sampler(JaxFlow.create(**kw), "flow", steps)
        talgo, adapt = make_sampler(FlowMatching.create(**kw), "flow", steps)
        assert isinstance(talgo, FlowMatching) and adapt(len) is len
        assert talgo.steps == jalgo.steps == (steps or 25)
        np.testing.assert_allclose(talgo.ts.numpy(), _np(jalgo.ts), rtol=0, atol=TABLE_ATOL)
        for f in ("order", "shift", "t_sample", "logit_mean", "logit_std", "time_scale"):
            assert getattr(talgo, f) == getattr(jalgo, f), f


@pytest.mark.parametrize("name,base,needle", [
    ("edm", "ddpm", "needs an EDM-trained model"),
    ("edm", "flow", "needs an EDM-trained model"),
    ("flow", "ddpm", "needs a flow-matching-trained model"),
    ("flow", "edm", "needs a flow-matching-trained model"),
    ("ddim", "edm", "sampler=edm"),
    ("dpm", "flow", "sampler=flow"),
])
def test_override_family_errors_match_jax(name, base, needle):
    bases = {"ddpm": (JaxDDPM.create(20), DDPM.create(20)), "edm": (JaxEDM.create(), EDM.create()),
             "flow": (JaxFlow.create(), FlowMatching.create())}
    jbase, tbase = bases[base]
    with pytest.raises(ValueError) as jerr:
        jax_make_sampler(jbase, name)
    with pytest.raises(ValueError, match=needle) as terr:
        make_sampler(tbase, name)
    assert str(terr.value) == str(jerr.value)


def test_create_rejects_bad_orders():
    with pytest.raises(ValueError, match="order"):
        EDM.create(order=3)
    with pytest.raises(ValueError, match="t_sample"):
        FlowMatching.create(t_sample="beta")
