"""The port's IDDPM slice against the JAX package's, on the same inputs.

Equations on seeded numpy inputs (rtol 1e-5); the IDDPM schedule tables
within 1e-6 abs, as the DDPM tables are held (``torch.cos`` and ``jnp.cos``
may differ by an ulp where ᾱ_T ≈ 2e-15); the TINY IDDPM UNet (FiLM, 4
heads, 2C output) loaded with ``from_flax`` under each switch, forward
within rtol 1e-4 / atol 1e-5; ``loss_given`` for the three loss types with
t = 1 in the batch, the loss within rtol 1e-4 / atol 1e-6 and the gradient
tree within rtol 2e-3 / atol 1e-5, as tests/test_torch_port_training.py
holds DDPM; and ancestral trajectories with the JAX scan's own per-step ε
injected, within rtol 1e-4 / atol 1e-4 as tests/test_torch_port_sampling.py.
On the CPU the JAX side takes its exact XLA paths and the port its plain
versions, through the same autograd Functions as on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

import dmme_tpu.equations as jeq
from dmme_tpu.diffusion import IDDPM as JaxIDDPM
from dmme_tpu.models import as_model_fn
from dmme_tpu.models import iddpm as jax_iddpm
from dmme_tpu_torch import equations as teq
from dmme_tpu_torch.diffusion import IDDPM
from dmme_tpu_torch.models import iddpm as t_iddpm
from dmme_tpu_torch.training import LitIDDPM, TrainState
from dmme_tpu_torch.utils.convert import from_flax

torch.set_num_threads(1)

TINY = dict(pos_dim=4, emb_dim=8, num_groups=2, channels_per_depth=(4, 8, 16, 16),
            num_blocks=1, dropout=0.0)
SHAPE = (3, 8, 8, 3)
T = 20
EQ_TOL = dict(rtol=1e-5, atol=1e-6)
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_TOL = dict(rtol=2e-3, atol=1e-5)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)
SWITCHES = {"plain": dict(fused_norm=False, fused_block=False),
            "fused_norm": dict(fused_norm=True, fused_block=False),
            "fused_block": dict(fused_norm=True, fused_block=True)}


def _random_params(shapes, seed=0):
    """Seeded numpy values for the JAX parameter tree: kernels of variance
    1/fan_in, GroupNorm scales near 1, every bias (the FiLM ``condition``
    Dense's included) non-zero."""
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
def jax_params():
    """Random weights, with the variance half of ``output_conv`` set so that
    v ≈ 1.2 ± 0.02: at random v the t = 1 NLL is ill-conditioned in f32 (see
    :func:`_equation_inputs`); its gradient still reaches that half."""
    shapes = jax.eval_shape(jax_iddpm.UNet(**TINY).init, jax.random.PRNGKey(0),
                            jnp.zeros(SHAPE), jnp.zeros((SHAPE[0],), jnp.int32))
    params = _random_params(shapes)
    out = params["params"]["output_conv"]
    out["kernel"][..., 3:] *= 0.01
    out["bias"][3:] += 1.2
    return params


def _torch_model(switch="fused_block", **kw):
    return t_iddpm.UNet(**dict(TINY, **kw), **SWITCHES[switch])


def _model_fn(model):
    def fn(params, x, t, **kw):
        return functional_call(model, params, (x, t), kw)
    return fn


def _flat(tree):
    return from_flax(jax.tree_util.tree_map(np.asarray, tree))


def _batch(seed):
    """x_0, t (one sample at t = 1, the NLL branch), ε."""
    r = np.random.default_rng(seed)
    x0 = np.clip(r.standard_normal(SHAPE), -1, 1).astype(np.float32)
    t = r.integers(2, T, (SHAPE[0],)).astype(np.int32)
    t[0] = 1
    return x0, t, r.standard_normal(SHAPE).astype(np.float32)


# ------------------------------------------------------------------ equations

def test_gaussian_cdf_log_prob_and_kl_match():
    r = np.random.default_rng(0)
    mean, x = r.standard_normal((2, 64)).astype(np.float32)
    std = np.exp(r.uniform(-3, 1, 64)).astype(np.float32)
    tg = teq.Gaussian(torch.tensor(mean), torch.tensor(std))
    jg = jeq.gaussian.Gaussian(jnp.asarray(mean), jnp.asarray(std))
    np.testing.assert_allclose(tg.cdf(torch.tensor(x)).numpy(), np.asarray(jg.cdf(x)), **EQ_TOL)
    np.testing.assert_allclose(tg.log_prob(torch.tensor(x)).numpy(),
                               np.asarray(jg.log_prob(x)), **EQ_TOL)
    # q's and p's variances 60 decades apart: their ratio underflows to 0, the
    # log-ratio taken from the stds stays finite
    q_std = np.full(64, 1e-30, np.float32)
    tq = teq.Gaussian(torch.tensor(x), torch.tensor(q_std))
    jq = jeq.gaussian.Gaussian(jnp.asarray(x), jnp.asarray(q_std))
    got = teq.kl_divergence(tq, tg).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(jeq.gaussian.kl_divergence(jq, jg)), **EQ_TOL)


@pytest.mark.parametrize("schedule", ["cosine", "linear"])
@pytest.mark.parametrize("timesteps", [20, 1000, 4000])
def test_iddpm_schedule_tables(schedule, timesteps):
    kw = dict(start=0.000025, end=0.005) if timesteps == 4000 else {}
    got = IDDPM.create(timesteps, schedule=schedule, **kw).schedule
    want = JaxIDDPM.create(timesteps, schedule=schedule, **kw).schedule
    for name in ("beta", "alpha", "alpha_bar"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == torch.float32 and g.shape == (timesteps + 1,)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6, err_msg=name)
    if schedule == "cosine":
        assert float(got.beta[0]) == 1.0 and float(got.beta[1:].max()) <= 0.999 + 1e-7
        assert float(got.alpha_bar[-1]) < 1e-6  # the clip_x0 regime of the samplers


def _equation_inputs(seed=1):
    """Inputs at t = 1, 7 and 19 with x_t drawn from q(x_t | x_0) and an ε
    estimate 0.3·N(0, 1) off. v lies in [1.1, 1.3], where the t = 1 std is
    ≈ 0.5 and the discretized NLL is well conditioned in f32. Near v = 0 the
    t = 1 variance is ≈ 1e-12 and a bin's mass is the difference of two CDFs
    a few ulps below 1, where an ulp of the mean or of erf flips a pixel
    across the 1e-12 clamp (tests/test_torch_parity.py:186 keeps t = 1 out
    for that reason); the ±60 test below drives v far out."""
    r = np.random.default_rng(seed)
    n = SHAPE[0]
    sched = IDDPM.create(T).schedule
    t = np.array([1, 7, 19], np.int32)

    def col(a):
        return a.numpy()[t].reshape(n, 1, 1, 1)

    ab = col(sched.alpha_bar)
    x_0 = np.clip(r.standard_normal(SHAPE), -1, 1).astype(np.float32)
    x_0[0, 0, 0] = [1.0, -1.0, 0.5]  # the edge bins of the discretized NLL
    noise = r.standard_normal(SHAPE).astype(np.float32)
    x_t = (np.sqrt(ab) * x_0 + np.sqrt(1.0 - ab) * noise).astype(np.float32)
    eps = (noise + 0.3 * r.standard_normal(SHAPE)).astype(np.float32)
    v = r.uniform(1.1, 1.3, SHAPE).astype(np.float32)
    return dict(x_t=x_t, x_0=x_0, eps=eps, v=v, t=t, beta=col(sched.beta),
                alpha=col(sched.alpha), ab=ab,
                ab_prev=sched.alpha_bar.numpy()[t - 1].reshape(n, 1, 1, 1))


def test_iddpm_equations_match():
    d = _equation_inputs()
    tt = {k: torch.tensor(v) for k, v in d.items()}
    jj = {k: jnp.asarray(v) for k, v in d.items()}
    pairs = []
    bt = (teq.iddpm.beta_tilde(tt["beta"], tt["ab"], tt["ab_prev"]),
          jeq.iddpm.beta_tilde(jj["beta"], jj["ab"], jj["ab_prev"]))
    pairs.append(("beta_tilde", *bt))
    var = (teq.iddpm.interpolate_variance(tt["v"], tt["beta"], bt[0]),
           jeq.iddpm.interpolate_variance(jj["v"], jj["beta"], bt[1]))
    pairs.append(("interpolate_variance", *var))
    q = (teq.iddpm.true_reverse_process(tt["x_t"], tt["x_0"], tt["beta"], tt["alpha"],
                                        tt["ab"], tt["ab_prev"]),
         jeq.iddpm.true_reverse_process(jj["x_t"], jj["x_0"], jj["beta"], jj["alpha"],
                                        jj["ab"], jj["ab_prev"]))
    pairs += [("q.mean", q[0].mean, q[1].mean), ("q.std", q[0].std, q[1].std)]
    r = np.random.default_rng(2)
    mean = (d["x_0"] + 0.05 * r.standard_normal(SHAPE)).astype(np.float32)
    std = r.uniform(0.05, 0.5, SHAPE).astype(np.float32)
    p = (teq.Gaussian(torch.tensor(mean), torch.tensor(std)),
         jeq.gaussian.Gaussian(jnp.asarray(mean), jnp.asarray(std)))
    pairs.append(("discrete_nll_loss", teq.iddpm.discrete_nll_loss(tt["x_0"], p[0]),
                  jeq.iddpm.discrete_nll_loss(jj["x_0"], p[1])))
    pairs.append(("loss_vlb",
                  teq.iddpm.loss_vlb(tt["eps"], var[0], tt["x_t"], tt["t"], tt["x_0"],
                                     tt["beta"], tt["alpha"], tt["ab"], tt["ab_prev"]),
                  jeq.iddpm.loss_vlb(jj["eps"], var[1], jj["x_t"], jj["t"], jj["x_0"],
                                     jj["beta"], jj["alpha"], jj["ab"], jj["ab_prev"])))
    sched = IDDPM.create(T).schedule
    pairs.append(("cosine_schedule", teq.iddpm.cosine_schedule(T),
                  jeq.iddpm.cosine_schedule(T)))
    assert float(sched.alpha_bar[0]) == 1.0
    for name, got, want in pairs:
        assert torch.isfinite(got).all(), name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name, **EQ_TOL)


@pytest.mark.parametrize("t1", [True, False], ids=["t_eq_1", "t_gt_1"])
@pytest.mark.parametrize("v_value", [60.0, -60.0])
def test_extreme_variance_head_keeps_gradients_finite(t1, v_value):
    """v = ±60 drives exp(v·log β + (1−v)·log β̃) far past the f32 range: the
    exp clip, the variance floor before the sqrt, the q-std floor and the KL
    log-ratio from the stds must keep the hybrid loss and its gradient
    finite, at t == 1 (NLL branch) and t > 1 (KL branch)."""
    algo = IDDPM.create(T)
    d = _equation_inputs()
    eps = torch.tensor(d["eps"], requires_grad=True)
    v = torch.full(SHAPE, v_value, requires_grad=True)

    def model_fn(params, x, t, **kw):
        return torch.cat([eps, v], dim=-1)

    t = torch.full((SHAPE[0],), 1 if t1 else 9, dtype=torch.int64)
    loss = algo.loss_given(model_fn, None, torch.tensor(d["x_0"]), t, torch.tensor(d["eps"]))
    g_eps, g_v = torch.autograd.grad(loss, [eps, v])
    assert torch.isfinite(loss) and torch.isfinite(g_eps).all() and torch.isfinite(g_v).all()


# ---------------------------------------------------------------------- model

def test_from_flax_loads_strict_and_keeps_the_film_layout(jax_params):
    model = _torch_model()
    model.load_state_dict(from_flax(jax_params), strict=True)
    cond = jax_params["params"]["down_0"]["condition"]["kernel"]
    assert model.down_0.condition.weight.shape == (2 * 4, 8) == cond.T.shape
    assert model.output_conv.weight.shape[0] == 6  # ε ‖ v
    assert model.down_2.attention.num_heads == 4


def test_full_width_parameters_match_jax_tree():
    """36,168,070 parameters with the keys and shapes ``from_flax`` gives for
    the JAX tree (``jax.eval_shape``, no forward runs); built on the meta device."""
    with torch.device("meta"):
        model = t_iddpm.UNet()
    assert sum(p.numel() for p in model.parameters()) == 36_168_070
    shapes = jax.eval_shape(jax_iddpm.UNet().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)), jnp.zeros((1,), jnp.int32))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: tuple(v.shape) for k, v in from_flax(zeros).items()}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_forward_matches_jax(jax_params, switch):
    r = np.random.default_rng(3)
    x = r.standard_normal(SHAPE).astype(np.float32)
    t = np.array([1, 9, 19], np.int32)
    jmodel = jax_iddpm.UNet(**TINY, **SWITCHES[switch])
    want = np.asarray(jax.jit(jmodel.apply)(jax_params, jnp.asarray(x), jnp.asarray(t)))
    model = _torch_model(switch)
    model.load_state_dict(from_flax(jax_params), strict=True)
    with torch.no_grad():
        got = model(torch.tensor(x), torch.tensor(t, dtype=torch.int64)).numpy()
    assert got.shape == SHAPE[:3] + (6,)
    np.testing.assert_allclose(got, want, **FWD_TOL)


# ------------------------------------------------------------------- training

@pytest.fixture(scope="module")
def jax_losses(jax_params):
    """{loss_type: (loss, flat gradient)} of the JAX package, one jitted
    program for the three loss types."""
    jmodel = jax_iddpm.UNet(**TINY, fused_norm=True)
    algos = {lt: JaxIDDPM.create(T, loss_type=lt) for lt in ("hybrid", "simple", "vlb")}
    batch = tuple(jnp.asarray(a) for a in _batch(5))

    def all_losses(params):
        return {lt: jax.value_and_grad(lambda p, a=a: a.loss_given(
            as_model_fn(jmodel), p, *batch, train=True))(params) for lt, a in algos.items()}

    out = jax.jit(all_losses)(jax_params)
    return {lt: (float(loss), _flat(grads)) for lt, (loss, grads) in out.items()}


def _torch_loss_and_grads(jax_params, loss_type, switch="fused_block"):
    model = _torch_model(switch)
    algo = IDDPM.create(T, loss_type=loss_type)
    params = {k: v.requires_grad_(True) for k, v in from_flax(jax_params).items()}
    x0, t, eps = _batch(5)
    loss = algo.loss_given(_model_fn(model), params, torch.tensor(x0),
                           torch.tensor(t, dtype=torch.int64), torch.tensor(eps), train=True)
    return loss, dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


@pytest.mark.parametrize("loss_type", ["hybrid", "simple", "vlb"])
def test_loss_given_value_and_gradient_tree_match(jax_params, jax_losses, loss_type):
    loss, grads = _torch_loss_and_grads(jax_params, loss_type)
    want_loss, want = jax_losses[loss_type]
    np.testing.assert_allclose(float(loss.detach()), want_loss, **LOSS_TOL)
    assert set(want) == set(grads)
    for k, g in grads.items():
        assert torch.isfinite(g).all(), k
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), err_msg=k, **GRAD_TOL)


def test_film_gradients_through_the_fused_norm_equal_the_unfused_path(jax_params):
    """The (N, C) dγ/dβ that K2 returns at the FiLM ``norm2`` sites reach the
    ``condition`` Dense through scale + 1 without a sum over N: the fused
    path's gradient equals the unfused one's (``fused_norm=False``)."""
    _, fused = _torch_loss_and_grads(jax_params, "hybrid", "fused_norm")
    _, plain = _torch_loss_and_grads(jax_params, "hybrid", "plain")
    for k in fused:
        np.testing.assert_allclose(fused[k].numpy(), plain[k].numpy(), err_msg=k, **GRAD_TOL)
    assert float(fused["down_0.condition.weight"].abs().max()) > 0


def test_vlb_leaves_the_eps_channels_without_gradient(jax_params):
    """L_vlb sees ε_θ detached: the ε half of ``output_conv`` gets no gradient
    from it, the variance half does."""
    _, grads = _torch_loss_and_grads(jax_params, "vlb")
    w, b = grads["output_conv.weight"], grads["output_conv.bias"]
    assert float(w[:3].abs().max()) == 0.0 and float(b[:3].abs().max()) == 0.0
    assert float(w[3:].abs().max()) > 0.0 and float(b[3:].abs().max()) > 0.0


def test_loss_draws_t_then_eps_then_dropout(jax_params):
    model = _torch_model(dropout=0.3)
    algo = IDDPM.create(T)
    params = from_flax(jax_params)
    x0 = torch.tensor(_batch(6)[0])
    got = algo.loss(_model_fn(model), params, torch.Generator().manual_seed(4), x0)
    g = torch.Generator().manual_seed(4)
    t = algo.sample_timesteps(g, SHAPE[0])
    eps = torch.randn(SHAPE, generator=g)
    want = algo.loss_given(_model_fn(model), params, x0, t, eps, train=True, generator=g)
    assert float(got) == float(want) and np.isfinite(float(got))


# ------------------------------------------------------------------- sampling

@pytest.mark.parametrize("schedule", ["cosine", "linear"])
@pytest.mark.parametrize("tau", ["linear", "quadratic"])
def test_strided_tables_and_timestep_map_match(schedule, tau):
    """``timestep_map`` equal; β and α equal bit for bit when the respacing
    starts from the same ᾱ (the full tables differ by an ulp of cos or of the
    cumulative product), ᾱ (a cumulative product again) within 1e-6."""
    import dataclasses

    from dmme_tpu_torch.equations.ddpm import Schedule

    jbase = JaxIDDPM.create(1000, schedule=schedule)
    want = jbase.strided(50, tau)
    own = IDDPM.create(1000, schedule=schedule).strided(50, tau)
    same_input = dataclasses.replace(IDDPM.create(1000, schedule=schedule), schedule=Schedule(
        *(torch.tensor(np.asarray(a)) for a in jbase.schedule))).strided(50, tau)
    for got in (own, same_input):
        assert got.timesteps == 50 and got.loss_type == "hybrid"
        np.testing.assert_array_equal(got.timestep_map.numpy(), np.asarray(want.timestep_map))
        for name in ("beta", "alpha", "alpha_bar"):
            np.testing.assert_allclose(getattr(got.schedule, name).numpy(),
                                       np.asarray(getattr(want.schedule, name)), rtol=0,
                                       atol=1e-6, err_msg=name)
        assert float(got.schedule.beta.max()) < 1.0  # the float64 ratio keeps α > 0
    for name in ("beta", "alpha"):
        np.testing.assert_array_equal(getattr(same_input.schedule, name).numpy(),
                                      np.asarray(getattr(want.schedule, name)), err_msg=name)


@pytest.mark.parametrize("stride", [None, 5], ids=["full", "strided5"])
def test_ancestral_trajectory_matches(jax_params, stride):
    """The learned-variance ancestral sampler from the JAX scan's x_T, with
    its per-step ε ``normal(fold_in(scan_key, t))`` injected; every frame."""
    jalgo, talgo = JaxIDDPM.create(T), IDDPM.create(T)
    if stride:
        jalgo, talgo = jalgo.strided(stride), talgo.strided(stride)
    steps = talgo.timesteps
    jmodel = jax_iddpm.UNet(**TINY)
    rng = jax.random.PRNGKey(3)
    _, hist = jax.jit(lambda p, r: jalgo.generate(as_model_fn(jmodel), p, r, SHAPE,
                                                  history_length=steps))(jax_params, rng)
    hist = np.asarray(hist)
    x_key, scan_key = jax.random.split(rng)
    x = torch.tensor(np.asarray(jax.random.normal(x_key, SHAPE, jnp.float32)))
    model = _torch_model()
    model.load_state_dict(from_flax(jax_params), strict=True)
    fn = _model_fn(model)
    sd = from_flax(jax_params)
    with torch.no_grad():
        for k, t in enumerate(range(steps, 0, -1)):
            eps = np.asarray(jax.random.normal(jax.random.fold_in(scan_key, t), SHAPE))
            x = talgo.sampling_step(fn, sd, x, t, noise=torch.tensor(eps))
            assert torch.isfinite(x).all(), f"step {k}"
            np.testing.assert_allclose(x.numpy(), hist[k], err_msg=f"step {k}", **TRAJ_TOL)


def test_lit_iddpm_defaults_and_strided_generate(jax_params):
    lit = LitIDDPM()
    assert lit.model.fused_norm and lit.model.output_conv.weight.shape[0] == 6
    assert lit.diffusion_model.loss_type == "hybrid" and lit.strided is None
    lit = LitIDDPM(model=_torch_model(), timesteps=T, sample_steps=5)
    assert lit.sample_algorithm().timesteps == 5
    state = TrainState.create(from_flax(jax_params), lit.make_optimizer())
    x, hist = lit.generate(state, torch.Generator().manual_seed(0), SHAPE, history_length=3)
    assert x.shape == SHAPE and hist.shape == (3,) + SHAPE and torch.isfinite(x).all()
    again = lit.generate(state, torch.Generator().manual_seed(0), SHAPE)
    assert torch.equal(x, again)
    with pytest.raises(NotImplementedError, match="A.6"):
        LitIDDPM(num_classes=10)
