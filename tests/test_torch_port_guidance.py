"""The port's classifier guidance and noisy-classifier training against JAX's.

The TINY ADM widths of tests/test_adm.py at 16×16, T = 50: a
class-conditional ADM generator driven as an ε model (``eps_only``, labels
bound) and the noisy classifier, on seeded random weights carried across by
``from_flax``. ``classifier_grad`` against ``jax.grad``; one guided DDIM
step, one guided DDPM step (the JAX step's own ε injected) and a 3-step
guided DDIM ``guided_generate`` from the same x_T against JAX's jitted
ones; the classifier's loss core and parameter gradients against the same
composition in JAX; three ``ClipAdam(weight_decay=0.05)`` steps against
``optax.chain(clip_by_global_norm, adamw)``; and a 2-step labelled ``fit``.
Tolerances are tests/test_torch_port_iddpm.py's ``LOSS_TOL``, ``GRAD_TOL``
and ``TRAJ_TOL``. Each JAX program is jitted once per module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dmme_tpu
import dmme_tpu.equations as jeq
import dmme_tpu_torch
from dmme_tpu.diffusion import ClassifierGuidedDDIM as JaxGuidedDDIM
from dmme_tpu.diffusion import ClassifierGuidedDDPM as JaxGuidedDDPM
from dmme_tpu.diffusion import DDPM as JaxDDPM
from dmme_tpu.diffusion.guidance import classifier_grad as jax_classifier_grad
from dmme_tpu.models import adm as jax_adm
from dmme_tpu.training import LitClassifier as JaxLitClassifier
from dmme_tpu.utils import noise as jax_noise
from dmme_tpu_torch.data import CIFAR10
from dmme_tpu_torch.diffusion import (DDPM, ClassifierGuidedDDIM, ClassifierGuidedDDPM,
                                      classifier_grad)
from dmme_tpu_torch.models import adm as t_adm
from dmme_tpu_torch.models import eps_only
from dmme_tpu_torch.training import LitClassifier, TrainState, fit
from dmme_tpu_torch.utils import noise as t_noise
from dmme_tpu_torch.utils.convert import from_flax

torch.set_num_threads(1)

TINY = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
            attention_resolutions=(8,), num_head_channels=16)
IMG, N, T, CLASSES = 16, 2, 50, 10
SHAPE = (N, IMG, IMG, 3)
SCALE = 3.0
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_TOL = dict(rtol=2e-3, atol=1e-5)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)
Y = np.array([3, 8], np.int32)


def random_params(shapes, seed):
    """Seeded values for a JAX tree: kernels of variance 1/fan_in (the
    zero-initialised ones too), GroupNorm scales near 1, non-zero biases,
    unit-variance label embeddings."""
    r = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            v = r.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * r.standard_normal(leaf.shape)
        elif name == "embedding":
            v = r.standard_normal(leaf.shape)
        else:
            v = 0.1 * r.standard_normal(leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


class Pair:
    """One model in both frameworks on the same weights: JAX (module,
    params, fn) and the port (module, state_dict, fn)."""

    def __init__(self, jm, tm, params, jfn, tfn):
        self.jm, self.tm, self.params, self.jfn, self.tfn = jm, tm, params, jfn, tfn
        self.sd = from_flax(params)
        tm.load_state_dict(self.sd, strict=True)


@pytest.fixture(scope="module")
def models():
    x, t = jnp.zeros(SHAPE), jnp.zeros((N,), jnp.int32)
    jg, tg = jax_adm.ADMG(IMG, num_classes=CLASSES, **TINY), t_adm.ADMG(IMG, CLASSES, **TINY)
    gp = random_params(jax.eval_shape(jg.init, jax.random.PRNGKey(0), x, t, t), 0)

    def jgen(params, xx, tt, **kw):  # ε of ε ‖ v, labels bound (tests/test_adm.py)
        return jnp.split(jg.apply(params, xx, tt, jnp.asarray(Y)), 2, axis=-1)[0]

    def tgen_full(params, xx, tt, **kw):
        return torch.func.functional_call(tg, params, (xx, tt, torch.tensor(Y)), kw)

    jc, tc = jax_adm.classifier(IMG, CLASSES, **TINY), t_adm.classifier(IMG, CLASSES, **TINY)
    cp = random_params(jax.eval_shape(jc.init, jax.random.PRNGKey(0), x, t), 1)

    def jclf(params, xx, tt, **kw):
        return jc.apply(params, xx, tt)

    def tclf(params, xx, tt, **kw):
        return torch.func.functional_call(tc, params, (xx, tt), kw)

    return Pair(jg, tg, gp, jgen, eps_only(tgen_full)), Pair(jc, tc, cp, jclf, tclf)


def _x(seed):
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(np.float32)


def test_classifier_grad_matches_jax_grad(models):
    _, clf = models
    x, t = _x(0), np.array([5, 33], np.int32)
    want = jax.jit(lambda p, x, t: jax_classifier_grad(clf.jfn, p, Y, x, t))(clf.params, x, t)
    got = classifier_grad(clf.tfn, clf.sd, torch.tensor(Y), torch.tensor(x), torch.tensor(t))
    assert got.dtype == torch.float32 and got.shape == SHAPE
    assert float(got.abs().max()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


def test_classifier_grad_works_inside_a_no_grad_sampler(models):
    """The samplers run under ``torch.no_grad()``; the gradient is the same
    there, no parameter collects a ``.grad``, and grad mode is restored."""
    _, clf = models
    x, t = torch.tensor(_x(1)), torch.tensor([9, 9])
    params = {k: v.clone().requires_grad_(True) for k, v in clf.sd.items()}

    @torch.no_grad()
    def sampler():
        g = classifier_grad(clf.tfn, params, Y, x, t)
        assert not torch.is_grad_enabled()
        return g

    inside = sampler()
    outside = classifier_grad(clf.tfn, params, Y, x, t)
    torch.testing.assert_close(inside, outside, rtol=0, atol=0)
    assert float(inside.abs().max()) > 0 and not inside.requires_grad
    assert all(p.grad is None for p in params.values())


def test_guided_ddim_step_and_generate_match_jax(models):
    """One guided DDIM step at i = 2, and the 3-step ``guided_generate`` from
    the same x_T (the linear schedule of ``create``, which equals JAX's)."""
    gen, clf = models
    jalgo = JaxGuidedDDIM.create(timesteps=T, sub_timesteps=3, guidance_scale=SCALE)
    talgo = ClassifierGuidedDDIM.create(timesteps=T, sub_timesteps=3, guidance_scale=SCALE)
    assert torch.equal(talgo.tau, torch.tensor(np.asarray(jalgo.tau), dtype=torch.int64))
    np.testing.assert_allclose(talgo.schedule.alpha_bar.numpy(),
                               np.asarray(jalgo.schedule.alpha_bar), rtol=0, atol=1e-6)
    # the JAX tables, so that the port's steps see the same ᾱ bit for bit
    talgo = dataclasses.replace(talgo, schedule=type(talgo.schedule)(
        *(torch.tensor(np.asarray(a)) for a in jalgo.schedule)))
    x = _x(2)
    want = jax.jit(lambda gp, cp, x: jalgo.guided_sampling_step(
        gen.jfn, gp, clf.jfn, cp, Y, x, 2))(gen.params, clf.params, x)
    with torch.no_grad():
        got = talgo.guided_sampling_step(gen.tfn, gen.sd, clf.tfn, clf.sd, Y, torch.tensor(x), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TRAJ_TOL)

    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda gp, cp: jalgo.guided_generate(
        gen.jfn, gp, clf.jfn, cp, Y, key, SHAPE))(gen.params, clf.params)
    x_T = torch.tensor(np.asarray(jax.random.normal(key, SHAPE, jnp.float32)))
    got = talgo.guided_generate(gen.tfn, gen.sd, clf.tfn, clf.sd, Y, None, SHAPE, x_T=x_T)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TRAJ_TOL)


RNG = jax.random.PRNGKey(11)


@pytest.fixture(scope="module")
def guided_ddpm(models):
    """(JAX algorithm, its guided step jitted once, the port's algorithm on
    the JAX tables)."""
    gen, clf = models
    jalgo = JaxGuidedDDPM.create(timesteps=T, guidance_scale=SCALE)
    talgo = ClassifierGuidedDDPM.create(timesteps=T, guidance_scale=SCALE)
    talgo = dataclasses.replace(talgo, schedule=type(talgo.schedule)(
        *(torch.tensor(np.asarray(a)) for a in jalgo.schedule)))
    step = jax.jit(lambda gp, cp, x, t: jalgo.guided_sampling_step(
        gen.jfn, gp, clf.jfn, cp, Y, x, t, RNG))
    return jalgo, step, talgo


@pytest.mark.parametrize("t", [20, 1])
def test_guided_ddpm_step_matches_jax(models, guided_ddpm, t):
    """One ancestral step, then s·∇ at the new x and the same t; the JAX
    step's own ε (``normal(rng)``) injected; at t = 1 the mean."""
    gen, clf = models
    _, step, talgo = guided_ddpm
    x = _x(3)
    want = step(gen.params, clf.params, x, jnp.int32(t))
    noise = torch.tensor(np.asarray(jax.random.normal(RNG, SHAPE, jnp.float32)))
    with torch.no_grad():
        got = talgo.guided_sampling_step(gen.tfn, gen.sd, clf.tfn, clf.sd, Y, torch.tensor(x),
                                         t, noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TRAJ_TOL)


def test_guided_ddpm_generate_draws_x_then_each_steps_noise():
    """``guided_generate`` from one generator: x_T, then each step's ε, in
    order; equal to the steps driven by hand with those draws."""
    def model_fn(p, x, t):
        return 0.1 * x

    def clf_fn(p, x, t):
        return torch.stack([x.mean((1, 2, 3)), -x.mean((1, 2, 3))], -1)

    algo = ClassifierGuidedDDPM.create(timesteps=3, guidance_scale=2.0)
    got = algo.guided_generate(model_fn, None, clf_fn, None, [0, 1],
                               torch.Generator().manual_seed(5), (2, 4, 4, 3))
    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, 4, 4, 3), generator=g)
    for t in (3, 2, 1):
        x = algo.guided_sampling_step(model_fn, None, clf_fn, None, [0, 1], x, t,
                                      noise=torch.randn((2, 4, 4, 3), generator=g))
    torch.testing.assert_close(got, x, rtol=0, atol=0)


def _lits(clf):
    jlit = JaxLitClassifier(model=clf.jm, diffusion_model=JaxDDPM.create(20), lr=1e-3, warmup=2)
    tlit = LitClassifier(model=clf.tm, diffusion_model=DDPM.create(20), lr=1e-3, warmup=2)
    return jlit, tlit


def test_classifier_loss_and_gradients_match_jax(models):
    """Cross-entropy of the f32 logits at q_sample(x₀, ᾱ_t, ε), and every
    parameter's gradient, against the same composition in JAX (the body of
    ``dmme_tpu/training/classifier.py:loss_fn`` with t and ε injected)."""
    _, clf = models
    jlit, tlit = _lits(clf)
    r = np.random.default_rng(4)
    x0 = np.clip(r.standard_normal(SHAPE), -1, 1).astype(np.float32)
    t = np.array([1, 13], np.int32)
    noise = r.standard_normal(SHAPE).astype(np.float32)

    def jloss(params):
        ab = jlit.diffusion_model.schedule.alpha_bar[t].reshape(-1, 1, 1, 1)
        x_t = jeq.ddpm.q_sample(x0, ab, noise)
        logits = jlit.model_fn(params, x_t, t, train=True).astype(jnp.float32)
        return optax.softmax_cross_entropy_with_integer_labels(logits, Y).mean()

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(clf.params)
    params = {k: v.clone().requires_grad_(True) for k, v in clf.sd.items()}
    loss = tlit.loss_given(params, torch.tensor(x0), torch.tensor(Y), torch.tensor(t),
                           torch.tensor(noise), train=True)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(want), **LOSS_TOL)
    jflat = from_flax(jgrads)
    assert set(jflat) == set(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jflat[k].numpy(), err_msg=k, **GRAD_TOL)

    # the accuracy probe at t = 1
    jacc = jax.jit(lambda p: jlit.accuracy(p, (jnp.asarray(x0), jnp.asarray(Y)), None))(
        clf.params)
    assert float(tlit.accuracy(clf.sd, (torch.tensor(x0), torch.tensor(Y)))) == float(jacc)


def test_classifier_loss_draws_flip_then_t_then_eps(models):
    """``make_loss_fn`` draws the flip, t, then ε from the step's generator,
    as JAX splits its key, and takes ``loss_given`` on them."""
    _, clf = models
    _, tlit = _lits(clf)
    dm = CIFAR10(synthetic=True, synthetic_size=8, batch_size=N, with_labels=True)
    dm.setup("fit")
    images, labels = (torch.tensor(a) for a in next(dm.train_iter(0)))
    got = tlit.make_loss_fn(dm)(clf.sd, torch.Generator().manual_seed(3), (images, labels))
    g = torch.Generator().manual_seed(3)
    x0 = dm.train_transform(g, images)
    t = tlit.diffusion_model.sample_timesteps(g, N)
    noise = torch.randn(x0.shape, generator=g)
    want = tlit.loss_given(clf.sd, x0, labels, t, noise, train=True, generator=g)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_three_adamw_steps_match_optax():
    """``ClipAdam(weight_decay=0.05)`` (the classifier's optimizer) against
    ``optax.chain(clip_by_global_norm, adamw(warmup_schedule, 0.05))`` over
    three steps, the clip active at the first."""
    jlit = JaxLitClassifier(model=object(), diffusion_model=JaxDDPM.create(10), lr=1e-2,
                            warmup=2, grad_clip=1.0)
    tlit = LitClassifier(model=torch.nn.Linear(1, 1), diffusion_model=DDPM.create(10),
                         lr=1e-2, warmup=2, grad_clip=1.0)
    r = np.random.default_rng(0)
    params = {"a.weight": r.standard_normal((4, 3)).astype(np.float32),
              "b.bias": r.standard_normal((5,)).astype(np.float32)}
    tx = jlit.make_optimizer()
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    topt = tlit.make_optimizer()
    assert topt.weight_decay == 0.05
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    tstate = topt.init(tparams)
    for k in range(3):
        grads = {n: (r.standard_normal(v.shape) * (4.0 if k == 0 else 0.1)).astype(np.float32)
                 for n, v in params.items()}
        updates, jstate = tx.update({n: jnp.asarray(g) for n, g in grads.items()}, jstate,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)
        topt.update_({n: torch.tensor(g) for n, g in grads.items()}, tstate, tparams)
        adam = jstate[1][0]
        for n in params:
            np.testing.assert_allclose(tparams[n].numpy(), np.asarray(jparams[n]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"step {k + 1} {n}")
            np.testing.assert_allclose(tstate.mu[n].numpy(), np.asarray(adam.mu[n]), rtol=1e-6,
                                       atol=1e-8)
            np.testing.assert_allclose(tstate.nu[n].numpy(), np.asarray(adam.nu[n]), rtol=1e-6,
                                       atol=1e-9)


def test_labelled_fit_two_steps(capsys):
    lit = LitClassifier(model=t_adm.classifier(32, CLASSES, **dict(
        TINY, attention_resolutions=(16,))), diffusion_model=DDPM.create(20), warmup=10)
    dm = CIFAR10(synthetic=True, synthetic_size=16, batch_size=8, with_labels=True)
    state = fit(lit, dm, max_steps=2, log_every=1, device="cpu")
    assert isinstance(state, TrainState) and state.step == 2
    assert "[step 2]" in capsys.readouterr().err


def test_noise_helpers():
    """``gaussian``/``gaussian_like``/``uniform_int`` of a generator, as the
    JAX helpers are of a key: shapes, dtypes, and uniform_int's exclusive
    upper bound (DDPM's t ∈ [1, T))."""
    g = torch.Generator().manual_seed(0)
    a = t_noise.gaussian(g, (3, 4))
    assert a.shape == (3, 4) and a.dtype == torch.float32
    like = t_noise.gaussian_like(torch.Generator().manual_seed(0), torch.zeros(3, 4,
                                                                            dtype=torch.float64))
    assert like.dtype == torch.float64 and like.shape == (3, 4)
    torch.testing.assert_close(t_noise.gaussian(torch.Generator().manual_seed(0), (3, 4)), a)
    ints = t_noise.uniform_int(torch.Generator().manual_seed(1), 1, 4, 4000)
    jints = np.asarray(jax_noise.uniform_int(jax.random.PRNGKey(1), 1, 4, 4000))
    assert ints.shape == jints.shape == (4000,)
    assert set(ints.tolist()) == set(jints.tolist()) == {1, 2, 3}
    assert jax_noise.gaussian(jax.random.PRNGKey(0), (3, 4)).shape == a.shape


def test_package_root_reexports_what_is_ported():
    """The port's root exports the JAX root's names but those that wait for
    ROADMAP A.12 (LSUN, ImageFolder64, datasets)."""
    waiting = {"datasets", "LSUN", "ImageFolder64"}
    assert set(dmme_tpu_torch.__all__) == set(dmme_tpu.__all__) - waiting | {"callbacks"}
    for name in dmme_tpu_torch.__all__:
        assert getattr(dmme_tpu_torch, name) is not None, name
    assert dmme_tpu_torch.diffusion_models is dmme_tpu_torch.diffusion
    assert dmme_tpu_torch.LitClassifier is LitClassifier
