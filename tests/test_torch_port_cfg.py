"""Class conditioning and classifier-free guidance in the port against the JAX package.

Both frameworks run the TINY UNets in f32 on the same seeded numpy weights
(``from_flax``; the class table ``class_embed.embedding`` maps to
``class_embed.weight`` as it is). JAX and torch draws cannot match, so the
port's draws of a training loss are read back where they enter the
algorithm (``loss_given``) and handed to JAX's ``loss_given``; the label
drop mask is re-drawn from a generator seeded as the port's, which checks
that it is the first draw of a step without a datamodule (flip, drop mask,
t, ε, dropout). Tolerances are rtol/atol 1e-4, as in
tests/test_torch_port_sampling.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dmme_tpu.diffusion import DDIM as JaxDDIM
from dmme_tpu.diffusion import DDPM as JaxDDPM
from dmme_tpu.diffusion import EDM as JaxEDM
from dmme_tpu.diffusion import FlowMatching as JaxFlow
from dmme_tpu.diffusion import classifier_free as jax_cfg
from dmme_tpu.diffusion.factory import make_module_sampler as jax_module_sampler
from dmme_tpu.models import as_model_fn
from dmme_tpu.models import ddpm as jax_ddpm
from dmme_tpu.models import iddpm as jax_iddpm
from dmme_tpu.training import LitDDIM as JaxLitDDIM
from dmme_tpu.training import LitIDDPM as JaxLitIDDPM
from dmme_tpu.training.state import TrainState as JaxTrainState
from dmme_tpu_torch.data import Shapes
from dmme_tpu_torch.diffusion import DDPM, EDM, FlowMatching, classifier_free
from dmme_tpu_torch.models import ddpm as t_ddpm
from dmme_tpu_torch.models import iddpm as t_iddpm
from dmme_tpu_torch.models import init_weights
from dmme_tpu_torch.parallel.train_step import step_generator
from dmme_tpu_torch.trainer import main
from dmme_tpu_torch.training import (LitDDIM, LitDDPM, LitEDM, LitFlow, LitIDDPM, TrainState,
                                     validate)
from dmme_tpu_torch.utils.convert import from_flax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(pos_dim=4, emb_dim=8, num_groups=2, channels_per_depth=(4, 8, 16, 16),
            num_blocks=1, dropout=0.0)
K = 3  # classes; row K of the table is the null token
SHAPE = (2, 8, 8, 3)
TOL = dict(rtol=1e-4, atol=1e-4)


def _random_params(shapes, seed=0):
    """Kernels of variance 1/fan_in, GroupNorm scales near 1, small biases,
    and unit-variance class rows, so that the labels move the output."""
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


def _pair(jmod, tmod, seed=0, **kw):
    """(JAX module, params, port module, state_dict) of one conditional UNet."""
    jmodel = jmod.UNet(**TINY, num_classes=K, **kw)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros(SHAPE),
                            jnp.zeros((SHAPE[0],), jnp.int32), y=jnp.zeros((SHAPE[0],), jnp.int32))
    params = _random_params(shapes, seed)
    tmodel = tmod.UNet(**TINY, num_classes=K, **kw)
    sd = from_flax(params)
    tmodel.load_state_dict(sd, strict=True)
    return jmodel, params, tmodel.eval(), sd


@pytest.fixture(scope="module")
def ddpm_pair():
    return _pair(jax_ddpm, t_ddpm)


@pytest.fixture(scope="module")
def iddpm_pair():
    return _pair(jax_iddpm, t_iddpm, seed=1)


def _inputs(seed=0, n=SHAPE[0]):
    r = np.random.default_rng(seed)
    x = r.standard_normal((n,) + SHAPE[1:]).astype(np.float32)
    t = r.integers(1, 20, (n,)).astype(np.int32)
    return x, t


def _tfn(tmodel):
    def fn(params, x, t, **kw):
        return torch.func.functional_call(tmodel, params, (x, t), kw)
    return fn


# ------------------------------------------------------------------ the model

@pytest.mark.parametrize("switch", ["plain", "fused"])
def test_conditional_forward_matches(switch):
    """The label embedding (null row included) enters as JAX's does, under
    either kernel switch; the table has num_classes + 1 rows."""
    kw = {} if switch == "plain" else dict(fused_norm=True, fused_block=True)
    jmodel, params, tmodel, sd = _pair(jax_ddpm, t_ddpm, seed=2, **kw)
    assert params["params"]["class_embed"]["embedding"].shape == (K + 1, TINY["emb_dim"])
    assert tuple(tmodel.class_embed.weight.shape) == (K + 1, TINY["emb_dim"])
    x, t = _inputs(3)
    outs = []
    for y in ([0, K], [2, 1]):
        want = jmodel.apply(params, jnp.asarray(x), jnp.asarray(t), y=jnp.asarray(y))
        with torch.no_grad():
            got = tmodel(torch.tensor(x), torch.tensor(t), y=torch.tensor(y))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        outs.append(got)
    assert not torch.allclose(outs[0], outs[1], atol=1e-3)  # the labels move the output
    with pytest.raises(ValueError, match="needs labels y"):
        tmodel(torch.tensor(x), torch.tensor(t))


def test_feature_capture_takes_labels(ddpm_pair):
    """The encoder-cache and deep-cache entry points condition on ``y`` as
    JAX's do."""
    jmodel, params, tmodel, _ = ddpm_pair
    x, t = _inputs(4)
    y = jnp.asarray([1, K])
    _, jfeat = jmodel.apply(params, jnp.asarray(x), jnp.asarray(t), y=y, return_features=True)
    want = jmodel.apply(params, jnp.asarray(x), jnp.asarray(t) - 1, y=y, cached=jfeat)
    _, jdeep = jmodel.apply(params, jnp.asarray(x), jnp.asarray(t), y=y, cache_depth=1,
                            return_deep=True)
    want_deep = jmodel.apply(params, jnp.asarray(x), jnp.asarray(t) - 1, y=y, cache_depth=1,
                             deep_cache=jdeep)
    ty, tx, tt = torch.tensor(np.asarray(y)), torch.tensor(x), torch.tensor(t)
    with torch.no_grad():
        _, feat = tmodel(tx, tt, y=ty, return_features=True)
        got = tmodel(tx, tt - 1, y=ty, cached=feat)
        _, deep = tmodel(tx, tt, y=ty, cache_depth=1, return_deep=True)
        got_deep = tmodel(tx, tt - 1, y=ty, cache_depth=1, deep_cache=deep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_deep.numpy(), np.asarray(want_deep), **TOL)


def test_class_table_init_is_flax_default():
    """``init_weights`` draws the table as flax's ``nn.Embed`` does: normal
    with variance 1/features (``variance_scaling(1, fan_in, normal,
    out_axis=0)``), not lecun's truncated normal."""
    from flax import linen

    emb_dim, rows = 64, 4001
    # the UNet's class_embed is this module at its defaults (dmme_tpu/models/unet.py)
    jtab = np.asarray(linen.Embed(rows, emb_dim).init(
        jax.random.PRNGKey(0), jnp.zeros((1,), jnp.int32))["params"]["embedding"])
    tmodel = init_weights(t_ddpm.UNet(**dict(TINY, emb_dim=emb_dim), num_classes=rows - 1),
                          torch.Generator().manual_seed(0))
    ttab = tmodel.class_embed.weight.detach().numpy()
    assert jtab.shape == ttab.shape == (rows, emb_dim)
    for tab in (jtab, ttab):
        assert abs(tab.std() * np.sqrt(emb_dim) - 1.0) < 0.02
        assert np.abs(tab).max() * np.sqrt(emb_dim) > 3.0  # not truncated at 2σ


# ------------------------------------------------------------ the guidance

@pytest.mark.parametrize("w", [0.0, 1.0, 2.0])
@pytest.mark.parametrize("head", ["eps", "eps_v"])
def test_classifier_free_matches(ddpm_pair, iddpm_pair, w, head):
    """One doubled-batch call; ε guided, v (IDDPM's variance half) from the
    conditional branch."""
    jmodel, params, tmodel, sd = ddpm_pair if head == "eps" else iddpm_pair
    x, t = _inputs(5)
    y = [2, 0]
    want = jax_cfg(as_model_fn(jmodel), jnp.asarray(y), w, K)(params, jnp.asarray(x),
                                                               jnp.asarray(t))
    calls = []

    def counted(p, xx, tt, **kw):
        calls.append(xx.shape[0])
        return _tfn(tmodel)(p, xx, tt, **kw)

    with torch.no_grad():
        got = classifier_free(counted, torch.tensor(y), w, K)(sd, torch.tensor(x),
                                                              torch.tensor(t))
    assert calls == [2 * SHAPE[0]]
    assert got.shape == want.shape == SHAPE[:3] + ((3 if head == "eps" else 6),)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------- the harness

def _lit(family, tmodel, **kw):
    common = dict(model=tmodel, num_classes=K, **kw)
    if family == "ddpm":
        return LitDDPM(timesteps=20, **common)
    return (LitEDM if family == "edm" else LitFlow)(**common)


def _jax_algo(family):
    if family == "ddpm":
        return JaxDDPM.create(20)
    return JaxEDM.create() if family == "edm" else JaxFlow.create()


@pytest.mark.parametrize("family", ["ddpm", "edm", "flow"])
def test_labelled_loss_matches(ddpm_pair, monkeypatch, family):
    """The harness's loss on a labelled batch: cond_dropout of the labels
    dropped to the null token by the step's first draw, then the algorithm's
    draws, equal to JAX's loss on the same labels and draws."""
    jmodel, params, tmodel, sd = ddpm_pair
    lit = _lit(family, tmodel, cond_dropout=0.5)
    algo_cls = {"ddpm": DDPM, "edm": EDM, "flow": FlowMatching}[family]
    seen = {}
    orig = algo_cls.loss_given

    def spy(self, model_fn, p, x0, a, b, **kw):
        seen["draws"] = (a, b)
        return orig(self, model_fn, p, x0, a, b, **kw)

    monkeypatch.setattr(algo_cls, "loss_given", spy)
    x, _ = _inputs(6, n=8)
    y = np.arange(8) % K
    params_t = {k: v.clone() for k, v in sd.items()}
    got = lit.make_loss_fn()(params_t, torch.Generator().manual_seed(11),
                             (torch.tensor(x), torch.tensor(y)))
    drop = torch.rand(8, generator=torch.Generator().manual_seed(11)) < 0.5
    assert 0 < int(drop.sum()) < 8
    y_used = np.where(drop.numpy(), K, y)
    a, b = (np.asarray(v) for v in seen["draws"])

    def jfn(p, xt, t, **kw):
        return as_model_fn(jmodel)(p, xt, t, y=jnp.asarray(y_used), **kw)

    want = _jax_algo(family).loss_given(jfn, params, jnp.asarray(x), jnp.asarray(a),
                                        jnp.asarray(b))
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_guided_ddim_trajectory_matches(ddpm_pair):
    """``LitDDIM(num_classes, guidance_scale=2).generate(y=...)`` frame by
    frame against JAX's, from JAX's x_T (its key split: labels, then x_T)."""
    jmodel, params, tmodel, sd = ddpm_pair
    T, S = 20, 10
    y = [1, 2]
    jlit = JaxLitDDIM(model=jmodel, timesteps=T, sample_steps=S, num_classes=K,
                      guidance_scale=2.0)
    jstate = JaxTrainState.create(params, optax.adam(1e-3))
    rng = jax.random.PRNGKey(3)
    x0, hist = jax.jit(lambda s, r: jlit.generate(s, r, SHAPE, y=jnp.asarray(y),
                                                  history_length=S))(jstate, rng)
    _, rng2 = jax.random.split(rng)
    x_T = np.asarray(jax.random.normal(jax.random.split(rng2)[0], SHAPE, jnp.float32))

    lit = LitDDIM(model=tmodel, timesteps=T, sample_steps=S, num_classes=K, guidance_scale=2.0)
    state = TrainState.create({k: v.clone() for k, v in sd.items()}, lit.make_optimizer())
    got, frames = lit.generate(state, None, SHAPE, x_T=torch.tensor(x_T), y=torch.tensor(y),
                               history_length=S)
    for k in range(S):
        np.testing.assert_allclose(frames[k].numpy(), np.asarray(hist)[k], err_msg=f"step {k}",
                                   **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(x0), **TOL)
    # without y the labels are drawn from the generator, reproducibly
    a = lit.generate(state, torch.Generator().manual_seed(0), SHAPE)
    assert torch.equal(a, lit.generate(state, torch.Generator().manual_seed(0), SHAPE))


def test_iddpm_num_classes_reaches_its_default_unet():
    """``LitIDDPM(num_classes=)`` builds the conditional IDDPM UNet, as JAX's
    does (its own default model, not LitDDPM's)."""
    jlit = JaxLitIDDPM(num_classes=10)
    shapes = jax.eval_shape(jlit.model.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1,), jnp.int32), y=jnp.zeros((1,), jnp.int32))
    lit = LitIDDPM(num_classes=10)
    assert lit.model.num_classes == 10 and lit.model.down_0.film
    assert (tuple(lit.model.class_embed.weight.shape)
            == shapes["params"]["class_embed"]["embedding"].shape == (11, 512))
    assert {k: tuple(v.shape) for k, v in lit.model.state_dict().items()} == {
        k: tuple(v.shape) for k, v in from_flax(jax.tree.map(
            lambda s: np.zeros(s.shape, np.float32), shapes)).items()}


def test_guided_iddpm_generates(iddpm_pair):
    """A guided respaced IDDPM trajectory (ε guided, v conditional) is finite
    and its labels matter."""
    _, _, tmodel, sd = iddpm_pair
    lit = LitIDDPM(model=tmodel, timesteps=20, sample_steps=5, num_classes=K,
                   guidance_scale=2.0)
    state = TrainState.create({k: v.clone() for k, v in sd.items()}, lit.make_optimizer())
    x_T = torch.randn(SHAPE, generator=torch.Generator().manual_seed(1))
    a = lit.generate(state, None, SHAPE, x_T=x_T, y=torch.tensor([0, 1]))
    b = lit.generate(state, None, SHAPE, x_T=x_T, y=torch.tensor([2, 2]))
    assert torch.isfinite(a).all() and not torch.allclose(a, b)


def test_validate_conditions_on_the_true_labels():
    """``validate`` on a labelled Shapes: each batch's eval loss on its true
    labels (no dropout), from the generator of (seed, batch)."""
    model = init_weights(t_ddpm.UNet(**TINY, num_classes=2), torch.Generator().manual_seed(0))
    lit = LitDDPM(model=model, timesteps=20, num_classes=2)
    state = TrainState.create({k: v.clone() for k, v in model.state_dict().items()},
                              lit.make_optimizer())
    dm = Shapes(size=16, batch_size=4, img_size=8, with_labels=True)
    got = validate(lit, dm, state=state, seed=3, max_batches=3, device="cpu")
    assert got["num_batches"] == 3
    want = []
    for i, (x, y) in enumerate(dm.test_iter()):
        if i == 3:
            break
        x = dm.process(torch.from_numpy(x))
        fn = lit.labelled_model_fn(torch.from_numpy(y).long())
        with torch.no_grad():
            want.append(float(lit.diffusion_model.loss(fn, state.ema_params,
                                                       step_generator(3, i, "cpu"), x,
                                                       train=False)))
    np.testing.assert_allclose(got["val/loss"], np.mean(want), rtol=1e-6)


@pytest.mark.parametrize("name", ["cached", "deep", "deep_dpm"])
def test_caching_samplers_are_refused(ddpm_pair, name):
    """The feature-caching samplers bypass the guidance wrapper: refused
    with JAX's message."""
    _, _, tmodel, sd = ddpm_pair
    lit = LitDDIM(model=tmodel, timesteps=20, sample_steps=4, num_classes=K)
    state = TrainState.create({k: v.clone() for k, v in sd.items()}, lit.make_optimizer())
    with pytest.raises(ValueError) as want:
        jax_module_sampler(JaxDDIM.create(20, 4), name, conditional=True)
    with pytest.raises(ValueError) as got:
        lit.generate(state, torch.Generator().manual_seed(0), SHAPE, sampler=name)
    assert str(got.value) == str(want.value)


def test_cli_fit_of_the_cfg_demo(tmp_path, capsys):
    """``configs/ddpm/shapes_cfg_demo.yaml`` unedited but for a TINY model,
    Shapes and the step count: fit on labelled batches, validate, sample
    (guided, uniform labels) and sample with a solver override; the caching
    samplers are refused."""
    cfg = os.path.join(ROOT, "configs/ddpm/shapes_cfg_demo.yaml")
    model = ("{class_path: dmme_tpu.models.ddpm.UNet, init_args: {pos_dim: 4, emb_dim: 8, "
             "num_groups: 2, channels_per_depth: [4, 8, 8], num_blocks: 1, num_classes: 2, "
             "fused_norm: true, fused_block: true}}")
    over = ["--config", cfg, "--model.init_args.model", model,
            "--model.init_args.timesteps", "10", "--data.init_args.size", "16",
            "--data.init_args.batch_size", "4", "--data.init_args.img_size", "16",
            "--trainer.default_root_dir", str(tmp_path / "run"), "--trainer.tensorboard",
            "false", "--trainer.steps_per_call", "2", "--trainer.log_every_n_steps", "2"]
    main(["fit", *over, "--trainer.max_steps", "4"], device="cpu")
    assert os.listdir(tmp_path / "run" / "4")
    main(["validate", *over, "--trainer.limit_val_batches", "2"], device="cpu")
    assert "'val/loss'" in capsys.readouterr().out
    main(["sample", *over, "--trainer.sample_batch", "4"], device="cpu")
    main(["sample", *over, "--trainer.sampler", "ddim", "--trainer.sample_steps", "3"],
         device="cpu")
    assert sorted(os.listdir(tmp_path / "run" / "samples")) == ["step_00000004.png",
                                                                "step_00000004_ddim3.png"]
    with pytest.raises(ValueError, match="class-conditional"):
        main(["sample", *over, "--trainer.sampler", "deep"], device="cpu")
