"""``LitUpsampler`` in the port against the JAX package's.

The pooling and the bilinear resize are held against ``LitUpsampler.
downsample`` and ``jax.image.resize(..., "linear")`` on numpy inputs,
every pixel of the edges included; the loss and a DDIM trajectory run the
TINY UNet (input 2·C, output C) in f32 on the same seeded weights
(``from_flax``), the port's draws handed to JAX's ``loss_given`` and JAX's
x_T to the port, within rtol/atol 1e-4 as in
tests/test_torch_port_sampling.py. Each refusal carries JAX's message.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dmme_tpu.diffusion import DDIM as JaxDDIM
from dmme_tpu.models import ddpm as jax_ddpm
from dmme_tpu.training import LitUpsampler as JaxLitUpsampler
from dmme_tpu.training.evaluate import _reject_conditioned_input as jax_reject
from dmme_tpu.training.state import TrainState as JaxTrainState
from dmme_tpu_torch import serving
from dmme_tpu_torch.diffusion import DDIM, DDPM
from dmme_tpu_torch.models import ddpm as t_ddpm
from dmme_tpu_torch.trainer import main
from dmme_tpu_torch.training import LitUpsampler, TrainState
from dmme_tpu_torch.training.lit import resize_bilinear
from dmme_tpu_torch.utils.convert import from_flax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(in_channels=6, out_channels=3, pos_dim=4, emb_dim=8, num_groups=2,
            channels_per_depth=(4, 8, 16), num_blocks=1, dropout=0.0, attention_depths=(3,))
SHAPE = (2, 8, 8, 3)
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
def nets():
    """(JAX module, params, port module, state_dict) of the TINY upsampler UNet."""
    jmodel = jax_ddpm.UNet(**TINY)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros(SHAPE[:3] + (6,)),
                            jnp.zeros((SHAPE[0],), jnp.int32))
    params = _random_params(shapes, seed=4)
    tmodel = t_ddpm.UNet(**TINY, fused_norm=True, fused_block=True)
    sd = from_flax(params)
    tmodel.load_state_dict(sd, strict=True)
    return jmodel, params, tmodel.eval(), sd


# ------------------------------------------------------ pooling and resizing

@pytest.mark.parametrize("factor", [2, 4])
@pytest.mark.parametrize("hw", [(5, 7), (8, 8), (1, 3)])
def test_resize_matches_jax_image_resize(factor, hw):
    """Bilinear upscaling by 2 and 4 at odd and square sizes: every pixel,
    the clamped edges included, as ``jax.image.resize(..., "linear")``."""
    h, w = hw
    x = np.random.default_rng(factor * 10 + h).standard_normal((2, h, w, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, h * factor, w * factor, 3), "linear")
    got = resize_bilinear(torch.tensor(x), (h * factor, w * factor))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # the other half-pixel convention disagrees at the edges by far more than
    # the ulps of a different order of sums: the comparison tells them apart
    other = torch.nn.functional.interpolate(
        torch.tensor(x).permute(0, 3, 1, 2), size=(h * factor, w * factor), mode="bilinear",
        align_corners=True).permute(0, 2, 3, 1)
    if w > 1:
        assert np.abs(other.numpy()[:, :, 1] - np.asarray(want)[:, :, 1]).max() > 1e-2


@pytest.mark.parametrize("factor", [2, 4])
def test_downsample_matches_jax(factor):
    x = np.random.default_rng(factor).standard_normal((2, 8, 16, 3)).astype(np.float32)
    want = JaxLitUpsampler(factor=factor, model=jax_ddpm.UNet(**TINY)).downsample(jnp.asarray(x))
    got = LitUpsampler(factor=factor, model=t_ddpm.UNet(**TINY)).downsample(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        LitUpsampler(factor=3, model=t_ddpm.UNet(**TINY)).downsample(torch.tensor(x))


# --------------------------------------------------- loss and trajectory

def test_loss_matches_with_injected_draws(nets, monkeypatch):
    """The training loss: cond = resize(pool(x)) concatenated to x_t, on the
    port's t and ε, equals JAX's ``loss_given`` with its own cond."""
    jmodel, params, tmodel, sd = nets
    seen = {}
    orig = DDPM.loss_given

    def spy(self, model_fn, p, x0, t, noise, **kw):
        seen["draws"] = (t, noise)
        return orig(self, model_fn, p, x0, t, noise, **kw)

    monkeypatch.setattr(DDPM, "loss_given", spy)
    lit = LitUpsampler(factor=2, model=tmodel, timesteps=20)
    x = np.clip(np.random.default_rng(1).standard_normal((4, 8, 8, 3)), -1, 1).astype(np.float32)
    got = lit.make_loss_fn()({k: v.clone() for k, v in sd.items()},
                             torch.Generator().manual_seed(2), torch.tensor(x))
    jlit = JaxLitUpsampler(factor=2, model=jmodel, timesteps=20)
    cond = jax.image.resize(jlit.downsample(jnp.asarray(x)), x.shape, "linear")
    t, noise = (jnp.asarray(np.asarray(v)) for v in seen["draws"])
    want = jlit.diffusion_model.loss_given(jlit.bound_model_fn(cond), params, jnp.asarray(x), t,
                                           noise)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    # the eval loss binds the same conditioning
    ev = lit.eval_loss(sd, torch.Generator().manual_seed(2), torch.tensor(x))
    assert torch.isfinite(ev)


def test_generate_trajectory_matches(nets):
    """``generate(low_res=)`` with a DDIM sampler, frame by frame, from JAX's
    x_T."""
    jmodel, params, tmodel, sd = nets
    T, S = 20, 5
    low = np.random.default_rng(3).uniform(-1, 1, (2, 4, 4, 3)).astype(np.float32)
    jlit = JaxLitUpsampler(factor=2, model=jmodel,
                           diffusion_model=JaxDDIM.create(T, S, "quadratic"))
    jstate = JaxTrainState.create(params, optax.adam(1e-3))
    rng = jax.random.PRNGKey(7)
    x0, hist = jax.jit(lambda s, r: jlit.generate(s, r, low_res=jnp.asarray(low),
                                                  history_length=S))(jstate, rng)
    x_T = np.asarray(jax.random.normal(jax.random.split(rng)[0], SHAPE, jnp.float32))

    lit = LitUpsampler(factor=2, model=tmodel, diffusion_model=DDIM.create(T, S, "quadratic"))
    state = TrainState.create({k: v.clone() for k, v in sd.items()}, lit.make_optimizer())
    got, frames = lit.generate(state, None, low_res=torch.tensor(low), x_T=torch.tensor(x_T),
                               history_length=S)
    for k in range(S):
        np.testing.assert_allclose(frames[k].numpy(), np.asarray(hist)[k], err_msg=f"step {k}",
                                   **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(x0), **TOL)


# ---------------------------------------------------------------- refusals

def _message(fn):
    with pytest.raises((ValueError, NotImplementedError)) as e:
        fn()
    return type(e.value), str(e.value)


def test_refusals_carry_jax_messages(nets):
    jmodel, params, tmodel, sd = nets
    jlit = JaxLitUpsampler(factor=2, model=jmodel)
    lit = LitUpsampler(factor=2, model=tmodel)
    jstate = JaxTrainState.create(params, optax.adam(1e-3))
    state = TrainState.create({k: v.clone() for k, v in sd.items()}, lit.make_optimizer())
    low = np.zeros((2, 4, 4, 3), np.float32)
    cases = [
        (lambda: jlit.generate(jstate, jax.random.PRNGKey(0), SHAPE),
         lambda: lit.generate(state, torch.Generator(), SHAPE)),
        (lambda: jlit.generate(jstate, jax.random.PRNGKey(0), (2, 16, 16, 3),
                               low_res=jnp.asarray(low)),
         lambda: lit.generate(state, torch.Generator(), (2, 16, 16, 3), low_res=torch.tensor(low))),
        (lambda: JaxLitUpsampler(model=jmodel, num_classes=10),
         lambda: LitUpsampler(model=tmodel, num_classes=10)),
        (lambda: jax_reject(jlit, "serve"),
         lambda: serving.Sampler(lit, state, 8, device="cpu")),
        (lambda: jax_reject(jlit, "sample --trainer.sampler"),
         lambda: main(["sample", "--config", os.path.join(ROOT, "configs/ddpm/shapes_sr_demo.yaml"),
                       "--trainer.sampler", "ddim", "--trainer.default_root_dir", "/nonexistent",
                       "--trainer.img_size", "8"], device="cpu")),
    ]
    for jax_fn, port_fn in cases:
        want_type, want = _message(jax_fn)
        got_type, got = _message(port_fn)
        assert (got_type, got) == (want_type, want)


def test_default_model_and_channels():
    lit = LitUpsampler(factor=2)
    assert lit.model_in_channels() == 6 and lit.model.input_conv.weight.shape[1] == 6
    assert lit.model.output_conv.weight.shape[0] == 3 and lit.model.fused_norm
    with pytest.raises(ValueError, match="at least 2"):
        LitUpsampler(factor=1)


def test_cli_fit_of_the_sr_demo(tmp_path):
    """``configs/ddpm/shapes_sr_demo.yaml`` with a narrower UNet, fewer
    images and steps: fit (the conditioning built inside the loss), then
    ``generate(low_res=)`` on the restored checkpoint; ``serve`` refused."""
    from dmme_tpu_torch import config as tcfg
    from dmme_tpu_torch.training import CheckpointManager

    over = ["--config", os.path.join(ROOT, "configs/ddpm/shapes_sr_demo.yaml"),
            "--model.init_args.timesteps", "10",
            "--model.init_args.model.init_args.channels_per_depth", "[4, 8, 8]",
            "--model.init_args.model.init_args.num_groups", "2",
            "--model.init_args.model.init_args.emb_dim", "16",
            "--model.init_args.model.init_args.pos_dim", "8",
            "--data.init_args.size", "16", "--data.init_args.batch_size", "4",
            "--data.init_args.img_size", "16", "--trainer.log_every_n_steps", "1",
            "--trainer.default_root_dir", str(tmp_path / "run")]
    main(["fit", *over, "--trainer.max_steps", "3"], device="cpu")
    cfg = tcfg.validate_config(tcfg.apply_overrides(tcfg.load_config(over[1]), over[2:]))
    lit = tcfg.instantiate(cfg["model"])
    state = CheckpointManager(str(tmp_path / "run")).restore(lit.init_state(0, device="cpu"))
    assert int(state.step) == 3
    low = torch.rand((2, 8, 8, 3), generator=torch.Generator().manual_seed(0)) * 2 - 1
    out = lit.generate(state, torch.Generator().manual_seed(0), low_res=low)
    assert out.shape == (2, 16, 16, 3) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="serve has no conditioning source"):
        main(["serve", *over, "--trainer.port", "0"], device="cpu")
