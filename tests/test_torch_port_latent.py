"""Latent diffusion in the port against the JAX package: the KL-VAE codec,
``LitVAE``, the latent seam and ``LitLatentDDPM``/``LitLatentFlow``.

Both frameworks run TINY widths in f32 on the same seeded numpy weights
(``from_flax``): a VAE of base width 16 at factor 2 and 4, the TINY UNet
and DiT of tests/test_torch_port_cfg.py and tests/test_torch_port_dit.py at
latent width. Every bias, GroupNorm affine and zero-initialised kernel is
drawn, so a dropped term shows. JAX and torch draws cannot match: the
port's draws are read back where they enter (the posterior noise of
``encode_target``, the algorithm's ``loss_given``) and handed to JAX's
functions. Tolerances: rtol/atol 1e-4 for values, 2e-3/1e-5 for gradients
(tests/test_torch_port_training.py's), 1e-6 relative for the latent scale.
The two-stage recipe then runs through ``trainer.main`` on the repo's
latent configs at TINY widths, and every sampling surface is held to
``lit.generate`` at the image shape.
"""

import json
import os
import threading
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmme_tpu.data import Shapes as JaxShapes
from dmme_tpu.models import ddpm as jax_ddpm
from dmme_tpu.models import dit as jax_dit
from dmme_tpu.models import vae as jax_vae
from dmme_tpu.training import latent as jax_latent
from dmme_tpu_torch.data import Shapes
from dmme_tpu_torch.diffusion import DDPM, FlowMatching
from dmme_tpu_torch.models import ddpm as t_ddpm
from dmme_tpu_torch.models import dit as t_dit
from dmme_tpu_torch.models import init_weights
from dmme_tpu_torch.models import vae as t_vae
from dmme_tpu_torch.models.vae import ConvVAE
from dmme_tpu_torch.parallel.train_step import step_generator
from dmme_tpu_torch.trainer import main
from dmme_tpu_torch.training import (CheckpointManager, LitDDPM, LitLatentDDPM, LitLatentFlow,
                                     LitVAE, TrainState)
from dmme_tpu_torch.training import latent as t_latent
from dmme_tpu_torch.training.loggers import _to_png
from dmme_tpu_torch.utils.convert import from_flax
from dmme_tpu_torch.utils.norm import denorm
from dmme_tpu_torch.utils.vis import make_history

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=2e-3, atol=1e-5)
VAE = {2: dict(latent_channels=4, base_channels=16, channel_multipliers=(1, 2),
               num_res_blocks=1),
       4: dict(latent_channels=4, base_channels=16, channel_multipliers=(1, 2, 2),
               num_res_blocks=1)}
UNET = dict(in_channels=4, pos_dim=4, emb_dim=8, num_groups=2, channels_per_depth=(4, 8, 16, 16),
            num_blocks=1, dropout=0.0)
DIT = dict(in_channels=4, patch_size=2, hidden=32, depth=2, num_heads=2, pos_dim=16)
IMG = (2, 16, 16, 3)
SCALE = 0.75


def _random_params(shapes, seed):
    """Kernels of variance 1/fan_in, GroupNorm scales 1 + 0.1·N(0, 1), every
    other leaf (biases, GroupNorm biases) 0.1·N(0, 1)."""
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


@pytest.fixture(scope="module", params=[2, 4], ids=["factor2", "factor4"])
def vae_pair(request):
    """(factor, JAX ConvVAE, flax params, port ConvVAE, state_dict), one set
    of weights initialised at 8 px."""
    f = request.param
    jvae = jax_vae.ConvVAE(**VAE[f])
    shapes = jax.eval_shape(jvae.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)),
                            jax.random.PRNGKey(1))
    params = _random_params(shapes, seed=f)
    tvae = ConvVAE(**VAE[f])
    sd = from_flax(params)
    tvae.load_state_dict(sd, strict=True)
    return f, jvae, params, tvae, sd


@pytest.fixture(scope="module")
def vae2():
    jvae = jax_vae.ConvVAE(**VAE[2])
    shapes = jax.eval_shape(jvae.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)),
                            jax.random.PRNGKey(1))
    params = _random_params(shapes, seed=2)
    return jvae, params, from_flax(params)


def _images(seed, shape=IMG):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


# ------------------------------------------------------------------ the codec

@pytest.mark.parametrize("size", [8, 16])
def test_vae_matches_jax(vae_pair, size):
    """encode, decode and the reparameterised forward on injected noise, at
    two image sizes from one set of weights."""
    f, jvae, params, tvae, sd = vae_pair
    x = _images(size, (2, size, size, 3))
    jmean, jlogvar = jvae.apply(params, jnp.asarray(x), method=jax_vae.ConvVAE.encode)
    noise = np.random.default_rng(5).standard_normal(jmean.shape).astype(np.float32)
    with torch.no_grad():
        mean, logvar = tvae.encode(torch.tensor(x))
        rec = tvae.decode(mean)
        fwd, fmean, flogvar = tvae(torch.tensor(x), torch.tensor(noise))
    assert mean.shape == (2, size // f, size // f, 4) and mean.dtype == torch.float32
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), **TOL)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(jlogvar), **TOL)
    jrec = jvae.apply(params, jmean, method=jax_vae.ConvVAE.decode)
    assert rec.shape == x.shape
    np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), **TOL)
    jz = jmean + jnp.exp(0.5 * jlogvar) * jnp.asarray(noise)
    jfwd = jvae.apply(params, jz, method=jax_vae.ConvVAE.decode)
    np.testing.assert_allclose(fwd.numpy(), np.asarray(jfwd), **TOL)
    assert torch.equal(fmean, mean) and torch.equal(flogvar, logvar)
    # the functional forms the harnesses call bind the same weights
    got = t_vae.encode(tvae, sd, torch.tensor(x))[0]
    np.testing.assert_allclose(got.numpy(), mean.numpy(), rtol=0, atol=0)


def test_vae_bf16_keeps_the_moments_and_output_in_f32(vae2):
    _, _, sd = vae2
    tvae = ConvVAE(**VAE[2], dtype=torch.bfloat16)
    tvae.load_state_dict(sd)
    with torch.no_grad():
        mean, logvar = tvae.encode(torch.tensor(_images(0)))
        out = tvae.decode(mean)
    assert mean.dtype == logvar.dtype == out.dtype == torch.float32


def test_logvar_clip_matches_jax(vae2):
    """A moments bias of ±100 drives logvar past both bounds: the port and
    JAX clip it to the same [−30, 20]."""
    jvae, params, _ = vae2
    params = jax.tree_util.tree_map(np.array, params)
    bias = params["params"]["encoder"]["moments"]["bias"]
    bias[4:6], bias[6:] = 100.0, -100.0
    tvae = ConvVAE(**VAE[2])
    tvae.load_state_dict(from_flax(params), strict=True)
    x = _images(1)
    _, jlogvar = jvae.apply(params, jnp.asarray(x), method=jax_vae.ConvVAE.encode)
    with torch.no_grad():
        _, logvar = tvae.encode(torch.tensor(x))
    assert float(logvar[..., :2].min()) == 20.0 and float(logvar[..., 2:].max()) == -30.0
    np.testing.assert_array_equal(logvar.numpy(), np.asarray(jlogvar))


def test_kl_divergence_golden():
    z = torch.zeros((4, 3))
    assert float(t_vae.kl_divergence(z, z)) == 0.0
    mean, logvar = torch.tensor([[1.0, -2.0]]), torch.tensor([[0.5, -1.0]])
    want = 0.5 * np.mean(np.array([1.0, 4.0]) + np.exp([0.5, -1.0]) - 1.0
                         - np.array([0.5, -1.0]))
    np.testing.assert_allclose(float(t_vae.kl_divergence(mean, logvar)), want, rtol=1e-6)
    r = np.random.default_rng(0)
    m, lv = (r.standard_normal((2, 4, 4, 4)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(float(t_vae.kl_divergence(torch.tensor(m), torch.tensor(lv))),
                               float(jax_vae.kl_divergence(jnp.asarray(m), jnp.asarray(lv))),
                               rtol=1e-6)


@pytest.mark.parametrize("config", ["shapes_vae_demo", "default"])
def test_parameter_counts_and_names_match_flax(config):
    """The configs' codec (latent 4, base 64, multipliers 1 and 2, 2 blocks)
    and the default ConvVAE, built on the meta device, hold exactly the
    parameters of ``jax.eval_shape`` of JAX's init, under flax's names."""
    kw = (dict(latent_channels=4, base_channels=64, channel_multipliers=(1, 2),
               num_res_blocks=2) if config != "default" else {})
    shapes = jax.eval_shape(jax_vae.ConvVAE(**kw).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)), jax.random.PRNGKey(1))
    want = {k: tuple(v.shape) for k, v in from_flax(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    with torch.device("meta"):
        tvae = ConvVAE(**kw)
    assert {k: tuple(v.shape) for k, v in tvae.state_dict().items()} == want
    if config != "default":
        assert sum(int(np.prod(s)) for s in want.values()) == 1_542_219
        assert "decoder.upsample_1.Conv_0.weight" in want and "encoder.down_1_0.skip.weight" in want


# ------------------------------------------------------------------ LitVAE

def _jax_state(params):
    return types.SimpleNamespace(params=params, ema_params=params)


def test_litvae_loss_and_gradient_match_jax(vae2):
    """JAX's loss_fn on a key against the port's ``loss_given`` on the noise
    that key's split draws; then the eval loss (posterior mean decoded)."""
    jvae, params, sd = vae2
    jlit = jax_latent.LitVAE(model=jvae, kl_weight=0.3)
    lit = LitVAE(model=ConvVAE(**VAE[2]), kl_weight=0.3)
    x = _images(3)
    rng = jax.random.PRNGKey(7)
    jloss, jgrad = jax.value_and_grad(jlit.make_loss_fn())(params, rng, jnp.asarray(x))
    noise = jax.random.normal(jax.random.split(rng)[0], (2, 8, 8, 4), jnp.float32)
    tparams = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
    loss = lit.loss_given(tparams, torch.tensor(x), torch.tensor(np.asarray(noise)))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    grads = dict(zip(tparams, torch.autograd.grad(loss, list(tparams.values()))))
    want = from_flax(jax.tree_util.tree_map(np.asarray, jgrad))
    assert set(grads) == set(want)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), err_msg=k, **GRAD_TOL)
    got = lit.eval_loss(sd, None, torch.tensor(x))
    np.testing.assert_allclose(float(got), float(jlit.eval_loss(params, rng, jnp.asarray(x))),
                               **TOL)


def test_litvae_loss_draws_noise_after_the_flip(vae2):
    """With a datamodule the step's generator draws the flip, then the
    posterior noise; ``loss_fn`` equals ``loss_given`` on those draws."""
    _, _, sd = vae2
    lit = LitVAE(model=ConvVAE(**VAE[2]))
    dm = Shapes(size=8, batch_size=2, img_size=16)
    batch = torch.randint(0, 256, IMG, generator=torch.Generator().manual_seed(0),
                          dtype=torch.uint8)
    got = lit.make_loss_fn(dm)(sd, torch.Generator().manual_seed(4), batch)
    g = torch.Generator().manual_seed(4)
    x = dm.train_transform(g, batch)
    noise = torch.randn((2, 8, 8, 4), generator=g)
    assert torch.equal(got, lit.loss_given(sd, x, noise))


def test_litvae_generate_and_reconstruct(vae2):
    """Prior samples decoded at the image shape (the history the sample
    repeated), and the deterministic round trip, against JAX's decode and
    ``reconstruct``."""
    jvae, params, sd = vae2
    lit = LitVAE(model=ConvVAE(**VAE[2]))
    state = TrainState.create(sd, lit.make_optimizer())
    out = lit.generate(state, torch.Generator().manual_seed(1), IMG)
    z = torch.randn((2, 8, 8, 4), generator=torch.Generator().manual_seed(1))
    jout = jvae.apply(params, jnp.asarray(z.numpy()), method=jax_vae.ConvVAE.decode)
    assert out.shape == IMG
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    final, hist = lit.generate(state, torch.Generator().manual_seed(1), IMG, history_length=3)
    assert torch.equal(final, out) and hist.shape == (3,) + IMG
    assert all(torch.equal(h, out) for h in hist)
    x = _images(4)
    jrec = jax_latent.LitVAE(model=jvae).reconstruct(_jax_state(params), jnp.asarray(x))
    np.testing.assert_allclose(lit.reconstruct(state, torch.tensor(x)).numpy(),
                               np.asarray(jrec), **TOL)
    assert lit.num_classes is None


# -------------------------------------------------------------- the latent seam

def test_pixel_harness_hooks_are_the_identity_and_draw_nothing():
    lit = LitDDPM(model=t_ddpm.UNet(**dict(UNET, in_channels=3)), timesteps=10)
    g = torch.Generator().manual_seed(3)
    before = g.get_state()
    x = torch.tensor(_images(0))
    assert lit.encode_target(g, x) is x and lit.encode_eval(x) is x
    assert torch.equal(g.get_state(), before)
    assert lit.sample_space_shape(IMG) == IMG and lit.to_images(x) is x


def _latent_pair(vae2, family="ddpm", **kw):
    """(JAX harness, port harness, denoiser flax params, port state_dict)."""
    jvae, vparams, vsd = vae2
    if family == "ddpm":
        jmodel, tmodel = jax_ddpm.UNet(**UNET), t_ddpm.UNet(**UNET)
        jcls, tcls, common = jax_latent.LitLatentDDPM, LitLatentDDPM, dict(timesteps=20)
    else:
        jmodel, tmodel = jax_dit.DiT(**DIT), t_dit.DiT(**DIT)
        jcls, tcls, common = jax_latent.LitLatentFlow, LitLatentFlow, {}
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((2, 8, 8, 4)),
                            jnp.zeros((2,), jnp.int32))
    params = _random_params(shapes, seed=9)
    sd = from_flax(params)
    tmodel.load_state_dict(sd, strict=True)
    jlit = jcls(vae=jvae, vae_params=vparams, latent_scale=SCALE, model=jmodel, **common, **kw)
    tlit = tcls(vae=ConvVAE(**VAE[2]), vae_params=vsd, latent_scale=SCALE, model=tmodel,
                **common, **kw)
    return jlit, tlit, params, sd


def test_encode_target_and_eval_match_jax(vae2):
    """JAX's ``encode_target`` on a key against the port's on the noise of
    that key's first split, the scale applied; ``encode_eval`` the scaled
    mean. The port's ``vae_params`` may be the flax tree itself."""
    jlit, tlit, _, _ = _latent_pair(vae2)
    flax_lit = LitLatentDDPM(vae=ConvVAE(**VAE[2]), vae_params=vae2[1], latent_scale=SCALE,
                             model=t_ddpm.UNet(**UNET), timesteps=20)
    x = _images(5)
    rng = jax.random.PRNGKey(11)
    jz, _ = jlit.encode_target(rng, jnp.asarray(x))
    noise = jax.random.normal(jax.random.split(rng)[0], jz.shape, jnp.float32)
    for lit in (tlit, flax_lit):
        z = lit.encode_target(None, torch.tensor(x), noise=torch.tensor(np.asarray(noise)))
        assert z.shape == (2, 8, 8, 4) and not z.requires_grad
        np.testing.assert_allclose(z.numpy(), np.asarray(jz), **TOL)
        np.testing.assert_allclose(lit.encode_eval(torch.tensor(x)).numpy(),
                                   np.asarray(jlit.encode_eval(jnp.asarray(x))), **TOL)


def test_to_images_and_sample_space_shape_match_jax(vae2):
    jlit, tlit, _, _ = _latent_pair(vae2)
    z = np.random.default_rng(6).standard_normal((3, 2, 8, 8, 4)).astype(np.float32)
    np.testing.assert_allclose(tlit.to_images(torch.tensor(z[0])).numpy(),
                               np.asarray(jlit.to_images(jnp.asarray(z[0]))), **TOL)
    hist = tlit.to_images(torch.tensor(z))
    assert hist.shape == (3,) + IMG
    np.testing.assert_allclose(hist.numpy(), np.asarray(jlit.to_images(jnp.asarray(z))), **TOL)
    assert tlit.sample_space_shape(IMG) == jlit.sample_space_shape(IMG) == (2, 8, 8, 4)
    with pytest.raises(ValueError, match="not divisible by factor 2"):
        tlit.sample_space_shape((2, 15, 16, 3))
    assert tlit.model_in_channels() == 4


@pytest.mark.parametrize("family", ["ddpm", "flow"])
def test_latent_loss_and_gradient_match_jax(vae2, monkeypatch, family):
    """The harness's training loss: the posterior noise (the step's first
    draw without a datamodule), then the algorithm's draws, read back and
    handed to JAX's encode and ``loss_given``; loss and every denoiser
    gradient within tolerance."""
    jlit, tlit, params, sd = _latent_pair(vae2, family)
    algo_cls = DDPM if family == "ddpm" else FlowMatching
    seen = {}
    orig = algo_cls.loss_given

    def spy(self, model_fn, p, x0, a, b, **kw):
        seen["x0"], seen["draws"] = x0, (a, b)
        return orig(self, model_fn, p, x0, a, b, **kw)

    monkeypatch.setattr(algo_cls, "loss_given", spy)
    x = _images(7)
    tparams = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
    loss = tlit.make_loss_fn()(tparams, torch.Generator().manual_seed(13), torch.tensor(x))
    noise = torch.randn((2, 8, 8, 4), generator=torch.Generator().manual_seed(13))
    a, b = (jnp.asarray(v.numpy()) for v in seen["draws"])
    np.testing.assert_allclose(
        seen["x0"].numpy(),
        tlit.encode_target(None, torch.tensor(x), noise=noise).numpy(), rtol=0, atol=0)

    def jloss(p):
        mean, logvar = jlit.vae.apply(jlit.vae_params, jnp.asarray(x),
                                      method=jax_vae.ConvVAE.encode)
        z = (mean + jnp.exp(0.5 * logvar) * jnp.asarray(noise.numpy())) * SCALE
        return jlit.diffusion_model.loss_given(jlit.model_fn, p, z, a, b, train=True)

    want, jgrad = jax.value_and_grad(jloss)(params)
    np.testing.assert_allclose(float(loss.detach()), float(want), **TOL)
    grads = dict(zip(tparams, torch.autograd.grad(loss, list(tparams.values()))))
    wgrad = from_flax(jax.tree_util.tree_map(np.asarray, jgrad))
    assert set(grads) == set(wgrad)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), wgrad[k].numpy(), err_msg=k, **GRAD_TOL)
    with torch.no_grad():
        got = tlit.eval_loss(sd, torch.Generator().manual_seed(2), torch.tensor(x))
    assert got.dim() == 0 and bool(torch.isfinite(got))


def test_one_generator_draw_order(vae2, monkeypatch):
    """A labelled latent step draws flip → posterior noise → label drop mask
    → t, ε from the step's one generator, JAX's key order."""
    _, tlit, _, sd = _latent_pair(vae2, num_classes=2, cond_dropout=0.5)
    tlit.model = init_weights(t_ddpm.UNet(**UNET, num_classes=2), torch.Generator().manual_seed(0))
    sd = dict(tlit.model.state_dict())
    seen = {}
    orig_target, orig_drop, orig_loss = tlit.encode_target, tlit.drop_labels, DDPM.loss_given

    def target(g, x, noise=None):
        seen["x"] = x
        return orig_target(g, x, noise)

    def drop(g, y):
        seen["y"] = orig_drop(g, y)
        return seen["y"]

    def loss_given(self, model_fn, p, x0, t, eps, **kw):
        seen["z"], seen["t"], seen["eps"] = x0, t, eps
        return orig_loss(self, model_fn, p, x0, t, eps, **kw)

    tlit.encode_target, tlit.drop_labels = target, drop
    monkeypatch.setattr(DDPM, "loss_given", loss_given)
    dm = Shapes(size=8, batch_size=8, img_size=16)
    batch = torch.randint(0, 256, (8, 16, 16, 3), generator=torch.Generator().manual_seed(1),
                          dtype=torch.uint8)
    y = torch.arange(8) % 2
    tlit.make_loss_fn(dm)(sd, torch.Generator().manual_seed(21), (batch, y))
    g = torch.Generator().manual_seed(21)
    flip = torch.rand((8, 1, 1, 1), generator=g) < 0.5
    x = dm.process(torch.where(flip, batch.flip(2), batch))
    noise = torch.randn((8, 8, 8, 4), generator=g)
    drop_mask = torch.rand((8,), generator=g) < 0.5
    t = torch.randint(1, 20, (8,), generator=g)
    eps = torch.randn((8, 8, 8, 4), generator=g)
    assert 0 < int(flip.sum()) < 8 and 0 < int(drop_mask.sum()) < 8
    assert torch.equal(seen["x"], x)
    assert torch.equal(seen["z"], orig_target(None, x, noise))
    assert torch.equal(seen["y"], torch.where(drop_mask, 2, y))
    assert torch.equal(seen["t"], t) and torch.equal(seen["eps"], eps)


def test_default_model_is_the_latent_unet(vae2):
    """Without ``model`` the denoiser is the DDPM UNet at latent width with
    both kernel switches on, JAX's default at its widths."""
    jvae, vparams, vsd = vae2
    lit = LitLatentDDPM(vae=ConvVAE(**VAE[2]), vae_params=vsd, latent_scale=1.0, dtype="bf16")
    jlit = jax_latent.LitLatentDDPM(vae=jvae, vae_params=vparams, latent_scale=1.0)
    m = lit.model
    assert (m.fused_norm, m.dtype, m.channels_per_depth) == (True, torch.bfloat16,
                                                            (128, 256, 256, 256))
    assert any(getattr(b, "fused_block", False) for b in m.modules())
    shapes = jax.eval_shape(jlit.model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
                            jnp.zeros((1,), jnp.int32))
    want = {k: tuple(v.shape) for k, v in from_flax(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == want
    assert lit.model_in_channels() == jlit.model_in_channels() == 4
    flow = LitLatentFlow(vae=ConvVAE(**VAE[2]), vae_params=vsd, latent_scale=1.0)
    assert flow.model.fused_norm and flow.model.dtype == torch.float32


def test_missing_codec_raises_jax_errors(vae2, tmp_path):
    with pytest.raises(ValueError, match="needs the stage-1 codec"):
        LitLatentDDPM(vae=ConvVAE(**VAE[2]), model=t_ddpm.UNet(**UNET))
    for where in (tmp_path / "empty", tmp_path / "absent"):
        if where.name == "empty":
            where.mkdir()
        with pytest.raises(ValueError, match="no stage-1 VAE checkpoint"):
            LitLatentDDPM(vae=ConvVAE(**VAE[2]), vae_ckpt=str(where), model=t_ddpm.UNet(**UNET))
    assert not (tmp_path / "absent").exists()


def test_scale_precedence_and_jax_calibration(vae2, tmp_path):
    """Computed (no value, no JSON): 1/std of the posterior means of the first
    ``scale_probe_n`` processed Shapes images, equal to JAX's
    ``_resolve_scale`` and written in its format; then JSON over computed,
    and an explicit value over JSON."""
    jvae, vparams, vsd = vae2
    kw = dict(size=64, batch_size=8, img_size=16)
    jroot, troot = tmp_path / "jax", tmp_path / "port"
    jlit = jax_latent.LitLatentDDPM(vae=jvae, vae_params=vparams, vae_ckpt=str(jroot),
                                    scale_probe_n=40, model=jax_ddpm.UNet(**UNET))
    want = jlit._resolve_scale(JaxShapes(**kw))

    def port(**extra):
        return LitLatentDDPM(vae=ConvVAE(**VAE[2]), vae_params=vsd, vae_ckpt=str(troot),
                             scale_probe_n=40, model=t_ddpm.UNet(**UNET), **extra)

    got = port()._resolve_scale(Shapes(**kw))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    saved = json.loads((troot / t_latent.SCALE_FILENAME).read_text())
    assert saved.keys() == json.loads((jroot / t_latent.SCALE_FILENAME).read_text()).keys()
    assert saved == {"latent_scale": got, "probe_n": 40}
    (troot / t_latent.SCALE_FILENAME).write_text(json.dumps({"latent_scale": 7.0}))
    assert port()._resolve_scale(Shapes(**kw)) == 7.0  # JSON over computed
    assert port(latent_scale=3.0)._resolve_scale(Shapes(**kw)) == 3.0  # explicit over JSON
    (troot / t_latent.SCALE_FILENAME).unlink()
    with pytest.raises(ValueError, match="latent_scale unresolved"):
        port().to_images(torch.zeros((1, 8, 8, 4)))


# ------------------------------------------------------------------ the surfaces

@pytest.fixture(scope="module")
def latent_lit(vae2):
    _, _, vsd = vae2
    lit = LitLatentDDPM(vae=ConvVAE(**VAE[2]), vae_params=vsd, latent_scale=SCALE,
                        model=t_ddpm.UNet(**UNET, fused_norm=True, fused_block=True),
                        timesteps=10)
    return lit, lit.init_state(0, device="cpu")


def _serve(sampler):
    from dmme_tpu_torch.serving import make_server

    server = make_server(sampler, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def stop():
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)

    return "http://%s:%d" % server.server_address[:2], stop


def _post(url, body):
    req = urllib.request.Request(url + "/sample", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("sampler,steps", [("default", None), ("ddim", 3), ("dpm", 3)])
def test_server_returns_images_of_lit_generate(latent_lit, sampler, steps):
    """A 16-px request on a latent harness: (n, 16, 16, 3) images, those of
    ``lit.generate`` at the image shape on the request's generator, over HTTP."""
    import io

    from dmme_tpu_torch.serving import Sampler

    lit, state = latent_lit
    url, stop = _serve(Sampler(lit, state, img_size=16, device="cpu"))
    try:
        body = {"n": 2, "seed": 3, "format": "npy", "sampler": sampler}
        if steps is not None:
            body["steps"] = steps
        code, data = _post(url, body)
    finally:
        stop()
    assert code == 200
    images = np.load(io.BytesIO(data))
    kw = {} if sampler == "default" else dict(sampler=sampler, steps=steps)
    want = denorm(lit.generate(state, torch.Generator().manual_seed(3), IMG, **kw))
    assert images.shape == IMG
    np.testing.assert_array_equal(images, want.numpy())


def test_generate_image_callback_decodes_the_history(latent_lit, tmp_path, monkeypatch):
    from dmme_tpu_torch.callbacks import GenerateImage
    from dmme_tpu_torch.callbacks import generate as cb_module

    lit, state = latent_lit
    seen = {}
    orig = cb_module.make_history

    def spy(frames):
        seen["frames"] = frames
        return orig(frames)

    monkeypatch.setattr(cb_module, "make_history", spy)
    cb = GenerateImage(imgsize=(3, 16, 16), num_samples=2, vis_length=3, out_dir=str(tmp_path))
    assert cb.generate_and_save(5, lit, state).endswith(".png")
    _, hist = lit.generate(state, torch.Generator().manual_seed(5), IMG, history_length=3)
    assert np.asarray(seen["frames"]).shape == (3,) + IMG
    np.testing.assert_array_equal(np.asarray(seen["frames"]), denorm(hist).numpy())


def test_litvae_serves_default_and_refuses_a_sampler(vae2):
    """``default`` decodes prior samples (those of ``lit.generate``); a
    sampler name is answered 400 with JAX's message."""
    import io

    from dmme_tpu_torch.serving import Sampler

    _, _, sd = vae2
    lit = LitVAE(model=ConvVAE(**VAE[2]))
    state = TrainState.create(sd, lit.make_optimizer())
    url, stop = _serve(Sampler(lit, state, img_size=16, device="cpu"))
    try:
        code, data = _post(url, {"n": 2, "seed": 4, "format": "npy"})
        code_ddim, err = _post(url, {"n": 2, "sampler": "ddim"})
    finally:
        stop()
    assert code == 200
    want = denorm(lit.generate(state, torch.Generator().manual_seed(4), IMG))
    np.testing.assert_array_equal(np.load(io.BytesIO(data)), want.numpy())
    assert code_ddim == 400
    assert json.loads(err)["error"] == (
        "sampler overrides need a diffusion harness; LitVAE has no solver to override "
        "(a LitVAE samples its prior — drop --trainer.sampler)")


# ------------------------------------------------------- the two-stage recipe

_TINY_VAE = ("{class_path: dmme_tpu.models.vae.ConvVAE, init_args: {latent_channels: 4, "
             "base_channels: 16, channel_multipliers: [1, 2], num_res_blocks: 1, dtype: f32}}")
_STAGE2 = {
    "shapes_latent_demo": ["--model.init_args.model",
                           "{class_path: dmme_tpu.models.unet.UNet, init_args: {in_channels: 4, "
                           "pos_dim: 4, emb_dim: 8, num_groups: 2, channels_per_depth: [4, 8, 8],"
                           " num_blocks: 1, attention_depths: [1]}}",
                           "--model.init_args.timesteps", "10"],
    "shapes_latent_flow_dit_demo": ["--model.init_args.model",
                                    "{class_path: dmme_tpu.models.dit.DiT, init_args: "
                                    "{in_channels: 4, patch_size: 2, hidden: 32, depth: 2, "
                                    "num_heads: 2, pos_dim: 16}}",
                                    "--model.init_args.sample_steps", "3",
                                    "--model.init_args.dtype", "f32"],
}


def _common(root):
    return ["--data.init_args.size", "16", "--data.init_args.batch_size", "4",
            "--data.init_args.img_size", "16", "--trainer.default_root_dir", str(root),
            "--trainer.tensorboard", "false", "--trainer.steps_per_call", "2",
            "--trainer.log_every_n_steps", "2", "--trainer.ckpt_every_n_steps", "2"]


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    root = tmp_path_factory.mktemp("vae")
    argv = ["--config", os.path.join(ROOT, "configs/latent/shapes_vae_demo.yaml"),
            "--model.init_args.model", _TINY_VAE, *_common(root)]
    main(["fit", *argv, "--trainer.max_steps", "4"], device="cpu")
    return root, argv


def test_stage1_fits_samples_and_refuses_a_sampler(stage1, capsys):
    root, argv = stage1
    assert CheckpointManager(str(root)).steps() == [2, 4]
    main(["sample", *argv, "--trainer.sample_batch", "2"], device="cpu")
    main(["validate", *argv, "--trainer.limit_val_batches", "2"], device="cpu")
    assert "'val/loss'" in capsys.readouterr().out
    assert os.listdir(root / "samples") == ["step_00000004.png"]
    with pytest.raises(ValueError, match="sampler overrides need a diffusion harness; LitVAE"):
        main(["sample", *argv, "--trainer.sampler", "ddim"], device="cpu")


@pytest.mark.parametrize("config", sorted(_STAGE2))
def test_stage2_fits_resumes_and_samples_from_the_stage1_run(stage1, tmp_path, config, capsys):
    """Stage 2 from the stage-1 directory: the scale calibrated and written
    beside the codec; a resume from step 2 bitwise the uninterrupted 4-step
    run; ``sample`` with and without a solver override and ``predict``
    write 16-px images, predict's and the override grid's those of
    ``lit.generate`` on the restored state; ``validate`` runs in latent
    space."""
    from dmme_tpu_torch import config as tcfg

    vae_root, _ = stage1
    argv = ["--config", os.path.join(ROOT, f"configs/latent/{config}.yaml"),
            "--model.init_args.vae", _TINY_VAE, "--model.init_args.vae_ckpt", str(vae_root),
            *_STAGE2[config]]
    run, whole = tmp_path / "run", tmp_path / "whole"
    main(["fit", *argv, *_common(run), "--trainer.max_steps", "2"], device="cpu")
    scale = json.loads((vae_root / t_latent.SCALE_FILENAME).read_text())
    assert scale["probe_n"] == 16 and np.isfinite(scale["latent_scale"])
    main(["fit", *argv, *_common(run), "--trainer.max_steps", "4", "--trainer.resume", "true"],
         device="cpu")
    main(["fit", *argv, *_common(whole), "--trainer.max_steps", "4"], device="cpu")
    a, b = CheckpointManager(str(run)).load(4), CheckpointManager(str(whole)).load(4)
    for part in ("params", "ema_params"):
        assert all(torch.equal(a[part][k], b[part][k]) for k in a[part]), part
    argv += _common(run)
    sampler = "ddim" if "dit" not in config else "flow"
    main(["sample", *argv, "--trainer.sample_batch", "2"], device="cpu")
    main(["sample", *argv, "--trainer.sampler", sampler, "--trainer.sample_steps", "2",
          "--trainer.sample_batch", "2"], device="cpu")
    assert len(os.listdir(run / "samples")) == 2
    main(["predict", *argv, "--trainer.predict_batch", "2"], device="cpu")
    pred = np.load(run / "predictions" / "pred_00000.npy")
    assert pred.shape == (2, 16, 16, 3)
    config_tree = tcfg.validate_config(tcfg.apply_overrides(tcfg.load_config(argv[1]), argv[2:]))
    lit = tcfg.instantiate(config_tree["model"])
    state = CheckpointManager(str(run)).restore(lit.init_state(0, device="cpu"))
    want = denorm(lit.generate(state, step_generator(1337, 0, "cpu"), (2, 16, 16, 3)))
    np.testing.assert_array_equal(pred, want.numpy())
    # the override's grid: generate at the image shape, seeded with the step
    images = lit.generate(state, torch.Generator().manual_seed(4), (2, 16, 16, 3),
                          sampler=sampler, steps=2)
    png = _to_png(make_history([denorm(images).numpy()]))[0]
    assert (run / "samples" / f"step_00000004_{sampler}2.png").read_bytes() == png
    main(["validate", *argv, "--trainer.limit_val_batches", "1"], device="cpu")
    assert "'val/loss'" in capsys.readouterr().out
