"""The port's training slice against the JAX package's, on the same weights.

Both frameworks run the TINY UNet (dropout 0, ``train=True``) on seeded
numpy weights (``from_flax``) and inputs, in f32 on the CPU. JAX and
PyTorch random streams differ, so t and ε are injected through
``loss_given``. Tolerances: the loss rtol 1e-4 / atol 1e-6 and the gradient
tree rtol 2e-3 / atol 1e-5, as tests/test_torch_parity.py holds the JAX
package against its PyTorch reference; parameters after a step within
2e-3 of the step's size, since Adam divides each gradient by its own
magnitude. The CPU path goes through the same autograd Functions
(GroupNormSiLU, Attention) as the card, with their plain versions inside.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmme_tpu.data import CIFAR10 as JaxCIFAR10
from dmme_tpu.models import ddpm as jax_ddpm
from dmme_tpu.parallel import make_train_step as jax_make_train_step
from dmme_tpu.training import LitDDPM as JaxLitDDPM
from dmme_tpu.training import TrainState as JaxTrainState
from dmme_tpu.training import warmup_schedule as jax_warmup_schedule
from dmme_tpu_torch.data import CIFAR10, random_horizontal_flip
from dmme_tpu_torch.diffusion import DDPM
from dmme_tpu_torch.models import ddpm as t_ddpm
from dmme_tpu_torch.models import init_weights
from dmme_tpu_torch.models.blocks import ResBlock
from dmme_tpu_torch.ops import resblock as t_resblock
from dmme_tpu_torch.parallel import make_eval_step, make_train_chunk, make_train_step
from dmme_tpu_torch.training import (LitDDIM, LitDDPM, MetricLogger, TrainState, fit,
                                     warmup_schedule)
from dmme_tpu_torch.utils.convert import from_flax

torch.set_num_threads(1)

TINY = dict(pos_dim=4, emb_dim=8, num_groups=2, channels_per_depth=(4, 8, 16, 32),
            num_blocks=2, dropout=0.0)
SHAPE = (2, 8, 8, 3)
T = 20
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_TOL = dict(rtol=2e-3, atol=1e-5)


def _random_params(shapes, seed=0):
    """Seeded numpy values for the JAX parameter tree: kernels of variance
    1/fan_in, GroupNorm scales near 1, small non-zero biases."""
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
    jmodel = jax_ddpm.UNet(**TINY, fused_norm=True)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros(SHAPE),
                            jnp.zeros((2,), jnp.int32))
    return _random_params(shapes)


def _batch(seed):
    r = np.random.default_rng(seed)
    x0 = np.clip(r.standard_normal(SHAPE), -1, 1).astype(np.float32)
    return x0, r.integers(1, T, (SHAPE[0],)).astype(np.int32), \
        r.standard_normal(SHAPE).astype(np.float32)


def _flat(tree):
    """A gradient or moment tree of the JAX params as the port's state_dict."""
    return from_flax(jax.tree_util.tree_map(np.asarray, tree))


def _lits(parameterization="eps", snr_gamma=None, **opt):
    jmodel = jax_ddpm.UNet(**TINY, fused_norm=True)
    jlit = JaxLitDDPM(model=jmodel, timesteps=T, parameterization=parameterization,
                      snr_gamma=snr_gamma, **opt)
    tlit = LitDDPM(model=t_ddpm.UNet(**TINY, fused_norm=True, fused_block=True), timesteps=T,
                   parameterization=parameterization, snr_gamma=snr_gamma, **opt)
    return jlit, tlit


def _jax_loss_fn(jlit):
    def loss_fn(params, rng, batch):
        x0, t, eps = batch
        return jlit.diffusion_model.loss_given(jlit.model_fn, params, x0, t, eps, train=True)
    return loss_fn


def _torch_loss_fn(tlit):
    def loss_fn(params, generator, batch):
        x0, t, eps = batch
        return tlit.diffusion_model.loss_given(tlit.model_fn, params, x0, t, eps, train=True,
                                               generator=generator)
    return loss_fn


def _torch_batch(b):
    x0, t, eps = b
    return torch.tensor(x0), torch.tensor(t, dtype=torch.int64), torch.tensor(eps)


@pytest.mark.parametrize("parameterization,snr_gamma", [("eps", None), ("v", 5.0)])
def test_loss_given_value_and_gradient_tree_match(jax_params, parameterization, snr_gamma):
    jlit, tlit = _lits(parameterization, snr_gamma)
    batch = _batch(1)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss_fn(jlit)(p, None, tuple(jnp.asarray(a) for a in batch))))(jax_params)
    params = {k: v.requires_grad_(True) for k, v in from_flax(jax_params).items()}
    loss = _torch_loss_fn(tlit)(params, None, _torch_batch(batch))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **LOSS_TOL)
    want = _flat(jgrads)
    assert set(want) == set(grads)
    for k, g in grads.items():
        assert torch.isfinite(g).all() and g.abs().max() > 0, k
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("grad_clip", [1e-2, 1e3], ids=["clipped", "unclipped"])
def test_three_train_steps_match(jax_params, grad_clip):
    """Params, EMA (every 2nd step) and Adam's moments after each of three
    steps on injected batches; the warmup makes the lr differ per step."""
    opt = dict(lr=1e-3, warmup=3, decay=0.9, grad_clip=grad_clip, ema_every_n_steps=2)
    jlit, tlit = _lits(**opt)
    jstate = JaxTrainState.create(jax_params, jlit.make_optimizer(), ema_decay=0.9,
                                  ema_every_n_steps=2)
    jstep = jax_make_train_step(_jax_loss_fn(jlit), donate=False)
    tstate = TrainState.create(from_flax(jax_params), tlit.make_optimizer(), ema_decay=0.9,
                               ema_every_n_steps=2)
    tstep = make_train_step(_torch_loss_fn(tlit))
    lr_sum = 0.0
    for k in range(3):
        batch = _batch(10 + k)
        lr = warmup_schedule(1e-3, 3)(k)
        jstate, jm = jstep(jstate, tuple(jnp.asarray(a) for a in batch), jax.random.PRNGKey(0))
        tstate, tm = tstep(tstate, _torch_batch(batch), 0)
        assert tstate.step == int(jstate.step) == k + 1 and tstate.opt_state.count == k + 1
        assert (float(jm["grad_norm"]) > grad_clip) == (grad_clip < 1.0)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LOSS_TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=2e-3)
        adam = jstate.opt_state[1][0]
        lr_sum += lr
        for name, got, want in (("params", tstate.params, jstate.params),
                                ("ema", tstate.ema_params, jstate.ema_params),
                                ("mu", tstate.opt_state.mu, adam.mu),
                                ("nu", tstate.opt_state.nu, adam.nu)):
            want = _flat(want)
            for key, v in got.items():
                if name in ("params", "ema"):
                    atol = np.full(v.shape, 2e-3 * lr)
                    if key.endswith("qkv_proj.bias"):
                        # the key projection's bias: softmax is invariant to it, so
                        # its gradient is 0 but for rounding, and Adam's step there
                        # takes the sign of the rounding
                        c = v.shape[0] // 3
                        atol[c:2 * c] = 2 * lr_sum
                else:
                    atol = (1e-5 if name == "mu" else 1e-7) * min(grad_clip, 1.0) ** (
                        1 if name == "mu" else 2)
                diff = np.abs(v.numpy() - want[key].numpy())
                bad = diff > atol + 2e-3 * np.abs(want[key].numpy())
                assert not bad.any(), (f"step {k + 1} {name} {key}: "
                                       f"max abs diff {diff[bad].max():.3e}")
    # the EMA moved at step 2 only: after step 3 it still holds step 2's blend
    assert not torch.equal(tstate.ema_params["out_norm.weight"], tstate.params["out_norm.weight"])


def test_train_chunk_equals_steps(jax_params):
    """``make_train_chunk`` over stacked batches is the same steps in order."""
    _, tlit = _lits(lr=1e-3, warmup=2)
    batches = [_torch_batch(_batch(20 + k)) for k in range(2)]
    a = TrainState.create(from_flax(jax_params), tlit.make_optimizer())
    b = TrainState.create(from_flax(jax_params), tlit.make_optimizer())
    step = make_train_step(_torch_loss_fn(tlit))
    losses = [float(step(a, batch, 5)[1]["loss"]) for batch in batches]
    stacked = tuple(torch.stack(parts) for parts in zip(*batches))
    b, metrics = make_train_chunk(_torch_loss_fn(tlit), 2)(b, stacked, 5)
    assert metrics["loss"].shape == metrics["grad_norm"].shape == (2,)
    np.testing.assert_allclose(metrics["loss"].numpy(), losses, rtol=0, atol=0)
    for key in a.params:
        torch.testing.assert_close(b.params[key], a.params[key], rtol=0, atol=0)


@pytest.mark.parametrize("lr,warmup", [(2e-4, 5000), (1e-3, 3), (1e-3, 0)])
def test_warmup_schedule_matches(lr, warmup):
    got, want = warmup_schedule(lr, warmup), jax_warmup_schedule(lr, warmup)
    for count in (0, 1, max(warmup - 1, 0), warmup, warmup + 7):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6)


def test_synthetic_cifar10_and_train_iter_match_jax():
    """The same synthetic bytes, and the same shuffled batches from a seed."""
    kw = dict(batch_size=8, synthetic=True, synthetic_size=40)
    tdm, jdm = CIFAR10(**kw), JaxCIFAR10(**kw)
    tdm.setup("fit")
    jdm.setup("fit")
    np.testing.assert_array_equal(tdm.train_data, jdm.train_data)
    assert tdm.train_data.dtype == np.uint8 and tdm.train_data.shape == (40, 32, 32, 3)
    ti, ji = tdm.train_iter(7), jdm.train_iter(7)
    for _ in range(7):  # crosses an epoch boundary (5 batches per epoch)
        np.testing.assert_array_equal(next(ti), next(ji))
    tdm.setup("test")
    jdm.setup("test")
    for a, b in zip(tdm.test_iter(), jdm.test_iter()):
        np.testing.assert_array_equal(a, b)


def test_process_matches_jax():
    batch = np.random.default_rng(2).integers(0, 256, (3, 4, 4, 3), dtype=np.uint8)
    got = CIFAR10().process(torch.from_numpy(batch))
    want = JaxCIFAR10().process(jnp.asarray(batch))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)


def test_horizontal_flip_flips_whole_samples():
    batch = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (64, 4, 5, 3),
                                                               dtype=np.uint8))
    out = random_horizontal_flip(torch.Generator().manual_seed(0), batch)
    flipped = [bool(torch.equal(o, b.flip(1))) for o, b in zip(out, batch)]
    kept = [bool(torch.equal(o, b)) for o, b in zip(out, batch)]
    assert all(f != k for f, k in zip(flipped, kept))  # each sample one way or the other
    assert 16 < sum(flipped) < 48  # p = 0.5 over 64 samples
    again = random_horizontal_flip(torch.Generator().manual_seed(0), batch)
    assert torch.equal(out, again)


def test_dropout2d_drops_whole_channels():
    """Train-mode dropout in a ResBlock zeroes whole feature maps and scales
    the kept ones by 1/keep. The streams differ from JAX's, so this is a
    statistical check: the dropped share is near the rate. The block's
    second conv is replaced by the identity to read the mask."""
    block = init_weights(ResBlock(8, 256, emb_dim=4, num_groups=2, dropout=0.25),
                         torch.Generator().manual_seed(0))
    torch.manual_seed(0)
    block.conv2.forward = lambda h: h  # the dropout output, as it enters conv2
    block.residual.forward = lambda x: torch.zeros(x.shape[:-1] + (256,))
    x, emb = torch.randn(4, 6, 6, 8), torch.randn(4, 4)
    with torch.no_grad():
        eval_out = block(x, emb, train=False)
        out = block(x, emb, train=True, generator=torch.Generator().manual_seed(1))
    per_channel = out.reshape(4, 36, 256)
    dropped = (per_channel == 0).all(dim=1)
    kept = ~dropped
    assert 0.15 < float(dropped.float().mean()) < 0.35
    torch.testing.assert_close(per_channel.permute(0, 2, 1)[kept],
                               (eval_out.reshape(4, 36, 256) / 0.75).permute(0, 2, 1)[kept])


def test_fit_two_steps_logs_loss_and_grad_norm(capsys):
    lit = LitDDPM(model=t_ddpm.UNet(**dict(TINY, dropout=0.1), fused_norm=True,
                                    fused_block=True), timesteps=T, warmup=2)
    dm = CIFAR10(synthetic=True, synthetic_size=32, batch_size=4)
    state = fit(lit, dm, max_steps=2, log_every=1, device="cpu")
    assert state.step == 2 and state.opt_state.count == 2
    lines = [line for line in capsys.readouterr().err.splitlines() if line.startswith("[step")]
    assert [line.split("]")[0] for line in lines] == ["[step 1", "[step 2"]
    for line in lines:
        fields = dict(kv.split("=") for kv in line.split("] ")[1].split())
        for key in ("loss", "grad_norm", "imgs_per_sec", "lr"):
            assert np.isfinite(float(fields[key])), (key, line)
    # continue the same state for two more steps, in one chunk
    state = fit(lit, dm, max_steps=4, log_every=2, steps_per_call=2, state=state,
                device="cpu")
    assert state.step == 4
    images = LitDDIM(model=lit.model, timesteps=T, sample_steps=4).generate(
        state, torch.Generator().manual_seed(0), (2, 32, 32, 3))
    assert images.shape == (2, 32, 32, 3) and torch.isfinite(images).all()


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lit = LitDDPM(model=t_ddpm.UNet(**TINY), timesteps=T)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lit.init_state(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit(lit, CIFAR10(synthetic=True, synthetic_size=8, batch_size=4), max_steps=1)


@pytest.mark.parametrize("kwargs,item", [
    (dict(mesh=object()), "A.16"),
])
def test_fit_arguments_not_ported_raise(kwargs, item):
    lit = LitDDPM(model=t_ddpm.UNet(**TINY), timesteps=T)
    with pytest.raises(NotImplementedError, match=item):
        fit(lit, CIFAR10(synthetic=True, synthetic_size=8, batch_size=4), max_steps=1,
            device="cpu", **kwargs)


def test_eval_loss_and_eval_step_take_no_gradient(jax_params):
    _, tlit = _lits()
    params = from_flax(jax_params)
    x0 = torch.tensor(_batch(3)[0])
    a = tlit.eval_loss(params, torch.Generator().manual_seed(4), x0)
    b = make_eval_step(lambda p, g, x: tlit.eval_loss(p, g, x))(
        params, x0, torch.Generator().manual_seed(4))
    assert a.grad_fn is None and float(a) == float(b) and np.isfinite(float(a))


def test_sampling_after_a_train_step_uses_the_new_weights(jax_params):
    """The fused ResBlock kernel caches its packed weights per weight state.
    An in-place optimizer step (under no_grad) moves each tensor's version,
    so packing the same block's tensors after the step gives a new entry,
    equal to a fresh pack of the updated weights."""
    _, tlit = _lits(lr=0.5, warmup=0)  # a large step: the change is visible in bf16
    state = TrainState.create(from_flax(jax_params), tlit.make_optimizer())
    names = ["down_0.conv1.weight", "down_0.conv1.bias", "down_0.conv2.weight",
             "down_0.conv2.bias"]
    before_w = state.params[names[0]].clone()
    before = t_resblock.pack_weights(*(state.params[n] for n in names))
    make_train_step(_torch_loss_fn(tlit))(state, _torch_batch(_batch(4)), 0)
    assert (state.params[names[0]] - before_w).abs().max() > 0.1
    after = t_resblock.pack_weights(*(state.params[n] for n in names))
    assert after is not before
    t_resblock._PACKED.clear()
    fresh = t_resblock.pack_weights(*(state.params[n].clone() for n in names))
    for a, f in zip(after, fresh):
        if a is not None:
            torch.testing.assert_close(a, f, rtol=0, atol=0)
    assert not torch.equal(after.w1, before.w1)


def test_metric_logger_writes_jsonl(tmp_path, capsys):
    logger = MetricLogger(str(tmp_path), name="m")
    record = logger.log(3, {"loss": torch.tensor(0.5), "note": "x"})
    logger.close()
    assert record == {"loss": 0.5, "note": "x"}
    line = json.loads((tmp_path / "m.jsonl").read_text().splitlines()[0])
    assert line["step"] == 3 and line["loss"] == 0.5 and line["note"] == "x"
    assert "[step 3]" in capsys.readouterr().err


def test_ddpm_loss_draws_t_then_eps_then_dropout_from_one_generator(jax_params):
    """``loss`` equals ``loss_given`` on the t and ε the same generator
    gives first, in that order; T itself is never drawn."""
    _, tlit = _lits()
    params = from_flax(jax_params)
    x0 = torch.tensor(_batch(5)[0])
    got = tlit.diffusion_model.loss(tlit.model_fn, params, torch.Generator().manual_seed(9),
                                    x0, train=False)
    g = torch.Generator().manual_seed(9)
    t = tlit.diffusion_model.sample_timesteps(g, SHAPE[0])
    eps = torch.randn(SHAPE, generator=g)
    want = tlit.diffusion_model.loss_given(tlit.model_fn, params, x0, t, eps)
    assert float(got) == float(want)
    many = DDPM.create(timesteps=3).sample_timesteps(torch.Generator().manual_seed(0), 1000)
    assert set(many.tolist()) == {1, 2}
