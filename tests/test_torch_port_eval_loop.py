"""Evaluation in the port against the JAX package, part 2: ``test()`` and
``trainer test``.

``test()`` samples ``lit.diffusion_model``, as JAX's does: for the
comparison with JAX's ``test()`` generation is stubbed in both packages to
return the same arrays (uniform draws from JAX's key of batch i), since the
two packages' random streams cannot match. Tolerance: 1e-5 relative for
``test()``'s results on the same images (fixtures:
tests/torch_port_eval_common.py).
"""

import os
import types

import jax
import numpy as np
import pytest
import torch

from dmme_tpu.data import CIFAR10 as JaxCIFAR10
from dmme_tpu.diffusion import DDIM as JaxDDIM
from dmme_tpu.diffusion import make_sampler as jax_make_sampler
from dmme_tpu.training import evaluate as jevaluate
from dmme_tpu_torch import eval as teval
from dmme_tpu_torch.data import CIFAR10
from dmme_tpu_torch.models import ddpm as t_ddpm
from dmme_tpu_torch.models import iddpm as t_iddpm
from dmme_tpu_torch.models.vae import ConvVAE
from dmme_tpu_torch.parallel.train_step import step_generator
from dmme_tpu_torch.trainer import main
from dmme_tpu_torch.training import LitDDIM, LitIDDPM, LitUpsampler, LitVAE
from dmme_tpu_torch.training import evaluate as tevaluate
from dmme_tpu_torch.utils.norm import denorm
from tests.torch_port_eval_common import (F32_CANCEL_RTOL, METRIC_RTOL, RESULT_KEYS,  # noqa: F401
                                          ROOT, TEST_RTOL, TINY_UNET, _close,
                                          _jax_feature_fn, _rel_l2, twin)

torch.set_num_threads(1)


# ------------------------------------------------------------------- test()
class _JaxStubAlgo:
    """Generation stand-in: uniform images from the batch's key."""

    @staticmethod
    def generate(model_fn, params, rng, shape):
        return jax.random.uniform(rng, shape, minval=-1.0, maxval=1.0)


class _TorchStubAlgo:
    """The same images in the port: JAX's key of call k = batch k."""

    def __init__(self, seed):
        self.seed, self.calls = seed, 0

    def generate(self, model_fn, params, generator, shape):
        key = jax.random.fold_in(jax.random.PRNGKey(self.seed), self.calls)
        self.calls += 1
        return torch.from_numpy(np.asarray(
            jax.random.uniform(key, shape, minval=-1.0, maxval=1.0)))


def _identity(x):
    return x


def _jax_model_fn(params, x, t):
    return x


def _stub_harnesses(seed):
    state = types.SimpleNamespace(params={}, ema_params={})
    jlit = types.SimpleNamespace(diffusion_model=_JaxStubAlgo(), model_fn=_jax_model_fn,
                                 sample_space_shape=tuple, to_images=_identity)
    tlit = types.SimpleNamespace(diffusion_model=_TorchStubAlgo(seed), num_classes=None,
                                 sampling_model_fn=lambda g, n, y: (None, g),
                                 sample_space_shape=tuple, to_images=_identity)
    return state, jlit, tlit


def test_test_loop_matches_jax_on_shared_images(twin, monkeypatch, tmp_path):
    """JAX's ``test()`` and the port's on the same images and weights: the
    keys, the counts, the Inception Score and the real means agree within
    1e-5. Three results are f32 cancellations of JAX's closed forms, held at
    what two accumulation orders leave of them:

    * Σ = (Σxxᵀ − n μμᵀ)/(n − 1) from f32 sums, where |μ|²/σ² ≈ 3e3 on these
      features: 3.5e-4 relative L2 measured, held within 2e-3;
    * the FID of 8 samples a side: rank-7 covariances in 2048 dimensions, so
      ~2,000 roundoff eigenvalues enter the square root (the self-FID of 8
      images reads −0.04 at tr Σ = 36; −4.5e-5 from f64 sums): 7.2e-5
      relative measured, held within 1e-3;
    * the IS std, √(E[h²] − E[h]²) of the per-sample entropy h with
      E[h]²/Var h ≈ 2e4: 9.2e-5 relative measured, held within 1e-3."""
    _, path = twin["fid"]
    monkeypatch.setattr(jevaluate, "make_feature_fn", _jax_feature_fn)
    seed = 5
    state, jlit, tlit = _stub_harnesses(seed)
    stats = {k: str(tmp_path / f"{k}.npz") for k in ("jax", "port")}
    kw = dict(seed=seed, max_batches=2, inception_weights=path, state=state)
    want = jevaluate.test(jlit, JaxCIFAR10(synthetic=True, synthetic_size=8, batch_size=4),
                          save_fid_stats=stats["jax"], **kw)
    got = tevaluate.test(tlit, CIFAR10(synthetic=True, synthetic_size=8, batch_size=4),
                         save_fid_stats=stats["port"], device="cpu", **kw)
    assert set(got) == set(want) == RESULT_KEYS and tlit.diffusion_model.calls == 2
    assert {k: got[k] for k in ("num_batches", "use_ema", "sampler", "sample_steps")} == {
        "num_batches": 2, "use_ema": True, "sampler": "default", "sample_steps": None}
    assert all(got[k] == want[k] for k in ("num_batches", "use_ema", "sampler", "sample_steps"))
    _close(got["inception_score"], float(want["inception_score"]), TEST_RTOL)
    _close(got["inception_score_std"], float(want["inception_score_std"]), F32_CANCEL_RTOL)
    jd, td = np.load(stats["jax"]), np.load(stats["port"])
    assert _rel_l2(td["mu"], jd["mu"]) < TEST_RTOL
    assert _rel_l2(td["sigma"], jd["sigma"]) < 2 * F32_CANCEL_RTOL
    _close(got["fid"], float(want["fid"]), F32_CANCEL_RTOL)


def _tiny_ddim(**kw):
    return LitDDIM(warmup=10, timesteps=10, sample_steps=4, dtype="f32",
                   model=t_ddpm.UNet(dtype=torch.float32, **TINY_UNET, **kw.pop("unet", {})),
                   **kw)


def _recorded_feature_fn(monkeypatch):
    """Wrap ``make_feature_fn`` so the images test() scores are kept."""
    seen = []
    real = teval.make_feature_fn

    def make(*args, **kwargs):
        fn = real(*args, **kwargs)

        def feature_fn(images):
            seen.append(images.clone())
            return fn(images)

        return feature_fn

    monkeypatch.setattr(teval, "make_feature_fn", make)
    return seen


@pytest.mark.parametrize("labelled", [False, True])
def test_test_draws_labels_first_then_generates_and_is_deterministic(monkeypatch, labelled):
    """Batch i of a class-conditional model guides on the batch's labels, or
    on labels drawn first from batch i's generator, then generates from it:
    what ``lit.generate`` does with that generator."""
    lit = _tiny_ddim(num_classes=10, guidance_scale=2.0, unet=dict(num_classes=10))
    state = lit.init_state(3, device="cpu")
    seen = _recorded_feature_fn(monkeypatch)
    data = CIFAR10(synthetic=True, synthetic_size=4, batch_size=2, with_labels=labelled)
    kw = dict(seed=9, max_batches=2, state=state, device="cpu")
    first = tevaluate.test(lit, data, **kw)
    assert set(first) == RESULT_KEYS | {"warning"} and first["num_batches"] == 2
    if not labelled:  # deterministic
        assert first == tevaluate.test(lit, data, **kw)
    data.setup("test")
    for i in range(2):
        real, fake = seen[2 * i], seen[2 * i + 1]
        np.testing.assert_array_equal(
            real.numpy(), data.test_data[2 * i: 2 * i + 2].astype(np.float32) / np.float32(255))
        y = (torch.as_tensor(data.test_labels[2 * i: 2 * i + 2], dtype=torch.long)
             if labelled else None)
        want = denorm(lit.generate(state, step_generator(9, i, "cpu"), (2, 32, 32, 3), y=y))
        torch.testing.assert_close(fake, want, rtol=0, atol=0)


def test_test_samples_the_full_grid_of_an_iddpm_with_sample_steps(monkeypatch):
    """The JAX package's test() runs ``lit.diffusion_model`` (all T steps),
    not ``generate``'s ``sample_steps``-step strided grid."""
    lit = LitIDDPM(warmup=10, timesteps=6, sample_steps=2, dtype="f32",
                   model=t_iddpm.UNet(dtype=torch.float32, **TINY_UNET))
    state = lit.init_state(0, device="cpu")
    calls = []
    model_fn = lit.model_fn

    def counting(*args, **kwargs):
        calls.append(1)
        return model_fn(*args, **kwargs)

    monkeypatch.setattr(lit, "model_fn", counting)
    data = CIFAR10(synthetic=True, synthetic_size=4, batch_size=4)
    out = tevaluate.test(lit, data, max_batches=1, state=state, device="cpu")
    assert len(calls) == 6 and out["num_batches"] == 1
    calls.clear()
    lit.generate(state, step_generator(0, 0, "cpu"), (4, 32, 32, 3))
    assert len(calls) == 2


def _guard_cases():
    ddim = dict(lit=lambda: _tiny_ddim())
    return [
        ("upsampler", dict(lit=lambda: LitUpsampler(factor=2, dtype="f32", model=t_ddpm.UNet(
            in_channels=6, out_channels=3, dtype=torch.float32, **TINY_UNET))), ValueError,
         "test has no conditioning source for a conditioned-input model"),
        ("vae", dict(lit=lambda: LitVAE(model=ConvVAE(latent_channels=4, base_channels=8,
                                                      channel_multipliers=(1, 2),
                                                      num_res_blocks=1))),
         ValueError, "evaluate() scores diffusion harnesses; LitVAE has no sampler"),
        ("sample_steps", dict(ddim, sample_steps=5), ValueError,
         "sample_steps without sampler would be silently ignored"),
        ("cached", dict(ddim, sampler="cached"), ValueError,
         "unknown sampler 'cached' (ddim|dpm|edm|unipc|flow)"),
        ("deep", dict(ddim, sampler="deep"), ValueError,
         "unknown sampler 'deep' (ddim|dpm|edm|unipc|flow)"),
        ("deep_dpm", dict(ddim, sampler="deep_dpm"), ValueError,
         "unknown sampler 'deep_dpm' (ddim|dpm|edm|unipc|flow)"),
    ]


@pytest.mark.parametrize("case", _guard_cases(), ids=lambda c: c[0])
def test_test_guards_raise_jax_messages(case):
    name, kw, exc, message = case
    lit = kw.pop("lit")()
    data = CIFAR10(synthetic=True, synthetic_size=4, batch_size=4)
    with pytest.raises(exc) as err:
        tevaluate.test(lit, data, device="cpu", **kw)
    assert message in str(err.value)
    if kw.get("sampler"):  # JAX's test() refuses it through this message
        with pytest.raises(ValueError) as jax_err:
            jax_make_sampler(JaxDDIM.create(10, 4), kw["sampler"])
        assert str(err.value) == str(jax_err.value)


TINY_CLI = """
seed_everything: 7
trainer:
  max_steps: 2
  log_every_n_steps: 1
  ckpt_every_n_steps: 2
  default_root_dir: {root}
model:
  class_path: dmme_tpu.training.LitDDIM
  init_args:
    warmup: 10
    timesteps: 10
    sample_steps: 4
    dtype: f32
    model:
      class_path: dmme_tpu.models.ddpm.UNet
      init_args: {{pos_dim: 4, emb_dim: 8, num_groups: 2, channels_per_depth: [4, 8, 8, 8],
                   num_blocks: 1, fused_norm: true, fused_block: true}}
data:
  class_path: dmme_tpu.data.CIFAR10
  init_args: {{synthetic: true, synthetic_size: 8, batch_size: 4}}
"""


def test_trainer_test_runbook_chain(twin, tmp_path, capsys):
    """fit, then ``test`` with a weights file saving the real statistics,
    then ``test`` reading them: the same FID, no warning."""
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(TINY_CLI.format(root=tmp_path / "run"))
    main(["fit", "--config", str(cfg)], device="cpu")
    capsys.readouterr()
    stats = str(tmp_path / "real.npz")
    common = ["test", "--config", str(cfg), "--trainer.inception_weights", twin["fid"][1],
              "--trainer.limit_test_batches", "2"]
    main(common + ["--trainer.save_fid_stats", stats], device="cpu")
    first = eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(first) == RESULT_KEYS and np.isfinite(first["fid"]) and first["num_batches"] == 2
    assert os.path.exists(stats)
    main(common + ["--trainer.fid_stats", stats], device="cpu")
    second = eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(second) == RESULT_KEYS
    _close(second["fid"], first["fid"], METRIC_RTOL)
    with pytest.raises(ValueError, match=r"unknown sampler 'cached' \(ddim\|dpm\|edm"):
        main(["test", "--config", str(cfg), "--trainer.sampler", "cached"], device="cpu")
    with pytest.raises(AssertionError, match=r"\(1, 1, 1, 1, 2\)"):  # spatial is ported
        main(["test", "--config", str(cfg), "--trainer.mesh.spatial", "2"], device="cpu")
    with pytest.raises(AssertionError, match=r"\(1, 1, 2, 1, 1\)"):  # expert is ported
        main(["test", "--config", str(cfg), "--trainer.mesh.expert", "2"], device="cpu")
    with pytest.raises(ValueError, match="test needs a diffusion harness; LitClassifier"):
        main(["test", "--config", os.path.join(ROOT, "configs/adm/cifar10_classifier.yaml")],
             device="cpu")
