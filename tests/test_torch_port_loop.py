"""The port's training loop and what it drives, on the CPU at the TINY size.

Checkpoints, resume, restarts, interrupts, callbacks, gradient
accumulation, ``debug_nans``, the data streams (``Shapes``, ``train_iter``'s
``skip_batches`` and process slices, held byte for byte against the JAX
package's), the logger backends (TensorBoard bytes equal to the JAX
package's), ``UNet(remat=True)`` with dropout, and the f32/fp16 harnesses.
Resumed, restarted and uninterrupted runs must agree bit for bit: every
draw of step k comes from the generator of (run seed, k).
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from dmme_tpu_torch.data import CIFAR10, Shapes
from dmme_tpu_torch.diffusion import DDPM
from dmme_tpu_torch.models import ddpm as t_ddpm
from dmme_tpu_torch.models import init_weights
from dmme_tpu_torch.models.blocks import ResBlock
from dmme_tpu_torch.parallel import make_train_step
from dmme_tpu_torch.training import (CheckpointManager, LitDDPM, MetricLogger, TrainState, fit,
                                     loggers)
from dmme_tpu_torch.training.lit import resolve_dtype
from dmme_tpu_torch.training.loop import _microbatched, microbatch_generators
from dmme_tpu_torch.training.optimizer import ClipAdam

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(pos_dim=4, emb_dim=8, num_groups=2, channels_per_depth=(4, 8, 8, 8), num_blocks=1)
T = 10


def _lit(dropout=0.1, dtype="f32", **kw):
    model = t_ddpm.UNet(**TINY, dropout=dropout, dtype=resolve_dtype(dtype), fused_norm=True,
                        fused_block=True)
    return LitDDPM(model=model, timesteps=T, warmup=3, lr=1e-3, dtype=dtype, **kw)


def _dm(size=32, batch=4):
    return CIFAR10(synthetic=True, synthetic_size=size, batch_size=batch)


def _fit(lit, steps, ckpt_dir=None, **kw):
    kw.setdefault("log_every", 100)
    return fit(lit, _dm(), steps, ckpt_dir=None if ckpt_dir is None else str(ckpt_dir),
               device="cpu", **kw)


def _assert_states_equal(a: TrainState, b: TrainState):
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    for name, x, y in (("params", a.params, b.params), ("ema", a.ema_params, b.ema_params),
                       ("mu", a.opt_state.mu, b.opt_state.mu),
                       ("nu", a.opt_state.nu, b.opt_state.nu)):
        assert set(x) == set(y)
        for k in x:
            assert torch.equal(x[k], y[k]), f"{name} {k}"


# ----------------------------------------------------------------------- data

@pytest.mark.parametrize("seed,img_size", [(0, 32), (0, 64), (3, 32), (3, 64)])
def test_shapes_bytes_equal_jax(seed, img_size):
    from dmme_tpu.data.shapes import render_shapes as jax_render

    from dmme_tpu_torch.data import render_shapes

    images, labels = render_shapes(40, img_size, seed)
    want_images, want_labels = jax_render(40, img_size, seed)
    assert images.dtype == np.uint8 and images.shape == (40, img_size, img_size, 3)
    np.testing.assert_array_equal(images, want_images)
    np.testing.assert_array_equal(labels, want_labels)
    dm = Shapes(size=40, batch_size=8, img_size=img_size, seed=seed, with_labels=True)
    dm.setup("fit")
    np.testing.assert_array_equal(dm.train_data, want_images)
    flipped = dm.train_transform(torch.Generator().manual_seed(0), torch.from_numpy(images))
    assert flipped.dtype == torch.float32 and float(flipped.min()) >= -1.0


@pytest.mark.parametrize("k", [0, 3, 5, 12])
def test_train_iter_skip_batches_drops_k_batches(k):
    """5 batches an epoch: k = 5 and 12 skip whole epochs."""
    dm = _dm(size=40, batch=8)
    dm.setup("fit")
    full = dm.train_iter(7)
    for _ in range(k):
        next(full)
    skipped = dm.train_iter(7, skip_batches=k)
    for _ in range(7):
        np.testing.assert_array_equal(next(skipped), next(full))


@pytest.mark.parametrize("count", [2, 4])
def test_train_iter_process_slices_equal_jax(count):
    from dmme_tpu.data import CIFAR10 as JaxCIFAR10

    kw = dict(synthetic=True, synthetic_size=40, batch_size=8, with_labels=True)
    for index in range(count):
        tdm, jdm = CIFAR10(**kw), JaxCIFAR10(**kw)
        tdm.setup("fit")
        jdm.setup("fit")
        ti = tdm.train_iter(5, process_index=index, process_count=count, skip_batches=3)
        ji = jdm.train_iter(5, process_index=index, process_count=count, skip_batches=3)
        for _ in range(6):
            (ta, tl), (ja, jl) = next(ti), next(ji)
            assert ta.shape[0] == 8 // count
            np.testing.assert_array_equal(ta, ja)
            np.testing.assert_array_equal(tl, jl)


# ---------------------------------------------------------------- checkpoints

def test_checkpoint_round_trip_is_bitwise(tmp_path):
    lit = _lit()
    state = _fit(lit, 2)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(2, state) and not mgr.save(2, state)  # a saved step stays unless forced
    fresh = lit.init_state(5, device="cpu")
    versions = {k: v._version for k, v in fresh.params.items()}
    restored = mgr.restore(fresh)
    assert restored is fresh
    _assert_states_equal(restored, state)
    # copied in place: the tensors' versions moved (the K4 weight cache keys on them)
    assert all(v._version > versions[k] for k, v in restored.params.items())
    assert os.listdir(tmp_path) == ["2"]  # no temporary directory left behind


def test_checkpoint_max_to_keep_prunes(tmp_path):
    state = _lit().init_state(0, device="cpu")
    kept = CheckpointManager(str(tmp_path / "three"), max_to_keep=3)
    every = CheckpointManager(str(tmp_path / "all"), max_to_keep=None)
    for step in (1, 2, 3, 4, 5):
        state.step = step
        kept.save(step, state)
        every.save(step, state)
    assert kept.steps() == [3, 4, 5] and kept.latest_step() == 5
    assert every.steps() == [1, 2, 3, 4, 5]
    state.step = 9
    assert kept.save(5, state, force=True)
    assert kept.load(5)["step"] == 9 and kept.steps() == [3, 4, 5]


def test_restore_refuses_another_model(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _lit().init_state(0, device="cpu"))
    other = LitDDPM(model=t_ddpm.UNet(**dict(TINY, channels_per_depth=(4, 8, 8)),
                                      fused_norm=True), timesteps=T)
    with pytest.raises(ValueError, match="keys differ"):
        mgr.restore(other.init_state(0, device="cpu"))


# ------------------------------------------------------------------ the loop

@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_resume_equals_an_uninterrupted_run(tmp_path, steps_per_call):
    lit = _lit()
    whole = _fit(lit, 4, tmp_path / "whole", ckpt_every=2, steps_per_call=steps_per_call)
    _fit(lit, 2, tmp_path / "parts", ckpt_every=2, steps_per_call=steps_per_call)
    resumed = _fit(lit, 4, tmp_path / "parts", ckpt_every=2, steps_per_call=steps_per_call,
                   resume=True)
    _assert_states_equal(resumed, whole)
    assert CheckpointManager(str(tmp_path / "parts")).steps() == [2, 4]


def test_resume_off_the_chunk_grid(tmp_path):
    """A run of 3 steps in chunks of 2 (a chunk, then a tail step), resumed
    to 6 (a chunk from 3, then a tail step), equals 6 steps straight."""
    lit = _lit()
    whole = _fit(lit, 6, steps_per_call=2)
    _fit(lit, 3, tmp_path, steps_per_call=2)
    resumed = _fit(lit, 6, tmp_path, steps_per_call=2, resume=True)
    _assert_states_equal(resumed, whole)


class Bomb:
    """Raises once, at a given step."""

    def __init__(self, at_step):
        self.at_step, self.armed = at_step, True

    def on_train_step_end(self, step):
        if self.armed and step == self.at_step:
            self.armed = False
            raise RuntimeError("injected failure")


def test_max_restarts_recovers_bitwise(tmp_path):
    lit = _lit()
    clean = _fit(lit, 6, tmp_path / "clean", ckpt_every=2)
    bomb = Bomb(3)
    recovered = _fit(lit, 6, tmp_path / "faulty", ckpt_every=2, callbacks=[bomb],
                     max_restarts=1)
    assert not bomb.armed
    _assert_states_equal(recovered, clean)
    with pytest.raises(RuntimeError, match="injected"):
        _fit(lit, 6, tmp_path / "again", ckpt_every=2, callbacks=[Bomb(3)])
    with pytest.raises(ValueError, match="ckpt_dir"):
        _fit(lit, 1, max_restarts=1)


def test_interrupt_inside_an_update_leaves_no_torn_checkpoint(tmp_path, monkeypatch):
    """A KeyboardInterrupt raised inside ``tx.update_`` (after the update of
    the parameters, before the EMA and the step count) leaves a torn state:
    nothing is saved, and the checkpoints stay those of whole states."""
    lit = _lit()
    clean = _fit(lit, 2)
    update = ClipAdam.update_
    calls = []

    def interrupted(self, grads, opt_state, params):
        update(self, grads, opt_state, params)
        calls.append(1)
        if len(calls) == 3:
            raise KeyboardInterrupt

    monkeypatch.setattr(ClipAdam, "update_", interrupted)
    with pytest.raises(KeyboardInterrupt):
        _fit(lit, 6, tmp_path, ckpt_every=1)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.steps() == [1, 2]
    _assert_states_equal(mgr.restore(lit.init_state(0, device="cpu")), clean)


_SIGTERM_SCRIPT = """
import sys
from dmme_tpu_torch.trainer import main
main(["fit", "--config", sys.argv[1]], device="cpu")
"""


def test_sigterm_saves_the_true_step_and_dies_by_sigterm(tmp_path):
    """Preemption: SIGTERM is deferred to the next safe point, the state of
    that step is saved, and the signal is delivered again so the process
    dies by it."""
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(textwrap.dedent(f"""
        trainer:
          max_steps: 100000
          ckpt_every_n_steps: 1000000
          log_every_n_steps: 1
          default_root_dir: {tmp_path}/run
        model:
          class_path: dmme_tpu.training.LitDDPM
          init_args:
            warmup: 2
            timesteps: 5
            model:
              class_path: dmme_tpu.models.ddpm.UNet
              init_args: {{pos_dim: 4, emb_dim: 8, num_groups: 2,
                           channels_per_depth: [4, 8, 8, 8], num_blocks: 1}}
        data:
          class_path: dmme_tpu.data.CIFAR10
          init_args: {{synthetic: true, synthetic_size: 16, batch_size: 4}}
        """))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", _SIGTERM_SCRIPT, str(cfg)], cwd=ROOT, env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    metrics = tmp_path / "run" / "metrics.jsonl"
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            if metrics.exists() and len(metrics.read_text().splitlines()) >= 3:
                break
            if proc.poll() is not None:
                pytest.fail(f"fit exited early: {proc.returncode}")
            time.sleep(0.2)
        else:
            pytest.fail("fit made no progress")
        proc.send_signal(signal.SIGTERM)
        ret = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert ret == -signal.SIGTERM, ret
    logged = [json.loads(line)["step"] for line in metrics.read_text().splitlines()]
    mgr = CheckpointManager(str(tmp_path / "run"))
    saved = mgr.latest_step()
    assert saved is not None and saved >= logged[-1] >= 3
    assert mgr.load(saved)["step"] == saved == mgr.load(saved)["opt_state"]["count"]


def test_callbacks_receive_only_the_keywords_they_take(tmp_path):
    seen = []

    class Narrow:
        def on_fit_start(self, lit):
            seen.append(("start", type(lit).__name__))

        def on_train_step_end(self, step):
            seen.append(("end", step))

        def on_log(self, step, metrics):
            seen.append(("log", step, sorted(metrics)))

    class Wide:
        def on_fit_end(self, **kw):
            seen.append(("fit_end", sorted(kw)))

    _fit(_lit(), 2, tmp_path, log_every=2, callbacks=[Narrow(), Wide()])
    assert seen == [("start", "LitDDPM"), ("end", 1),
                    ("log", 2, ["grad_norm", "imgs_per_sec", "loss", "lr"]), ("end", 2),
                    ("fit_end", ["lit", "logger", "state"])]
    assert (tmp_path / "metrics.jsonl").exists()


def test_generate_image_writes_grids_and_logs_them(tmp_path):
    from dmme_tpu_torch.callbacks import GenerateImage
    from dmme_tpu_torch.training import LitDDIM

    model = t_ddpm.UNet(**TINY, fused_norm=True, fused_block=True)
    lit = LitDDIM(model=model, timesteps=T, sample_steps=4, warmup=2)
    cb = GenerateImage(imgsize=(3, 32, 32), every_n_steps=2, num_samples=2, vis_length=3,
                       out_dir=str(tmp_path / "samples"))
    fit(lit, _dm(), 3, ckpt_dir=str(tmp_path), log_every=100, callbacks=[cb], device="cpu",
        tensorboard=True)
    assert sorted(os.listdir(tmp_path / "samples")) == ["step_00000002.png",
                                                        "step_00000003.png"]
    assert sorted(os.listdir(tmp_path / "images")) == ["samples_00000002.png",
                                                       "samples_00000003.png"]
    from PIL import Image

    grid = np.asarray(Image.open(tmp_path / "samples" / "step_00000002.png"))
    assert grid.shape == (2 * 34 + 2, 3 * 34 + 2, 3)  # 2 trajectories × 3 frames


def test_accumulated_gradient_is_the_mean_of_the_microbatch_gradients():
    lit = _lit()
    dm = _dm()
    dm.setup("fit")
    loss_fn = lit.make_loss_fn(dm)
    params = {k: v.requires_grad_(True) for k, v in lit.init_state(0, device="cpu")
              .params.items()}
    stacked = torch.from_numpy(np.stack([next(dm.train_iter(1)) for _ in range(3)]))
    stacked[1] = torch.from_numpy(next(dm.train_iter(2)))
    generator = torch.Generator().manual_seed(123)
    loss, grads = _microbatched(loss_fn, 3)(params, generator, stacked)
    losses, per = [], []
    for j, g in enumerate(microbatch_generators(generator, 3)):
        lj = loss_fn(params, g, stacked[j])
        losses.append(lj.detach())
        per.append(torch.autograd.grad(lj, list(params.values())))
    torch.testing.assert_close(loss, torch.stack(losses).mean(), rtol=1e-6, atol=0)
    for i, k in enumerate(params):
        torch.testing.assert_close(grads[k], sum(p[i] for p in per) / 3, rtol=1e-5, atol=1e-8)
    # each microbatch draws from its own generator: microbatches 0 and 2 hold
    # the same images, and their losses differ
    assert float(losses[0]) != float(losses[2])
    state = _fit(lit, 2, accumulate_grad_batches=3)
    assert state.step == 2


def test_debug_nans_stops_at_the_step_that_makes_a_nan(tmp_path):
    class Poison:
        def on_train_step_end(self, step, state):
            if step == 2:
                with torch.no_grad():
                    state.params["output_conv.bias"].fill_(float("nan"))

    lit = _lit()
    state = lit.init_state(0, device="cpu")
    with pytest.raises(FloatingPointError, match="step 3"):
        _fit(lit, 5, state=state, callbacks=[Poison()], debug_nans=True)
    assert state.step == 2  # the step that made the NaN did not update the state
    clean = _fit(lit, 3, callbacks=[Poison()])  # without debug_nans the NaN trains on
    assert not torch.isfinite(clean.params["output_conv.bias"]).all()


# -------------------------------------------------------------------- loggers

def test_tensorboard_event_bytes_equal_jax(tmp_path, monkeypatch):
    from dmme_tpu.training import loggers as jax_loggers

    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    image = np.random.default_rng(0).random((6, 10, 3)).astype(np.float32)
    for mod, d in ((loggers, tmp_path / "port"), (jax_loggers, tmp_path / "jax")):
        tb = mod.TensorBoardLogger(str(d))
        tb.log_metrics({"loss": 0.125, "lr": 2e-4, "note": "skipped"}, 7)
        tb.log_image("samples", image, 8)
        tb.finalize()
    (port,), (jax_file,) = os.listdir(tmp_path / "port"), os.listdir(tmp_path / "jax")
    got = (tmp_path / "port" / port).read_bytes()
    assert got == (tmp_path / "jax" / jax_file).read_bytes() and len(got) > 100


def test_metric_logger_backends(tmp_path, capsys):
    logger = MetricLogger(str(tmp_path), tensorboard=True)
    logger.log(3, {"loss": torch.tensor(0.5)})
    logger.log_image("grid", np.zeros((4, 4, 3), np.uint8), 3)
    logger.close()
    line = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert line["step"] == 3 and line["loss"] == 0.5
    assert os.listdir(tmp_path / "tb") and (tmp_path / "images" / "grid_00000003.png").exists()
    seen = []

    class Probe:
        def log_metrics(self, metrics, step):
            seen.append((step, metrics))

        def log_image(self, tag, image, step):
            seen.append((tag, step))

        def finalize(self):
            seen.append("done")

    only = MetricLogger(str(tmp_path / "unused"), loggers=[Probe()])
    only.log(1, {"a": 1})
    only.log_image("g", np.zeros((2, 2, 3)), 1)
    only.close()
    assert seen == [(1, {"a": 1.0}), ("g", 1), "done"]
    assert not (tmp_path / "unused").exists()
    assert "[step 1]" in capsys.readouterr().err


def test_wandb_logger_says_what_is_missing(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(ImportError, match="wandb"):
        loggers.WandbLogger()


# ---------------------------------------------------------------------- remat

def test_remat_with_dropout_gives_the_same_loss_and_gradient():
    """Each ResBlock draws its dropout mask before the checkpointed body, so
    the recomputation reuses it, and takes the weights bound by
    ``functional_call`` as inputs, so the recomputation (in the backward,
    after the binding ends) uses them and not the module's own: remat on
    and off agree (CPU f32). The bound weights differ from the module's."""
    r = np.random.default_rng(0)
    x0 = torch.tensor(np.clip(r.standard_normal((2, 16, 16, 3)), -1, 1), dtype=torch.float32)
    t = torch.tensor([3, 7])
    eps = torch.tensor(r.standard_normal((2, 16, 16, 3)), dtype=torch.float32)
    algo = DDPM.create(T)
    out = {}
    for remat in (False, True):
        model = t_ddpm.UNet(**TINY, dropout=0.1, fused_norm=True, remat=remat)
        init_weights(model, torch.Generator().manual_seed(0))
        params = {k: v.clone().requires_grad_(True) for k, v in model.state_dict().items()}
        init_weights(model, torch.Generator().manual_seed(1))  # the module's own: others

        def fn(p, x, tt, **kw):
            return torch.func.functional_call(model, p, (x, tt), kw)

        loss = algo.loss_given(fn, params, x0, t, eps, train=True,
                               generator=torch.Generator().manual_seed(5))
        grads = torch.autograd.grad(loss, list(params.values()))
        out[remat] = (loss.detach(), torch.cat([g.flatten() for g in grads]))
    (l0, g0), (l1, g1) = out[False], out[True]
    assert float((l1 - l0).abs() / l0.abs()) <= 1e-6
    assert float((g1 - g0).norm() / g0.norm()) <= 1e-6


def test_a_mask_drawn_inside_the_checkpoint_would_change_the_gradient():
    """Why the mask is drawn first: checkpointing the whole block call, the
    recomputation draws a second mask from the generator, and the gradient
    is not that of the forward."""
    from torch.utils.checkpoint import checkpoint

    block = init_weights(ResBlock(8, 8, emb_dim=4, num_groups=2, dropout=0.5),
                         torch.Generator().manual_seed(0))
    x = torch.randn(2, 6, 6, 8, generator=torch.Generator().manual_seed(1), requires_grad=True)
    emb = torch.randn(2, 4, generator=torch.Generator().manual_seed(2))

    def grad(fn):
        return torch.autograd.grad(fn(torch.Generator().manual_seed(3)).square().sum(), x)[0]

    plain = grad(lambda g: block(x, emb, True, g))
    naive = grad(lambda g: checkpoint(lambda xx: block(xx, emb, True, g), x,
                                      use_reentrant=False))
    block.remat = True
    remat = grad(lambda g: block(x, emb, True, g))
    torch.testing.assert_close(remat, plain, rtol=1e-6, atol=1e-7)
    assert float((naive - plain).norm() / plain.norm()) > 1e-2


# -------------------------------------------------------- f32 and fp16 (C.5)

@pytest.mark.parametrize("dtype", ["f32", "fp16"])
def test_lit_ddpm_trains_a_step_outside_bf16(dtype):
    lit = _lit(dtype=dtype)
    assert lit.model.dtype == {"f32": torch.float32, "fp16": torch.float16}[dtype]
    dm = _dm()
    dm.setup("fit")
    state = lit.init_state(0, device="cpu")
    before = {k: v.clone() for k, v in state.params.items()}
    state, metrics = make_train_step(lit.make_loss_fn(dm))(
        state, torch.from_numpy(next(dm.train_iter(0))), 0)
    assert state.step == 1 and np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"])) and float(metrics["grad_norm"]) > 0
    assert all(v.dtype == torch.float32 for v in state.params.values())
    assert sum(not torch.equal(v, before[k]) for k, v in state.params.items()) > 0
    assert LitDDPM().model.dtype == torch.float32  # the default harness is f32
