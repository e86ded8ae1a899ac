"""Progressive distillation in the port against the JAX package's.

The τ grids are held int-exact against JAX's. The teacher's two-step
target and the loss (with its gradient) run the TINY UNet as teacher and
student on seeded weights (``from_flax``) in f32, with injected grid
indices and noise, for ε and v teachers × v and ε students, within
rtol/atol 1e-4 (tests/test_torch_port_sampling.py's tolerance).
``LitDistill``'s state, a CPU ``fit`` and the round driver
(``python -m dmme_tpu_torch.distill``) run on the CPU at TINY sizes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmme_tpu.diffusion.distill import ProgressiveDistillation as JaxPD
from dmme_tpu.models import as_model_fn
from dmme_tpu.models import ddpm as jax_ddpm
from dmme_tpu_torch.diffusion import DDIM, ProgressiveDistillation
from dmme_tpu_torch.models import ddpm as t_ddpm
from dmme_tpu_torch.training import LitDistill, fit
from dmme_tpu_torch.utils.convert import from_flax

torch.set_num_threads(1)

TINY = dict(pos_dim=4, emb_dim=8, num_groups=2, channels_per_depth=(4, 8, 16),
            num_blocks=1, dropout=0.0, attention_depths=(2,))
SHAPE = (4, 8, 8, 3)
TOL = dict(rtol=1e-4, atol=1e-4)


def _random_params(shapes, seed):
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
    """(JAX module, teacher params, student params, port module, their
    state_dicts) of the TINY UNet."""
    jmodel = jax_ddpm.UNet(**TINY)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros(SHAPE),
                            jnp.zeros((SHAPE[0],), jnp.int32))
    tp, sp = _random_params(shapes, 1), _random_params(shapes, 2)
    tmodel = t_ddpm.UNet(**TINY, fused_norm=True, fused_block=True)
    return jmodel, tp, sp, tmodel, from_flax(tp), from_flax(sp)


def _fn(model):
    def fn(params, x, t, **kw):
        return torch.func.functional_call(model, params, (x, t), kw)
    return fn


@pytest.mark.parametrize("timesteps,steps", [(100, 10), (1000, 500), (1000, 250), (20, 5),
                                             (1000, 7)])
def test_grids_are_jax_grids(timesteps, steps):
    """τ_teacher = linear_tau(T, 2N), τ_student = τ_teacher[::2], int-exact,
    and every next round while N is even."""
    pd, jpd = (ProgressiveDistillation.create(timesteps, steps),
               JaxPD.create(timesteps=timesteps, student_steps=steps))
    while True:
        np.testing.assert_array_equal(pd.teacher_tau.numpy(), np.asarray(jpd.teacher_tau))
        np.testing.assert_array_equal(pd.student_tau.numpy(), np.asarray(jpd.student_tau))
        assert torch.equal(pd.student_tau, pd.teacher_tau[::2]) and int(pd.student_tau[0]) == 0
        assert pd.student_steps == jpd.student_steps
        if pd.student_steps % 2:
            with pytest.raises(AssertionError):
                pd.next_round()
            break
        pd, jpd = pd.next_round(), jpd.next_round()
        assert pd.teacher_parameterization == pd.student_parameterization == "v"


def test_create_refuses_a_teacher_grid_past_timesteps():
    with pytest.raises(AssertionError, match="exceeds timesteps"):
        ProgressiveDistillation.create(timesteps=10, student_steps=6)


@pytest.mark.parametrize("teacher", ["eps", "v"])
@pytest.mark.parametrize("student", ["v", "eps"])
def test_target_loss_and_gradient_match_jax(nets, teacher, student):
    """``teacher_target_x0`` and ``loss_given`` on the same x₀, i and ε (i
    over the whole student grid, the last step to τ = 0 included), and the
    gradient of the loss in every student parameter. The teacher runs in
    eval (through the fused ResBlock's plain version), the student trains."""
    jmodel, tp, sp, tmodel, tsd, ssd = nets
    T, N = 20, 5
    kw = dict(teacher_parameterization=teacher, student_parameterization=student)
    pd, jpd = ProgressiveDistillation.create(T, N, **kw), JaxPD.create(T, N, **kw)
    r = np.random.default_rng(3)
    x0 = np.clip(r.standard_normal(SHAPE), -1, 1).astype(np.float32)
    i = np.array([1, 2, 4, 5], np.int32)
    noise = r.standard_normal(SHAPE).astype(np.float32)
    jfn = as_model_fn(jmodel)

    ab = np.asarray(jpd.schedule.alpha_bar)[np.asarray(jpd.student_tau)[i]]
    x_t = (np.sqrt(ab)[:, None, None, None] * x0
           + np.sqrt(1 - ab)[:, None, None, None] * noise).astype(np.float32)
    want_x0 = jax.jit(lambda p, x: jpd.teacher_target_x0(jfn, p, x, jnp.asarray(i)))(
        tp, jnp.asarray(x_t))
    got_x0 = pd.teacher_target_x0(_fn(tmodel), tsd, torch.tensor(x_t), torch.tensor(i))
    np.testing.assert_allclose(got_x0.numpy(), np.asarray(want_x0), **TOL)

    def jloss(s):  # the student in training mode (dropout 0), as in a fit
        return jpd.loss_given(jfn, tp, jfn, s, jnp.asarray(x0), jnp.asarray(i),
                              jnp.asarray(noise), train=True)

    jl, jgrad = jax.jit(jax.value_and_grad(jloss))(sp)
    params = {k: v.detach().requires_grad_(True) for k, v in ssd.items()}
    loss = pd.loss_given(_fn(tmodel), tsd, _fn(tmodel), params, torch.tensor(x0),
                         torch.tensor(i), torch.tensor(noise), train=True)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    want = from_flax(jax.tree_util.tree_map(np.asarray, jgrad))
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), err_msg=k, **TOL)


def test_loss_draws_i_then_eps_then_dropout(nets, monkeypatch):
    """``loss`` draws i ∈ [1, N], then ε, from the generator (JAX's key
    order), and hands the same generator on for the student's dropout."""
    _, _, _, tmodel, tsd, ssd = nets
    pd = ProgressiveDistillation.create(20, 5)
    seen = {}
    orig = ProgressiveDistillation.loss_given

    def spy(self, *a, **kw):
        seen["i"], seen["noise"], seen["generator"] = a[5], a[6], kw["generator"]
        return orig(self, *a, **kw)

    monkeypatch.setattr(ProgressiveDistillation, "loss_given", spy)
    gen = torch.Generator().manual_seed(4)
    x0 = torch.zeros(SHAPE)
    pd.loss(_fn(tmodel), tsd, _fn(tmodel), ssd, gen, x0)
    ref = torch.Generator().manual_seed(4)
    assert torch.equal(seen["i"], torch.randint(1, 6, (SHAPE[0],), generator=ref))
    assert torch.equal(seen["noise"], torch.randn(SHAPE, generator=ref))
    assert seen["generator"] is gen


def test_student_sampler_is_the_student_grid_ddim():
    pd = ProgressiveDistillation.create(20, 5, student_parameterization="v")
    algo = pd.student_sampler()
    assert isinstance(algo, DDIM) and algo.sub_timesteps == 5 and algo.eta == 0.0
    assert algo.variant == "canonical" and algo.parameterization == "v"
    assert torch.equal(algo.tau, pd.student_tau)


def test_lit_distill_state_fit_and_generate(nets, tmp_path):
    """``init_state`` copies ``init_params`` into parameters and EMA, aliasing
    neither each other nor the teacher; a 3-step CPU ``fit`` leaves the
    teacher's weights untouched, logs finite losses and checkpoints; the
    student samples with its 5-step DDIM."""
    from dmme_tpu_torch.data import CIFAR10

    _, _, _, tmodel, tsd, _ = nets
    teacher = {k: v.clone() for k, v in tsd.items()}
    pd = ProgressiveDistillation.create(20, 5, teacher_parameterization="eps")
    lit = LitDistill(teacher_model=tmodel, teacher_params=teacher, distiller=pd,
                     init_params=teacher, decay=0.9)
    assert lit.model is tmodel and lit.sample_algorithm().sub_timesteps == 5
    state = lit.init_state(0, device="cpu")
    ptrs = {v.data_ptr() for v in teacher.values()}
    for k in teacher:
        assert torch.equal(state.params[k], teacher[k])
        assert torch.equal(state.ema_params[k], teacher[k])
        assert state.params[k].data_ptr() != state.ema_params[k].data_ptr()
        assert state.params[k].data_ptr() not in ptrs
        assert state.ema_params[k].data_ptr() not in ptrs
    dm = CIFAR10(synthetic=True, synthetic_size=16, batch_size=4)
    state = fit(lit, dm, max_steps=3, state=state, log_every=1, ckpt_dir=str(tmp_path),
                device="cpu")
    assert state.step == 3
    for k in teacher:
        assert torch.equal(teacher[k], tsd[k])
    assert any(not torch.equal(state.params[k], teacher[k]) for k in teacher)
    assert os.path.isdir(tmp_path / "3")
    out = lit.generate(state, torch.Generator().manual_seed(0), SHAPE)
    assert out.shape == SHAPE and bool(torch.isfinite(out).all())


DRIVER_YAML = """
seed_everything: 7
trainer:
  max_steps: 2
  log_every_n_steps: 1
  ckpt_every_n_steps: 100
  default_root_dir: {root}
model:
  class_path: dmme_tpu.training.LitDDPM
  init_args:
    warmup: 10
    timesteps: 16
    dtype: f32
    model:
      class_path: dmme_tpu.models.ddpm.UNet
      init_args: {{pos_dim: 4, emb_dim: 8, num_groups: 2, channels_per_depth: [4, 8, 8],
                   num_blocks: 1, fused_norm: true, fused_block: true}}
data:
  class_path: dmme_tpu.data.CIFAR10
  init_args: {{synthetic: true, synthetic_size: 16, batch_size: 4}}
"""


def test_driver_rounds(tmp_path, capsys):
    """The driver with no teacher checkpoint warns and distils the untrained
    ε teacher (T = 16: rounds of 4 then 2 steps, 2 train steps each, a
    checkpoint per round); after ``trainer fit`` writes one it restores the
    teacher from it; rounds stop after an odd N."""
    from dmme_tpu_torch import distill
    from dmme_tpu_torch.trainer import main as trainer_main
    from dmme_tpu_torch.training import CheckpointManager

    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(DRIVER_YAML.format(root=tmp_path / "teacher"))
    common = ["--config", str(cfg), "--steps-per-round", "2"]
    rounds = distill.main(common + ["--start-steps", "4", "--rounds", "3",
                                    "--out", str(tmp_path / "a")], device="cpu")
    assert "no teacher checkpoint found" in capsys.readouterr().err
    assert rounds == [(4, f"{tmp_path}/a/round_0_steps_4"), (2, f"{tmp_path}/a/round_1_steps_2"),
                      (1, f"{tmp_path}/a/round_2_steps_1")]
    for _, out in rounds:
        assert CheckpointManager(out).steps() == [2]

    trainer_main(["fit", "--config", str(cfg)], device="cpu")
    capsys.readouterr()
    rounds = distill.main(common + ["--rounds", "2", "--start-steps", "3",
                                    "--out", str(tmp_path / "b")], device="cpu")
    out = capsys.readouterr()
    assert "teacher restored from" in out.out and "@ step 2" in out.out
    assert rounds == [(3, f"{tmp_path}/b/round_0_steps_3")]
    assert distill.parse_args(["--config", "x"]).decay == 0.999


def test_k4_weight_cache_keeps_no_weight_state_alive():
    """Fault C.10: K4's packed-weight cache held its source tensors, so the
    teacher of a finished distillation round stayed allocated until 64 newer
    entries pushed it out (0.305 GiB after a 2-round driver run on the
    card). An entry now holds its sources weakly and goes with them; while
    they live it is found again, and an in-place update makes a new one."""
    import gc
    import weakref

    from dmme_tpu_torch.ops import resblock

    resblock._PACKED.clear()
    g = torch.Generator().manual_seed(0)
    w1, w2 = torch.randn(16, 8, 3, 3, generator=g), torch.randn(16, 16, 3, 3, generator=g)
    b1, b2 = torch.randn(16, generator=g), torch.randn(16, generator=g)
    wr, br = torch.randn(16, 8, 1, 1, generator=g), torch.randn(16, generator=g)
    for dtype in (torch.bfloat16, torch.float32):
        packed = resblock.pack_weights(w1, b1, w2, b2, wr, br, dtype=dtype)
        assert resblock.pack_weights(w1, b1, w2, b2, wr, br, dtype=dtype) is packed
        assert all(p.data_ptr() not in {t.data_ptr() for t in (w1, b1, w2, b2, wr, br)}
                   for p in packed if p is not None)
    assert len(resblock._PACKED) == 2
    with torch.no_grad():
        b2.add_(1.0)
    assert resblock.pack_weights(w1, b1, w2, b2, wr, br) is not packed
    assert len(resblock._PACKED) == 3
    ref = weakref.ref(w2)
    del w1, b1, w2, b2, wr, br, packed
    gc.collect()
    assert ref() is None and len(resblock._PACKED) == 0
