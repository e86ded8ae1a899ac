"""Two ranks of the port on the CPU (gloo processes) against JAX's meshes and
against one process.

One group of two workers (tests/torch_port_dist_worker.py) runs every
scenario in one process group, and a second group takes the SIGTERM check;
both start with the module's fixture and have a deadline that kills them,
so a hang fails instead of running into the suite's limit. Meanwhile this
process computes JAX's side: ``make_train_step`` on ``shard_state`` /
``shard_batch`` over ``make_mesh(jax.devices()[:2], data=2)`` and over
``(data=1, fsdp=2)``, on the same seeded weights and injected (t, ε) that
the ranks slice (``parallel.shard_batch``). Tolerances are
tests/test_torch_port_training.py::test_three_train_steps_match's; the
data mesh against one accumulating process, and a resumed run against an
uninterrupted one, are bitwise; fsdp against data is within 1e-6.
"""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmme_tpu.models import ddpm as jax_ddpm
from dmme_tpu.parallel import make_mesh as jax_make_mesh
from dmme_tpu.parallel import make_train_step as jax_make_train_step
from dmme_tpu.parallel import shard_batch as jax_shard_batch
from dmme_tpu.parallel import shard_state as jax_shard_state
from dmme_tpu.training import LitDDPM as JaxLitDDPM
from dmme_tpu.training import TrainState as JaxTrainState
from dmme_tpu_torch.parallel import mp_check
from dmme_tpu_torch.parallel.distributed import free_port
from dmme_tpu_torch.training import CheckpointManager, fit, warmup_schedule
from dmme_tpu_torch.utils.convert import from_flax
from tests.torch_port_dist_worker import FIT_BATCH, FIT_STEPS, fit_data, fit_lit

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_port_dist_worker.py")
#: seconds a spawned group may take before it is killed
DEADLINE = 300
UNET = dict(pos_dim=4, emb_dim=8, num_groups=2, channels_per_depth=(8, 16), num_blocks=1,
            attention_depths=(1,), dropout=0.0)
SHAPE = (4, 8, 8, 3)  # the global batch: 2 rows a rank
T = 20
GRAD_CLIP = 0.05  # below the steps' gradient norms: the clip's sharded norm is exercised
OPT = dict(lr=1e-3, warmup=3, decay=0.9, grad_clip=GRAD_CLIP, ema_every_n_steps=2)
MIN_WEIGHT_SIZE = 64
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
FSDP_REL = 1e-6


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


def _batches():
    out = []
    for k in range(3):
        r = np.random.default_rng(10 + k)
        out.append((np.clip(r.standard_normal(SHAPE), -1, 1).astype(np.float32),
                    r.integers(1, T, (SHAPE[0],)).astype(np.int32),
                    r.standard_normal(SHAPE).astype(np.float32)))
    return out


def _spawn(out, scenarios, world=2):
    os.makedirs(out, exist_ok=True)
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = []
    for rank in range(world):
        logs = [open(os.path.join(out, f"{s}.{rank}.log"), "w") for s in ("out", "err")]
        procs.append((subprocess.Popen(
            [sys.executable, WORKER, out, str(rank), str(world), str(port), *scenarios],
            env=env, stdout=logs[0], stderr=logs[1], cwd=ROOT), logs))
    return procs


def _wait(procs, deadline):
    """Return codes (None: killed at the deadline) and each rank's stderr."""
    rcs = []
    for p, logs in procs:
        try:
            rcs.append(p.wait(timeout=max(0.1, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rcs.append(None)
        for f in logs:
            f.close()
    errs = [open(logs[1].name).read() for _, logs in procs]
    return rcs, errs


def _jax_steps(jparams, batches):
    """JAX's three steps over each mesh: {kind: [(flat state, metrics)]}."""
    jlit = JaxLitDDPM(model=jax_ddpm.UNet(**UNET, fused_norm=True), timesteps=T, **OPT)

    def loss_fn(params, rng, batch):
        x0, t, eps = batch
        return jlit.diffusion_model.loss_given(jlit.model_fn, params, x0, t, eps, train=True)

    devices = jax.devices()[:2]
    out = {}
    for kind, mesh, size in (("data", jax_make_mesh(devices, data=2), 2**14),
                             ("fsdp", jax_make_mesh(devices, data=1, fsdp=2), MIN_WEIGHT_SIZE)):
        state = jax_shard_state(JaxTrainState.create(jparams, jlit.make_optimizer(),
                                                     ema_decay=0.9, ema_every_n_steps=2),
                                mesh, size)
        step = jax_make_train_step(loss_fn, donate=False)
        records = []
        for batch in batches:
            state, m = step(state, jax_shard_batch(tuple(jnp.asarray(a) for a in batch), mesh),
                            jax.random.PRNGKey(0))
            adam = state.opt_state[1][0]
            flat = {name: from_flax(jax.tree_util.tree_map(np.asarray, tree)) for name, tree in
                    (("params", state.params), ("ema", state.ema_params), ("mu", adam.mu),
                     ("nu", adam.nu))}
            records.append((flat, {k: float(v) for k, v in m.items()}))
        out[kind] = records
    return out


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("dist"))
    main_dir, term_dir = os.path.join(base, "main"), os.path.join(base, "term")
    os.makedirs(main_dir)
    # the one-process run that the ranks resume (C): batch 4, 2 accumulated
    fit(fit_lit(), fit_data(FIT_BATCH // 2), 2, seed=0, log_every=1, ckpt_every=2,
        accumulate_grad_batches=2, ckpt_dir=os.path.join(main_dir, "C"), device="cpu")
    jmodel = jax_ddpm.UNet(**UNET, fused_norm=True)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros(SHAPE),
                            jnp.zeros((SHAPE[0],), jnp.int32))
    jparams = _random_params(shapes)
    batches = _batches()
    torch.save({"params": from_flax(jparams), "unet": dict(UNET, fused_norm=True,
                                                            fused_block=True),
                "T": T, "opt": OPT, "min_weight_size": MIN_WEIGHT_SIZE,
                "batches": [(torch.tensor(x), torch.tensor(t, dtype=torch.int64),
                             torch.tensor(e)) for x, t, e in batches]},
               os.path.join(main_dir, "steps_input.pt"))
    deadline = time.monotonic() + DEADLINE
    main = _spawn(main_dir, ["steps", "sizes", "nomesh", "fits", "evaluate"])
    term = _spawn(term_dir, ["sigterm"])
    try:
        jax_records = _jax_steps(jparams, batches)
    finally:
        main_rcs, main_errs = _wait(main, deadline)
        term_rcs, term_errs = _wait(term, deadline)
    return dict(dir=main_dir, term_dir=term_dir, rcs=main_rcs, errs=main_errs,
                term_rcs=term_rcs, term_errs=term_errs, jax=jax_records)


def _ok(group):
    assert group["rcs"] == [0, 0], "\n".join(e[-3000:] for e in group["errs"])
    return group["dir"]


def _off_key_bias(name, v):
    """``v`` flattened, less the key third of a ``qkv_proj.bias``: softmax is
    invariant to it, so its gradient is rounding noise, which Adam scales to
    a step of ±lr whatever its size; a last-bit change elsewhere (the CPU's
    vector loops round a shard's tail apart from the whole tensor's) redraws
    that noise (test_three_train_steps_match leaves it out the same way)."""
    v = v.reshape(-1)
    if name.endswith("qkv_proj.bias"):
        c = v.shape[0] // 3
        return torch.cat([v[:c], v[2 * c:]])
    return v


def _note(out, name, rank):
    with open(os.path.join(out, f"{name}.{rank}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("kind", ["data", "fsdp"])
def test_three_mesh_steps_match_jax(group, kind):
    """Params, EMA and Adam's moments after each of three injected steps on
    two ranks, against JAX's step over the same mesh."""
    out = _ok(group)
    got = torch.load(os.path.join(out, f"steps_{kind}.pt"), weights_only=False)
    lr_sum = 0.0
    for k, (rec, (want, jm)) in enumerate(zip(got, group["jax"][kind])):
        lr = warmup_schedule(OPT["lr"], OPT["warmup"])(k)
        lr_sum += lr
        assert rec["step"] == k + 1
        assert jm["grad_norm"] > GRAD_CLIP
        np.testing.assert_allclose(rec["loss"], jm["loss"], **LOSS_TOL)
        np.testing.assert_allclose(rec["grad_norm"], jm["grad_norm"], rtol=2e-3)
        for name in ("params", "ema", "mu", "nu"):
            for key, v in rec[name].items():
                w = want[name][key].numpy()
                if name in ("params", "ema"):
                    atol = np.full(v.shape, 2e-3 * lr)
                    if key.endswith("qkv_proj.bias"):  # the key bias: softmax-invariant
                        c = v.shape[0] // 3
                        atol[c:2 * c] = 2 * lr_sum
                else:
                    atol = (1e-5 if name == "mu" else 1e-7) * GRAD_CLIP ** (
                        1 if name == "mu" else 2)
                diff = np.abs(v.numpy() - w)
                bad = diff > atol + 2e-3 * np.abs(w)
                assert not bad.any(), f"{kind} step {k + 1} {name} {key}: {diff[bad].max():.3e}"


def test_fsdp_steps_agree_with_data_steps_and_halve_the_state(group):
    """fsdp=2 within 1e-6 of data=2 on every tensor; each fsdp rank holds
    about half the bytes of parameters, EMA and moments that a data rank holds."""
    out = _ok(group)
    data, fsdp = (torch.load(os.path.join(out, f"steps_{k}.pt"), weights_only=False)
                  for k in ("data", "fsdp"))
    for a, b in zip(data, fsdp):
        for name in ("params", "ema", "mu", "nu"):
            x = torch.cat([a[name][k].reshape(-1) for k in a[name]])
            y = torch.cat([b[name][k].reshape(-1) for k in a[name]])
            assert float((x - y).norm() / x.norm()) <= FSDP_REL, name
    for rank in (0, 1):
        whole, split = _note(out, "bytes_data", rank), _note(out, "bytes_fsdp", rank)
        assert whole["split"] == [] and split["split"]
        assert 0.45 * whole["bytes"] <= split["bytes"] <= 0.55 * whole["bytes"], (whole, split)


def test_mesh_sizes_over_two_ranks(group):
    out = _ok(group)
    for rank in (0, 1):
        got = _note(out, "sizes", rank)
        assert got["default"] == dict(data=2, fsdp=1, expert=1, tensor=1, spatial=1,
                                      owns=False, batch_ranks=2)
        assert got["fsdp2"]["data"] == 1 and got["fsdp2"]["fsdp"] == 2
        assert got["data2"]["data"] == 2
        assert "(2, 3, 1, 1, 1)" in got["fsdp3"]


def test_fit_in_a_world_of_two_without_a_mesh_raises_jax_message(group):
    out = _ok(group)
    for rank in (0, 1):
        assert "multi-process fit() needs a mesh over the global device list" in \
            _note(out, "nomesh", rank)


def test_resumed_two_rank_runs_are_bitwise_the_uninterrupted_one(group):
    """B (2 steps, then resumed to 4) and C (2 steps of one process at half
    the batch with 2 accumulated microbatches, resumed on two ranks) end
    bitwise on A's state (4 uninterrupted steps on two ranks)."""
    out = _ok(group)
    a = CheckpointManager(os.path.join(out, "A")).load(FIT_STEPS)
    for run in ("B", "C"):
        b = CheckpointManager(os.path.join(out, run)).load(FIT_STEPS)
        assert b["step"] == a["step"] == FIT_STEPS
        for part in ("params", "ema_params"):
            for k, v in a[part].items():
                assert torch.equal(v, b[part][k]), f"{run} {part}.{k}"
        for part in ("mu", "nu"):
            for k, v in a["opt_state"][part].items():
                assert torch.equal(v, b["opt_state"][part][k]), f"{run} {part}.{k}"


def test_two_rank_checkpoint_restores_without_a_mesh(group):
    out = _ok(group)
    lit = fit_lit()
    state = CheckpointManager(os.path.join(out, "A")).restore(lit.init_state(0, device="cpu"))
    assert state.step == FIT_STEPS and not state.shard_axes
    images = lit.generate(state, torch.Generator().manual_seed(0), (2, 32, 32, 3))
    assert images.shape == (2, 32, 32, 3) and torch.isfinite(images).all()


def test_fsdp_fit_writes_on_rank_zero_and_agrees_with_data(group):
    """D (fsdp=2): one metrics line a step and one grid (rank 0's), the
    log echoed by rank 0 alone; its saved state whole, within 1e-6 of A's."""
    out = _ok(group)
    with open(os.path.join(out, "D", "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == list(range(1, FIT_STEPS + 1))
    assert os.listdir(os.path.join(out, "D", "samples")) == [f"step_{FIT_STEPS:08d}.png"]
    assert "[step 4]" in group["errs"][0] and "[step" not in group["errs"][1]
    a = CheckpointManager(os.path.join(out, "A")).load(FIT_STEPS)["params"]
    d = CheckpointManager(os.path.join(out, "D")).load(FIT_STEPS)["params"]
    x, y = (torch.cat([_off_key_bias(k, p[k]) for k in a]) for p in (a, d))
    assert float((x - y).norm() / x.norm()) <= FSDP_REL
    notes = [_note(out, "fsdp_fit", r) for r in (0, 1)]
    assert notes[0] == notes[1] and notes[0]["split"] > 0


def test_two_rank_test_matches_one_rank(group):
    """test() on two ranks (batch i on rank i mod 2, the statistics summed
    over the ranks) gives the FID and IS of one process (rank 0 after)."""
    out = _ok(group)
    got = [_note(out, "test", r) for r in (0, 1)]
    assert got[0] == got[1]
    want = _note(out, "test_one", 0)
    assert got[0]["num_batches"] == want["num_batches"] == 2
    for key in ("fid", "inception_score", "inception_score_std"):
        np.testing.assert_allclose(got[0][key], want[key], rtol=1e-6)


def test_sigterm_to_one_rank_stops_both_at_one_safe_point(group):
    """Rank 1 alone gets SIGTERM after step 3: both ranks stop at the next
    safe point (step 4), one checkpoint is written there, and both die by
    SIGTERM."""
    assert group["term_rcs"] == [-signal.SIGTERM, -signal.SIGTERM], \
        "\n".join(e[-3000:] for e in group["term_errs"])
    assert CheckpointManager(os.path.join(group["term_dir"], "S")).steps() == [4]
    for rank in (0, 1):
        with open(os.path.join(group["term_dir"], f"out.{rank}.log")) as f:
            assert "[fit] interrupted: saved step 4" in f.read()


def test_mp_check_invariant():
    """The port's mp_check: two data ranks and two fsdp ranks probe equal,
    data bitwise one accumulating process, fsdp within 1e-6."""
    probes = mp_check.check(2, steps=3, timeout=DEADLINE)
    assert probes["data"][0] == probes["one"][0]
