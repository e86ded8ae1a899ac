"""One rank of tests/test_torch_port_distributed.py: a gloo process on the CPU.

    python tests/torch_port_dist_worker.py <dir> <rank> <world> <port> <scenario> ...

The process joins the group once and runs the scenarios in order in it;
each writes what the test compares under ``<dir>`` (rank 0 the states and
results, every rank its own notes). It imports neither JAX nor the JAX
package: the test computes JAX's side itself.
"""

import json
import os
import signal
import sys

import torch

torch.set_num_threads(1)

from dmme_tpu_torch.callbacks import GenerateImage  # noqa: E402
from dmme_tpu_torch.data import CIFAR10  # noqa: E402
from dmme_tpu_torch.models import ddpm as t_ddpm  # noqa: E402
from dmme_tpu_torch.parallel import (  # noqa: E402
    initialize, make_mesh, make_train_step, shard_batch, shard_state, shutdown)
from dmme_tpu_torch.training import LitDDPM, TrainState, fit  # noqa: E402
from dmme_tpu_torch.training.evaluate import test as evaluate_test  # noqa: E402

#: the fitting scenarios' UNet, data and run
FIT_UNET = dict(pos_dim=4, emb_dim=8, num_groups=2, channels_per_depth=(8, 16), num_blocks=1,
                attention_depths=(1,), dropout=0.1, fused_norm=True, fused_block=True)
FIT_T = 10
FIT_STEPS = 4
FIT_BATCH = 8
#: the fsdp runs split every leaf of this many elements or more
MIN_WEIGHT_SIZE = 16


def fit_lit():
    return LitDDPM(model=t_ddpm.UNet(**FIT_UNET), timesteps=FIT_T, warmup=2, lr=1e-3)


def fit_data(batch=FIT_BATCH):
    return CIFAR10(synthetic=True, synthetic_size=32, batch_size=batch)


def state_bytes(state) -> int:
    """Bytes of the parameters, EMA and both Adam moments this rank holds."""
    return sum(t.numel() * t.element_size() for part in (
        state.params, state.ema_params, state.opt_state.mu, state.opt_state.nu)
        for t in part.values())


def _copy(state) -> dict:
    """The state's tensors as they are now (a state on a data mesh is its
    own whole, and the next step updates it in place)."""
    def clone(d):
        return {k: v.clone() for k, v in d.items()}

    return {"step": state.step, "params": clone(state.params), "ema": clone(state.ema_params),
            "mu": clone(state.opt_state.mu), "nu": clone(state.opt_state.nu)}


def _note(out, name, rank, value) -> None:
    with open(os.path.join(out, f"{name}.{rank}.json"), "w") as f:
        json.dump(value, f)


def steps(out, rank):
    """Three injected steps on a data=2 mesh, then on a (data=1, fsdp=2) one,
    from the test's weights and global batches; rank 0 saves the whole state
    after each, every rank its state's bytes."""
    given = torch.load(os.path.join(out, "steps_input.pt"), weights_only=False)
    lit = LitDDPM(model=t_ddpm.UNet(**given["unet"]), timesteps=given["T"], **given["opt"])

    def loss_fn(params, generator, batch):
        x0, t, eps = batch
        return lit.diffusion_model.loss_given(lit.model_fn, params, x0, t, eps, train=True,
                                              generator=generator)

    for kind, mesh in (("data", make_mesh(device="cpu")),
                       ("fsdp", make_mesh(data=1, fsdp=2, device="cpu",
                                          min_weight_size=given["min_weight_size"]))):
        params = {k: v.clone() for k, v in given["params"].items()}
        state = shard_state(TrainState.create(params, lit.make_optimizer(),
                                              ema_decay=lit.decay,
                                              ema_every_n_steps=lit.ema_every_n_steps), mesh)
        _note(out, f"bytes_{kind}", rank, {"bytes": state_bytes(state),
                                           "split": sorted(state.shard_axes)})
        step = make_train_step(loss_fn, mesh=mesh)
        records = []
        for batch in given["batches"]:
            state, metrics = step(state, shard_batch(batch, mesh), 0)
            whole = state.whole()
            records.append(dict(_copy(whole), **{k: float(v) for k, v in metrics.items()}))
        if rank == 0:
            torch.save(records, os.path.join(out, f"steps_{kind}.pt"))


def sizes(out, rank):
    """make_mesh over the group: its shapes, and JAX's assertion."""
    got = {}
    for name, kw in (("default", {}), ("fsdp2", dict(fsdp=2)), ("data2", dict(data=2))):
        mesh = make_mesh(device="cpu", **kw)
        got[name] = dict(dict(mesh.shape), owns=mesh.owns_group, batch_ranks=mesh.batch_ranks)
    try:
        make_mesh(fsdp=3, device="cpu")
    except AssertionError as e:
        got["fsdp3"] = repr(e)
    _note(out, "sizes", rank, got)


def fits(out, rank):
    """Fits on the group: A uninterrupted (data=2, 4 steps); B 2 steps then
    resumed to 4; C resumed from the test's one-process checkpoint; D fsdp=2
    with a GenerateImage grid at the end."""
    data = make_mesh(device="cpu")
    common = dict(seed=0, log_every=1, ckpt_every=2, device="cpu")
    fit(fit_lit(), fit_data(), FIT_STEPS, mesh=data, ckpt_dir=os.path.join(out, "A"), **common)
    fit(fit_lit(), fit_data(), 2, mesh=data, ckpt_dir=os.path.join(out, "B"), **common)
    fit(fit_lit(), fit_data(), FIT_STEPS, mesh=data, ckpt_dir=os.path.join(out, "B"),
        resume=True, **common)
    fit(fit_lit(), fit_data(), FIT_STEPS, mesh=data, ckpt_dir=os.path.join(out, "C"),
        resume=True, **common)
    fsdp = make_mesh(data=1, fsdp=2, device="cpu", min_weight_size=MIN_WEIGHT_SIZE)
    grid = GenerateImage(imgsize=(3, 32, 32), every_n_steps=1000, num_samples=2, vis_length=2,
                         out_dir=os.path.join(out, "D", "samples"))
    state = fit(fit_lit(), fit_data(), FIT_STEPS, mesh=fsdp, ckpt_dir=os.path.join(out, "D"),
                callbacks=[grid], **common)
    _note(out, "fsdp_fit", rank, {"bytes": state_bytes(state), "split": len(state.shard_axes)})


def nomesh(out, rank):
    """fit in a world of 2 without a mesh: JAX's ValueError."""
    try:
        fit(fit_lit(), fit_data(), 1, device="cpu")
        got = None
    except ValueError as e:
        got = str(e)
    _note(out, "nomesh", rank, got)


def evaluate(out, rank):
    """test() on the data=2 mesh from run A's checkpoint, 2 batches of 4;
    then rank 0 alone runs it without a mesh, the one-process reference."""
    def run(mesh):
        return evaluate_test(fit_lit(), CIFAR10(synthetic=True, synthetic_size=8, batch_size=4),
                             ckpt_dir=os.path.join(out, "A"), max_batches=2, mesh=mesh,
                             device="cpu")

    _note(out, "test", rank, run(make_mesh(device="cpu")))
    if rank == 0:
        _note(out, "test_one", rank, run(None))


class _TermAt:
    """Send this process SIGTERM at the end of step ``at``."""

    def __init__(self, at):
        self.at = at

    def on_train_step_end(self, step):
        if step == self.at:
            os.kill(os.getpid(), signal.SIGTERM)


def sigterm(out, rank):
    """A long fit in which rank 1 alone gets SIGTERM after step 3."""
    fit(fit_lit(), fit_data(), 1000, mesh=make_mesh(device="cpu"), seed=0, log_every=1,
        ckpt_every=10_000, ckpt_dir=os.path.join(out, "S"), device="cpu",
        callbacks=[_TermAt(3)] if rank == 1 else [])


SCENARIOS = {f.__name__: f for f in (steps, sizes, fits, nomesh, evaluate, sigterm)}


def main(argv) -> int:
    out, rank, world, port = argv[0], int(argv[1]), int(argv[2]), int(argv[3])
    initialize(f"localhost:{port}", world, rank, device="cpu")
    try:
        for name in argv[4:]:
            SCENARIOS[name](out, rank)
            print(f"[worker {rank}] {name} done", file=sys.stderr, flush=True)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
