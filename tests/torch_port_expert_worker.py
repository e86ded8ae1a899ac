"""One rank of tests/test_torch_port_expert.py: a gloo process on the CPU.

    python tests/torch_port_expert_worker.py <dir> <rank> <world> <port>

The process joins a group of ``world`` ranks once and runs, in order: the
expert-parallel ``MoEMlp`` on its slice of the test's input (``layer``),
two-step fits of a tiny MoE-DiT on each expert mesh with and without remat
(``steps``), and the checkpoint round trip (``checkpoints``). Rank 0
writes what the test compares under ``<dir>``, every rank its notes. It
imports neither JAX nor the JAX package.
"""

import os
import sys

import torch

torch.set_num_threads(1)

from dmme_tpu_torch.data import CIFAR10  # noqa: E402
from dmme_tpu_torch.models.dit import DiT  # noqa: E402
from dmme_tpu_torch.models.moe import ExpertGroup, MoEMlp  # noqa: E402
from dmme_tpu_torch.parallel import initialize, make_mesh, shard_state, shutdown  # noqa: E402
from dmme_tpu_torch.training import CheckpointManager, LitFlow, TrainState, fit  # noqa: E402
from dmme_tpu_torch.training.checkpoint import FILE  # noqa: E402

#: the tiny MoE-DiT: 16 tokens of 32 channels, 4 experts in block 1; its
#: (4, 32, 128) stacks reach JAX's 2¹⁴ threshold, so the expert axis splits them
DIT = dict(patch_size=8, hidden=32, depth=2, num_heads=2, num_experts=4, pos_dim=16)
GLOBAL_BATCH = 8
STEPS = 2
#: {name: (mesh axes, min_weight_size)}: at 1024 many leaves split under
#: fsdp and b_in (512) and b_out (128) stay whole, as at full width; at 256
#: the expert axis splits b_in too, as it does from DiT-B's width up
MESHES = {"expert4": (dict(expert=4), 1024), "data2_expert2": (dict(data=2, expert=2), 1024),
          "fsdp2_expert2": (dict(data=1, fsdp=2, expert=2), 1024),
          "expert4_split_b_in": (dict(expert=4), 256)}
#: the mesh whose fit checkpoints, and on which a mesh-less checkpoint is restored
CKPT_MESH = "data2_expert2"


def lit(remat=False):
    return LitFlow(model=DiT(remat=remat, **DIT), lr=1e-3, warmup=1, moe_aux_weight=0.01,
                   sample_steps=2)


def init_state(h):
    """``h``'s state at step 0 with every parameter drawn from one seed: the
    biases and the zero-initialised adaLN and output layers too (at zero
    the MoE branch is gated off and its experts take no gradient)."""
    state = h.init_state(0, device="cpu")
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for k, v in state.params.items():
            fan = v.shape[1] if v.dim() == 3 else v[0].numel() if v.dim() > 1 else 0
            v.copy_(torch.randn(v.shape, generator=g) * (fan ** -0.5 if fan else 0.1))
            state.ema_params[k].copy_(v)
    return state


def data(batch=GLOBAL_BATCH):
    return CIFAR10(synthetic=True, synthetic_size=32, batch_size=batch)


class Recorder:
    """A logger backend that keeps the logged metrics (rank 0's)."""

    def __init__(self):
        self.rows = []

    def log_metrics(self, metrics, step):
        self.rows.append(dict(metrics, step=step))

    def log_image(self, tag, image, step):
        pass

    def finalize(self):
        pass


class FirstGradients:
    """Keeps the (reduced) gradients of a run's first optimizer step,
    taken where ``TrainState.apply_gradients`` receives them."""

    def __init__(self, keep):
        self.keep, self.grads = keep, None

    def __enter__(self):
        self.original = TrainState.apply_gradients

        def apply(state, grads, norm=None):
            if self.grads is None:
                self.grads = {k: v.detach().clone() for k, v in grads.items() if self.keep(k)}
            return self.original(state, grads, norm)

        TrainState.apply_gradients = apply
        return self

    def __exit__(self, *exc):
        TrainState.apply_gradients = self.original


def is_bias(name: str) -> bool:
    return name.endswith(("moe_mlp.b_in", "moe_mlp.b_out"))


def layer(out, rank, world):
    """Each rank's expert-parallel layer on its slice, in eval and training
    mode (the router noise the test drew for the slice)."""
    given = torch.load(os.path.join(out, "layer_input.pt"), weights_only=False)
    m = MoEMlp(*given["dims"], **given["kw"])
    m.load_state_dict(given["state"])
    mesh = make_mesh(expert=world, device="cpu")
    e, p, i = m.num_experts, mesh.expert, mesh.index("expert")
    shards = {k: given["state"][k].chunk(p)[i] for k in ("w_in", "w_out")}
    m.expert_group = ExpertGroup(mesh.expert_group, p, i)
    x = given["x"].chunk(world)[rank]
    got = {}
    with torch.no_grad():
        for mode, train in (("eval", False), ("train", True)):
            y, stats = torch.func.functional_call(
                m, shards, (x,), {"train": train, "noise": given["noise"][rank] if train else None})
            got[mode] = {"y": y, **stats}
    assert e % p == 0
    torch.save(got, os.path.join(out, f"layer.{rank}.pt"))


def steps(out, rank, world):
    """Two steps of the tiny MoE-DiT on each mesh, with and without remat:
    the logged losses and grad norms, the first step's b_in/b_out
    gradients, the gathered state, and the bytes a rank holds."""
    for name, (axes, min_weight_size) in MESHES.items():
        for remat in (False, True):
            mesh = make_mesh(device="cpu", min_weight_size=min_weight_size, **axes)
            rec = Recorder()
            ckpt = os.path.join(out, "ckpt_mesh") if (name == CKPT_MESH and not remat) else None
            h = lit(remat)
            with FirstGradients(is_bias) as first:
                state = fit(h, data(), STEPS, mesh=mesh, seed=0, log_every=1, loggers=[rec],
                            ckpt_dir=ckpt, state=init_state(h), device="cpu")
            held = sum(t.numel() for part in (state.params, state.ema_params,
                                               state.opt_state.mu, state.opt_state.nu)
                       for t in part.values())
            whole = state.whole()
            if rank == 0:
                torch.save({"rows": rec.rows, "bias_grads": first.grads, "held": held,
                            "expert_axes": dict(state.expert_axes),
                            "shard_axes": dict(state.shard_axes),
                            "params": whole.params, "ema": whole.ema_params,
                            "mu": whole.opt_state.mu, "nu": whole.opt_state.nu},
                           os.path.join(out, f"steps_{name}_{int(remat)}.pt"))


def checkpoints(out, rank, world):
    """The test's mesh-less checkpoint restored on the checkpoint mesh (each
    rank checks its shards against the file), then saved from it."""
    axes, min_weight_size = MESHES[CKPT_MESH]
    mesh = make_mesh(device="cpu", min_weight_size=min_weight_size, **axes)
    h = lit()
    state = shard_state(h.init_state(1, device="cpu"), mesh, model=h.model)
    CheckpointManager(os.path.join(out, "plain"), mesh=mesh).restore(state)
    saved = torch.load(os.path.join(out, "plain", str(state.step), FILE), weights_only=True)
    mismatched = []
    for part, mine in (("params", state.params), ("ema_params", state.ema_params),
                       ("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
        src = saved[part] if part in saved else saved["opt_state"][part]
        for k, v in mine.items():
            want = src[k]
            if k in state.expert_axes:
                want = want.chunk(mesh.expert, state.expert_axes[k])[mesh.index("expert")]
            if k in state.shard_axes:
                want = want.chunk(mesh.fsdp, state.shard_axes[k])[mesh.fsdp_index]
            if not torch.equal(v, want):
                mismatched.append(f"{part}.{k}")
    torch.save({"mismatched": mismatched, "split": sorted(state.expert_axes)},
               os.path.join(out, f"restored.{rank}.pt"))
    CheckpointManager(os.path.join(out, "plain_back"), mesh=mesh).save(state.step, state)


def main(argv) -> int:
    out, rank, world, port = argv[0], int(argv[1]), int(argv[2]), int(argv[3])
    initialize(f"localhost:{port}", world, rank, device="cpu")
    try:
        for scenario in (layer, steps, checkpoints):
            scenario(out, rank, world)
            print(f"[expert worker {rank}] {scenario.__name__} done", file=sys.stderr, flush=True)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
