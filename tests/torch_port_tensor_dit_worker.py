"""One rank of tests/test_torch_port_tensor_dit.py: a gloo process on the CPU.

    python tests/torch_port_tensor_dit_worker.py <dir> <rank> <world> <port>

The process joins a group of ``world`` ranks once and runs, in order, on
each tensor mesh of ``MESHES``: the tensor-parallel forward and injected
flow loss of each tiny DiT of ``KINDS`` it names, on the rank's batch
slice of the test's weights and inputs (``forward``), three-step fits of
each from one drawn state (``steps``), and the checkpoint round trip on
``{expert: 2, tensor: 2}`` (``checkpoints``). Rank 0 writes what the test
compares under ``<dir>``, every rank its notes. It imports neither JAX nor
the JAX package.
"""

import os
import sys

import torch

torch.set_num_threads(1)

from torch.func import functional_call  # noqa: E402

from dmme_tpu_torch.data import CIFAR10  # noqa: E402
from dmme_tpu_torch.models.dit import DiT  # noqa: E402
from dmme_tpu_torch.models.moe import ExpertGroup, place_experts  # noqa: E402
from dmme_tpu_torch.parallel import initialize, make_mesh, shard_state, shutdown  # noqa: E402
from dmme_tpu_torch.parallel.mesh import expert_axes, shard_of, tensor_axes  # noqa: E402
from dmme_tpu_torch.parallel.tensor import TensorGroup  # noqa: E402
from dmme_tpu_torch.training import CheckpointManager, LitFlow, fit  # noqa: E402
from dmme_tpu_torch.training.checkpoint import FILE  # noqa: E402
from tests.torch_port_tensor_worker import FirstGradients, GatherSpy, Recorder  # noqa: E402

#: JAX's tiny DiT of tests/test_dit.py::TestSharded (hidden 64, 4 heads, patch 4)
DIT = dict(patch_size=4, hidden=64, depth=2, num_heads=4, pos_dim=16)
CLASSES = 10
#: {kind: DiT keywords}: dropout 0.1; class-conditional with remat; the
#: MoE-DiT (4 experts, top-2, in block 1) with and without remat
KINDS = {"dit": dict(DIT, dropout=0.1),
         "class": dict(DIT, dropout=0.1, num_classes=CLASSES, remat=True),
         "moe": dict(DIT, num_experts=4, moe_top_k=2, remat=True),
         "moe_plain": dict(DIT, num_experts=4, moe_top_k=2)}
#: {name: (mesh axes, min_weight_size, kinds)} on four ranks: two tensor
#: groups of two as data replicas, as the fsdp shards or as the expert
#: shards of one batch slice, at JAX's test threshold (64: every kernel,
#: the router and the expert biases split); at 2048 the router, the expert
#: biases and a time-embedding kernel stay whole, as at full width
MESHES = {"data2_tensor2": (dict(tensor=2), 64, ("dit", "class", "moe")),
          "fsdp2_tensor2": (dict(data=1, fsdp=2, tensor=2), 64, ("dit", "class", "moe")),
          "expert2_tensor2": (dict(data=1, expert=2, tensor=2), 64, ("moe",)),
          "tensor2_min2048": (dict(tensor=2), 2048, ("moe_plain",))}
MOE_AUX_WEIGHT = 0.01
GLOBAL_BATCH = 8
STEPS = 3
#: the mesh and kind whose fit checkpoints, and on which a mesh-less checkpoint is restored
CKPT = ("expert2_tensor2", "moe")


def lit(kind):
    kw = KINDS[kind]
    extra = {"num_classes": CLASSES} if "num_classes" in kw else {}
    if "num_experts" in kw:
        extra["moe_aux_weight"] = MOE_AUX_WEIGHT
    return LitFlow(model=DiT(**kw), lr=1e-3, warmup=1, sample_steps=2, **extra)


def init_state(h):
    """``h``'s state at step 0 with every parameter drawn from one seed: the
    biases and the zero-initialised adaLN and output layers too (at zero
    every residual branch is gated off and its layers take no gradient)."""
    state = h.init_state(0, device="cpu")
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for k, v in state.params.items():
            fan = v.shape[1] if v.dim() == 3 else v[0].numel() if v.dim() > 1 else 0
            v.copy_(torch.randn(v.shape, generator=g) * (fan ** -0.5 if fan else 0.1))
            state.ema_params[k].copy_(v)
    return state


def data(kind, batch=GLOBAL_BATCH):
    return CIFAR10(synthetic=True, synthetic_size=32, batch_size=batch,
                   with_labels="num_classes" in KINDS[kind])


def place(model, mesh, whole):
    """This rank's shards of the ``whole`` state dict on ``mesh`` (each
    expert stack's expert shard, then its tensor shard), ``model`` told
    where they live: what ``shard_state`` does, without the fsdp split."""
    experts = expert_axes(whole, mesh)
    split = tensor_axes(whole, mesh)
    model.place_tensor(TensorGroup(mesh.tensor_group, mesh.tensor, mesh.index("tensor")), split)
    place_experts(model, ExpertGroup(mesh.expert_group, mesh.expert, mesh.index("expert"))
                  if experts else None)
    params = {}
    for k, v in whole.items():
        if k in experts:
            v = shard_of(mesh, v, experts[k], "expert")
        if k in split:
            v = shard_of(mesh, v, split[k], "tensor")
        params[k] = v
    return params, split, experts


def forward(out, rank, world):
    """Each DiT's eval forward and injected flow loss on the rank's tensor
    (and expert) shards of the test's whole weights and its batch slice:
    the slice's whole output on every rank of a tensor group."""
    given = torch.load(os.path.join(out, "forward_input.pt"), weights_only=False)
    got = {}
    for name, (axes, min_weight_size, kinds) in MESHES.items():
        mesh = make_mesh(device="cpu", min_weight_size=min_weight_size, **axes)
        for kind in kinds:
            g = given[kind]
            h = lit(kind)
            params, split, experts = place(h.model, mesh, g["state"])
            mine = {k: None if v is None else v.chunk(mesh.batch_ranks)[mesh.batch_index]
                    for k, v in g.items() if k != "state"}
            kw = {} if mine["y"] is None else {"y": mine["y"]}

            def model_fn(p, x, t, **k):
                return functional_call(h.model, p, (x, t), {**k, **kw})

            with torch.no_grad():
                y = model_fn(params, mine["x"], mine["t"])
                loss = h.diffusion_model.loss_given(model_fn, params, mine["x0"], mine["s"],
                                                    mine["x1"])
            got[f"{name}/{kind}"] = {"y": y, "loss": loss, "split": sorted(split),
                                     "experts": sorted(experts), "slice": mesh.batch_index}
    torch.save(got, os.path.join(out, f"forward.{rank}.pt"))


def steps(out, rank, world):
    """Three steps of each DiT on each mesh: the logged losses and grad
    norms, the first step's reduced gradients, what the step's all-gathers
    over the tensor group sent against the split kernels' shards, the
    gathered state, and the elements a rank holds."""
    for name, (axes, min_weight_size, kinds) in MESHES.items():
        for kind in kinds:
            mesh = make_mesh(device="cpu", min_weight_size=min_weight_size, **axes)
            h = lit(kind)
            state = init_state(h)
            params, split, _ = place(DiT(**KINDS[kind]), mesh, state.params)
            shards = [params[k].reshape(-1) for k in split]
            del params
            rec = Recorder()
            ckpt = os.path.join(out, "ckpt_mesh") if (name, kind) == CKPT else None
            with GatherSpy(mesh.tensor_group) as spy, FirstGradients(spy) as first:
                state = fit(h, data(kind), STEPS, mesh=mesh, seed=0, log_every=1,
                            loggers=[rec], ckpt_dir=ckpt, state=state, device="cpu")
            weights_sent = sum(1 for t in spy.sent for s in shards
                               if t.numel() == s.numel() and torch.equal(t, s))
            held = sum(t.numel() for part in (state.params, state.ema_params,
                                               state.opt_state.mu, state.opt_state.nu)
                       for t in part.values())
            whole = state.whole()
            if rank == 0:
                torch.save({"rows": rec.rows, "grads": first.grads, "held": held,
                            "gathers": len(spy.sent), "weights_sent": weights_sent,
                            "tensor_axes": dict(state.tensor_axes),
                            "expert_axes": dict(state.expert_axes),
                            "shard_axes": dict(state.shard_axes),
                            "params": whole.params, "ema": whole.ema_params,
                            "mu": whole.opt_state.mu, "nu": whole.opt_state.nu},
                           os.path.join(out, f"steps_{name}_{kind}.pt"))


def checkpoints(out, rank, world):
    """The test's mesh-less checkpoint restored on the checkpoint mesh (each
    rank checks its shards against the file: expert, then tensor), then
    saved from it."""
    name, kind = CKPT
    axes, min_weight_size, _ = MESHES[name]
    mesh = make_mesh(device="cpu", min_weight_size=min_weight_size, **axes)
    h = lit(kind)
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
            if k in state.tensor_axes:
                want = want.chunk(mesh.tensor, state.tensor_axes[k])[mesh.index("tensor")]
            if not torch.equal(v, want):
                mismatched.append(f"{part}.{k}")
    torch.save({"mismatched": mismatched, "split": sorted(state.tensor_axes),
                "experts": sorted(state.expert_axes)},
               os.path.join(out, f"restored.{rank}.pt"))
    CheckpointManager(os.path.join(out, "plain_back"), mesh=mesh).save(state.step, state)


def main(argv) -> int:
    out, rank, world, port = argv[0], int(argv[1]), int(argv[2]), int(argv[3])
    initialize(f"localhost:{port}", world, rank, device="cpu")
    try:
        for scenario in (forward, steps, checkpoints):
            scenario(out, rank, world)
            print(f"[tensor dit worker {rank}] {scenario.__name__} done", file=sys.stderr,
                  flush=True)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
