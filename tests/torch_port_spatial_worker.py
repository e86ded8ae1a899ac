"""One rank of tests/test_torch_port_spatial.py: a gloo process on the CPU.

    python tests/torch_port_spatial_worker.py <dir> <rank> <world> <port> <port2>

The process joins a group of ``world`` ranks and runs, in order: each layer
of ``layer_cases`` on the rank's rows of the test's whole input over a
spatial group of 2 (``{data: 2, spatial: 2}``) and of 4 (``{spatial: 4}``),
forward and backward (``layers``); on ``{data: 2, spatial: 2}`` and
``{fsdp: 2, spatial: 2}``, one step of each TINY UNet of ``KINDS`` at
dropout 0 on the test's weights with (t, ε) injected, its loss and reduced
gradient (``parity``), then three-step fits from one drawn state at dropout
0.1 (``steps``) and the checkpoint round trip (``checkpoints``). Ranks 0 and
1 then join a second group of two on ``port2`` and run ``parity`` and
``steps`` on ``{spatial: 2}``. Rank 0 writes what the test compares under
``<dir>``, every rank its state's digest. It imports neither JAX nor the
JAX package.
"""

import os
import sys

import torch
import torch.distributed as dist

torch.set_num_threads(1)

from dmme_tpu_torch.data import CIFAR10  # noqa: E402
from dmme_tpu_torch.models import ddpm, iddpm  # noqa: E402
from dmme_tpu_torch.models.blocks import GNSiLU, GroupNorm, conv1x1, conv3x3  # noqa: E402
from dmme_tpu_torch.models.blocks import init_weights  # noqa: E402
from dmme_tpu_torch.parallel import (initialize, make_mesh, shard_batch,  # noqa: E402
                                     shard_state, shutdown)
from dmme_tpu_torch.parallel.mesh import gather_leaves, shard_of  # noqa: E402
from dmme_tpu_torch.parallel.spatial import SpatialGroup  # noqa: E402
from dmme_tpu_torch.parallel.train_step import make_train_step  # noqa: E402
from dmme_tpu_torch.training import (CheckpointManager, LitDDPM, LitIDDPM,  # noqa: E402
                                     TrainState, fit)
from dmme_tpu_torch.training.checkpoint import FILE  # noqa: E402

TINY = dict(pos_dim=4, emb_dim=8, num_groups=2, channels_per_depth=(4, 8, 8, 8), num_blocks=1)
#: {kind: (family, UNet keywords)}: the DDPM UNet on the plain GroupNorm; the
#: IDDPM UNet (FiLM, two heads, attention at two depths) on the fused
#: GroupNorm's split entries, with remat
KINDS = {"ddpm": ("ddpm", dict(TINY)),
         "iddpm": ("iddpm", dict(TINY, num_heads=2, attention_depths=(2, 3), fused_norm=True,
                                 remat=True))}
TIMESTEPS = 20
#: {name: mesh axes} on four ranks; ``spatial2`` runs on the second group of two
MESHES = {"data2_spatial2": dict(data=2, spatial=2),
          "fsdp2_spatial2": dict(data=1, fsdp=2, spatial=2)}
PAIR = {"spatial2": dict(spatial=2)}
#: JAX's test_spatial_train_step_matches_single: small leaves split under fsdp
MIN_WEIGHT_SIZE = 64
GLOBAL_BATCH = 8
STEPS = 3
DROPOUT = 0.1
CKPT = ("fsdp2_spatial2", "ddpm")
#: the layers' whole input: (N, H, W, C)
LAYER_SHAPE = (2, 8, 6, 16)
LAYER_GROUPS = 4
#: {name: spatial group size}: the meshes the layers run on
LAYER_MESHES = {"spatial2": dict(data=2, spatial=2), "spatial4": dict(spatial=4)}


def model(kind, dropout=DROPOUT):
    family, kw = KINDS[kind]
    return (iddpm if family == "iddpm" else ddpm).UNet(**kw, dropout=dropout)


def lit(kind, dropout=DROPOUT):
    cls = LitIDDPM if KINDS[kind][0] == "iddpm" else LitDDPM
    return cls(model=model(kind, dropout), timesteps=TIMESTEPS, lr=1e-3, warmup=1)


def init_state(h):
    """``h``'s state at step 0 with every parameter drawn from one seed:
    each bias and GroupNorm affine at random."""
    state = h.init_state(0, device="cpu")
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for k, v in state.params.items():
            scale = v[0].numel() ** -0.5 if v.dim() > 1 else 0.1
            offset = 1.0 if k.endswith("norm1.weight") or k.endswith("norm2.weight") else 0.0
            v.copy_(torch.randn(v.shape, generator=g) * scale + offset)
            state.ema_params[k].copy_(v)
    return state


def data(batch=GLOBAL_BATCH):
    return CIFAR10(synthetic=True, synthetic_size=32, batch_size=batch)


def layer_cases():
    """{name: (module, extra inputs, call)}: each layer drawn from a fixed
    seed (every bias and GroupNorm affine at random); ``call(module, x,
    extra, spatial)`` runs it on rows (``spatial``) or whole (None). The
    extra inputs are the whole (N, C) pre-bias or FiLM rows, whose
    gradients are partial sums over the spatial group."""
    g = torch.Generator().manual_seed(21)
    n, _, _, c = LAYER_SHAPE

    def drawn(m):
        init_weights(m, g)
        with torch.no_grad():
            for k, v in m.named_parameters():
                if v.dim() == 1:
                    v.copy_(torch.randn(v.shape, generator=g) * 0.1 + (k == "weight"))
        return m

    def rows(shape):
        return torch.randn(shape, generator=g)

    return {
        "conv3x3": (drawn(conv3x3(c, 8)), {}, lambda m, x, e, s: m(x, s)),
        "conv3x3_stride2": (drawn(conv3x3(c, 8, 2)), {}, lambda m, x, e, s: m(x, s)),
        "conv1x1": (drawn(conv1x1(c, 8)), {}, lambda m, x, e, s: m(x, s)),
        "group_norm": (drawn(GroupNorm(LAYER_GROUPS, c)), {}, lambda m, x, e, s: m(x, s)),
        "gn_silu_pre_bias": (drawn(GNSiLU(LAYER_GROUPS, c)), {"pre_bias": rows((n, c))},
                             lambda m, x, e, s: m(x, pre_bias=e["pre_bias"], spatial=s)),
        "gn_silu_film": (drawn(GNSiLU(LAYER_GROUPS, c)),
                         {"scale": 0.1 * rows((n, c)), "shift": 0.1 * rows((n, c))},
                         lambda m, x, e, s: m(x, film_scale=e["scale"], film_shift=e["shift"],
                                              spatial=s)),
    }


def layer_inputs():
    """The whole input and the output weights of each layer case: the loss
    is Σ out·r."""
    g = torch.Generator().manual_seed(22)
    x = torch.randn(LAYER_SHAPE, generator=g)
    n, h, w, _ = LAYER_SHAPE
    r = {}
    for name in layer_cases():
        half = 2 if name.endswith("stride2") else 1
        r[name] = torch.randn((n, h // half, w // half,
                               8 if name.startswith("conv") else LAYER_SHAPE[-1]), generator=g)
    return x, r


def _gather_rows(t, where):
    parts = [torch.empty_like(t) for _ in range(where.size)]
    dist.all_gather(parts, t.contiguous(), group=where.group)
    return torch.cat(parts, dim=1)


def layers(out, rank, world):
    """Each layer on the rank's rows: the output, the input's and every
    leaf's gradient of Σ out·r, gathered (rows) or summed (leaves) over the
    spatial group."""
    got = {}
    x, r = layer_inputs()
    for mname, axes in LAYER_MESHES.items():
        mesh = make_mesh(device="cpu", **axes)
        where = SpatialGroup(mesh.spatial_group, mesh.spatial, mesh.index("spatial"))
        for name, (module, extra, call) in layer_cases().items():
            xr = where.rows(x).detach().requires_grad_(True)
            extra = {k: v.detach().requires_grad_(True) for k, v in extra.items()}
            y = call(module, xr, extra, where)
            loss = (y * where.rows(r[name])).sum()
            leaves = dict(module.named_parameters(), **extra)
            grads = torch.autograd.grad(loss, [xr] + list(leaves.values()))
            summed = {}
            for k, v in zip(leaves, grads[1:]):
                v = v.clone()
                dist.all_reduce(v, group=where.group)
                summed[k] = v
            got[f"{mname}/{name}"] = {"y": _gather_rows(y.detach(), where),
                                      "dx": _gather_rows(grads[0], where), "grads": summed}
    if rank == 0:
        torch.save(got, os.path.join(out, "layers.pt"))


class FirstGradients:
    """Keeps the reduced gradients of a run's first optimizer step, where
    ``TrainState.apply_gradients`` receives them, the fsdp shards gathered
    whole (a collective every rank reaches at the same step)."""

    def __init__(self):
        self.grads = None

    def __enter__(self):
        self.original = TrainState.apply_gradients

        def apply(state, grads, norm=None):
            if self.grads is None:
                whole = dict(grads)
                if state.mesh is not None:
                    whole.update(gather_leaves(state.mesh, whole, state.shard_axes))
                self.grads = {k: v.detach().clone() for k, v in whole.items()}
            return self.original(state, grads, norm)

        TrainState.apply_gradients = apply
        return self

    def __exit__(self, *exc):
        TrainState.apply_gradients = self.original


def _digest(state):
    """Every leaf of the gathered state as its raw bytes' int64 sum: equal
    on ranks whose states are bitwise equal."""
    whole = state.whole()
    return {f"{part}.{k}": int(v.contiguous().view(torch.int32).to(torch.int64).sum())
            for part, d in (("params", whole.params), ("ema", whole.ema_params),
                            ("mu", whole.opt_state.mu), ("nu", whole.opt_state.nu))
            for k, v in d.items()}, whole


def parity(out, rank, world, meshes):
    """One step of each UNet at dropout 0 on the test's whole weights, (t, ε)
    injected through ``loss_given``, each batch rank on its slice: the
    step's loss and the first reduced gradient, gathered whole."""
    given = torch.load(os.path.join(out, "parity_input.pt"), weights_only=False)
    got = {}
    for name, axes in meshes.items():
        for kind in KINDS:
            g = given[kind]
            mesh = make_mesh(device="cpu", min_weight_size=MIN_WEIGHT_SIZE, **axes)
            h = lit(kind, dropout=0.0)
            state = h.init_state(0, device="cpu")
            state.params = {k: v.clone() for k, v in g["state"].items()}
            state.ema_params = {k: v.clone() for k, v in g["state"].items()}
            state = shard_state(state, mesh, model=h.model)
            x0, t, eps = (shard_batch(g[k], mesh) for k in ("x0", "t", "eps"))

            def loss_fn(params, generator, batch, h=h, t=t, eps=eps):
                return h.diffusion_model.loss_given(h.model_fn, params, batch, t, eps,
                                                    train=True, generator=generator)

            with FirstGradients() as first:
                state, metrics = make_train_step(loss_fn, mesh=mesh)(state, x0, 0)
            digest, _ = _digest(state)
            got[f"{name}/{kind}"] = {"loss": float(metrics["loss"]), "grads": first.grads,
                                     "digest": digest}
    torch.save(got, os.path.join(out, f"parity_{world}.{rank}.pt"))


def steps(out, rank, world, meshes):
    """Three steps of each UNet on each mesh: the logged losses and grad
    norms, the first step's reduced gradients, the gathered state and its
    digest."""
    for name, axes in meshes.items():
        for kind in KINDS:
            mesh = make_mesh(device="cpu", min_weight_size=MIN_WEIGHT_SIZE, **axes)
            h = lit(kind)
            rec = Recorder()
            ckpt = os.path.join(out, "ckpt_mesh") if (name, kind) == CKPT else None
            with FirstGradients() as first:
                state = fit(h, data(), STEPS, mesh=mesh, seed=0, log_every=1, loggers=[rec],
                            ckpt_dir=ckpt, state=init_state(h), device="cpu")
            digest, whole = _digest(state)
            torch.save(digest, os.path.join(out, f"digest_{name}_{kind}.{rank}.pt"))
            if rank == 0:
                torch.save({"rows": rec.rows, "grads": first.grads,
                            "shard_axes": dict(state.shard_axes), "params": whole.params,
                            "ema": whole.ema_params, "mu": whole.opt_state.mu,
                            "nu": whole.opt_state.nu},
                           os.path.join(out, f"steps_{name}_{kind}.pt"))


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


def checkpoints(out, rank, world):
    """The test's mesh-less checkpoint restored on the checkpoint mesh (each
    rank checks its shards against the file), then saved from it."""
    name, kind = CKPT
    mesh = make_mesh(device="cpu", min_weight_size=MIN_WEIGHT_SIZE, **MESHES[name])
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
            if k in state.shard_axes:
                want = shard_of(mesh, want, state.shard_axes[k])
            if not torch.equal(v, want):
                mismatched.append(f"{part}.{k}")
    torch.save({"mismatched": mismatched, "split": sorted(state.shard_axes)},
               os.path.join(out, f"restored.{rank}.pt"))
    CheckpointManager(os.path.join(out, "plain_back"), mesh=mesh).save(state.step, state)


def main(argv) -> int:
    out, rank, world, port, port2 = argv[0], int(argv[1]), int(argv[2]), int(argv[3]), int(argv[4])
    initialize(f"localhost:{port}", world, rank, device="cpu")
    try:
        for scenario in (layers, lambda *a: parity(*a, MESHES), lambda *a: steps(*a, MESHES),
                         checkpoints):
            scenario(out, rank, world)
            print(f"[spatial worker {rank}] a {world}-rank scenario done", file=sys.stderr,
                  flush=True)
    finally:
        shutdown()
    if rank < 2:  # {spatial: 2} alone: a second group of the first two ranks
        initialize(f"localhost:{port2}", 2, rank, device="cpu")
        try:
            parity(out, rank, 2, PAIR)
            steps(out, rank, 2, PAIR)
        finally:
            shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
