"""One rank of tests/test_torch_port_spatial_tensor.py: a gloo process on the CPU.

    python tests/torch_port_spatial_tensor_worker.py <dir> <rank> <world> <port>

The process joins a group of ``world`` (four) ranks once and runs, in
order: each layer of ``layer_cases`` on the rank's rows of its channel
shard of the test's whole input on ``{tensor: 2, spatial: 2}``, forward
and backward (``layers``); on that mesh, one step of each TINY UNet of
``KINDS`` at dropout 0 on the test's weights with (t, ε) injected, at a
``min_weight_size`` that splits every kernel and at one that leaves some
whole, its loss and reduced gradient (``parity``); three-step fits from
one drawn state at dropout 0.1 on each mesh of ``MESHES`` (``steps``), the
checkpoint round trip (``checkpoints``), and ``trainer fit`` and ``trainer
test`` of ``CLI_CONFIG`` with ``--trainer.mesh`` set to each mesh of
``MESHES`` (``cli``). Rank 0 writes what the test
compares under ``<dir>``, every rank its state's digest. It imports
neither JAX nor the JAX package.
"""

import contextlib
import io
import os
import sys

import torch
import torch.distributed as dist

torch.set_num_threads(1)

from torch.func import functional_call  # noqa: E402

from dmme_tpu_torch.data import CIFAR10  # noqa: E402
from dmme_tpu_torch.models import ddpm, iddpm  # noqa: E402
from dmme_tpu_torch.models.blocks import (Downsample, GNSiLU, GroupNorm, ResBlock,  # noqa: E402
                                          SelfAttention2d, Upsample, conv1x1, conv3x3,
                                          init_weights, shard_of_output)
from dmme_tpu_torch.parallel import (initialize, make_mesh, shard_batch,  # noqa: E402
                                     shard_state, shutdown)
from dmme_tpu_torch.parallel.mesh import gather_leaves, tensor_axes  # noqa: E402
from dmme_tpu_torch.parallel.spatial import SpatialGroup  # noqa: E402
from dmme_tpu_torch.parallel.tensor import TensorGroup  # noqa: E402
from dmme_tpu_torch.parallel.train_step import make_train_step  # noqa: E402
from dmme_tpu_torch.training import (CheckpointManager, LitDDPM, LitIDDPM,  # noqa: E402
                                     TrainState, fit)
from dmme_tpu_torch.training.checkpoint import FILE  # noqa: E402
from dmme_tpu_torch.trainer import main as cli  # noqa: E402

TINY = dict(pos_dim=4, emb_dim=8, num_groups=2, channels_per_depth=(4, 8, 8, 8), num_blocks=1)
#: {kind: (family, UNet keywords)}: the DDPM UNet on the plain GroupNorm; the
#: IDDPM UNet (FiLM, two heads, attention at two depths, six output
#: channels) on the fused GroupNorm's split entries, with remat
KINDS = {"ddpm": ("ddpm", dict(TINY)),
         "iddpm": ("iddpm", dict(TINY, num_heads=2, attention_depths=(2, 3), fused_norm=True,
                                 remat=True))}
TIMESTEPS = 20
#: the composed mesh of the layers and the parity step
COMPOSED = dict(tensor=2, spatial=2)
#: {name: min_weight_size} of the parity step: JAX's test value splits every
#: kernel of the TINY UNets; 512 leaves the input and output convs, the
#: conditions, the time embedding and some attention projections whole
PARITY_SIZES = {"all": 64, "some": 512}
#: {name: mesh axes} of the three-step fits: R = 1 and 2 batch ranks (on the
#: UNet the expert axis splits no leaf, so it is one more batch axis)
MESHES = {"tensor2_spatial2": dict(COMPOSED), "expert2_spatial2": dict(expert=2, spatial=2)}
MIN_WEIGHT_SIZE = 64
GLOBAL_BATCH = 8
STEPS = 3
DROPOUT = 0.1
CKPT = ("tensor2_spatial2", "ddpm")
#: {name: the --trainer.mesh flow value of each mesh of MESHES}
CLI_MESHES = {"tensor2_spatial2": "{data: -1, tensor: 2, spatial: 2}",
              "expert2_spatial2": "{data: -1, expert: 2, spatial: 2}"}
#: a small DDPM config for the command line (``root``: its default_root_dir):
#: the command line's mesh takes JAX's min_weight_size (2¹⁴), so the 64-wide
#: 3×3 kernels split and the 16-wide ones stay whole
CLI_CONFIG = """
seed_everything: 3
trainer:
  max_steps: 2
  log_every_n_steps: 1
  ckpt_every_n_steps: 2
  default_root_dir: {root}
model:
  class_path: dmme_tpu.training.LitDDPM
  init_args:
    timesteps: 10
    warmup: 1
    dtype: f32
    model:
      class_path: dmme_tpu.models.ddpm.UNet
      init_args: {{pos_dim: 4, emb_dim: 8, num_groups: 2, channels_per_depth: [16, 64, 64, 64],
                   num_blocks: 1, fused_norm: true}}
data:
  class_path: dmme_tpu.data.CIFAR10
  init_args: {{synthetic: true, synthetic_size: 16, batch_size: 8}}
"""
#: test batches of the command line's ``test``: the synthetic set's two
CLI_TEST_BATCHES = 2
#: the layers' whole input: (N, H, W, C)
LAYER_SHAPE = (2, 8, 6, 16)
LAYER_GROUPS = 4
EMB = 8


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


def _mask_generator():
    return torch.Generator().manual_seed(5)


def _shard(t, group):
    return t if group is None else group.shard(t)


def layer_cases():
    """{name: (module, extra inputs, call, min_weight_size)}: each layer drawn
    from a fixed seed (every bias and GroupNorm affine at random);
    ``call(module, x, extra, spatial, group)`` runs it on a rank's rows of
    its channel shard (``spatial`` and the ``TensorGroup`` ``group``) or
    whole (both None). The extra inputs are whole: the (N, C) pre-bias and
    FiLM rows, which a rank takes its channels of, and the ResBlocks' (N,
    emb) condition. ``min_weight_size``: the kernels the tensor axis
    splits (JAX's rule; a kernel under it runs whole on every rank)."""
    g = torch.Generator().manual_seed(21)
    n, _, _, c = LAYER_SHAPE

    def drawn(m):
        init_weights(m, g)
        with torch.no_grad():
            for k, v in m.named_parameters():
                if v.dim() == 1:
                    v.copy_(torch.randn(v.shape, generator=g) * 0.1 + k.endswith("weight"))
        return m

    def rows(shape):
        return torch.randn(shape, generator=g)

    def layer(m, x, e, s, t):
        """A conv of a ResBlock: its rows' channels gathered, its shard kept."""
        if t is None:
            return m(x) if s is None else m(x, s)
        return shard_of_output(m, t.gather(x), t, s)

    def down_up(m, x, e, s, t):
        return m(x) if s is None else m(x, spatial=s)

    def block(m, x, e, s, t):
        return m(x, e["emb"], True, _mask_generator(), spatial=s)

    split, whole = 64, 1 << 30
    return {
        "conv3x3": (drawn(conv3x3(c, 8)), {}, layer, split),
        "conv3x3_whole": (drawn(conv3x3(c, 8)), {}, layer, whole),
        "conv3x3_stride2": (drawn(conv3x3(c, 8, 2)), {}, layer, split),
        "conv1x1": (drawn(conv1x1(c, 8)), {}, layer, split),
        "group_norm": (drawn(GroupNorm(LAYER_GROUPS, c)), {},
                       lambda m, x, e, s, t: m(x, s), split),
        "gn_silu_pre_bias": (drawn(GNSiLU(LAYER_GROUPS, c)), {"pre_bias": rows((n, c))},
                             lambda m, x, e, s, t: m(x, pre_bias=_shard(e["pre_bias"], t),
                                                     spatial=s), split),
        "gn_silu_film": (drawn(GNSiLU(LAYER_GROUPS, c)),
                         {"scale": 0.1 * rows((n, c)), "shift": 0.1 * rows((n, c))},
                         lambda m, x, e, s, t: m(x, film_scale=_shard(e["scale"], t),
                                                 film_shift=_shard(e["shift"], t), spatial=s),
                         split),
        "attention_1head": (drawn(SelfAttention2d(c, LAYER_GROUPS, 1)), {},
                            lambda m, x, e, s, t: m(x, s), split),
        "attention_2heads": (drawn(SelfAttention2d(c, LAYER_GROUPS, 2)), {},
                             lambda m, x, e, s, t: m(x, s), split),
        # proj (256 elements) left whole, qkv_proj (768) split
        "attention_1head_proj_whole": (drawn(SelfAttention2d(c, LAYER_GROUPS, 1)), {},
                                       lambda m, x, e, s, t: m(x, s), 512),
        "attention_2heads_proj_whole": (drawn(SelfAttention2d(c, LAYER_GROUPS, 2)), {},
                                        lambda m, x, e, s, t: m(x, s), 512),
        "resblock_additive": (drawn(ResBlock(c, 8, EMB, num_groups=LAYER_GROUPS)),
                              {"emb": rows((n, EMB))}, block, split),
        "resblock_film": (drawn(ResBlock(c, 8, EMB, film=True, num_groups=LAYER_GROUPS,
                                         fused_norm=True)),
                          {"emb": rows((n, EMB))}, block, split),
        "resblock_remat": (drawn(ResBlock(c, 8, EMB, num_groups=LAYER_GROUPS, fused_norm=True,
                                          remat=True)),
                           {"emb": rows((n, EMB))}, block, split),
        # the residual conv (128 elements) and the condition (64) left whole
        "resblock_attention_some_whole": (drawn(ResBlock(c, 8, EMB, True, 2, True,
                                                         LAYER_GROUPS, remat=True)),
                                          {"emb": rows((n, EMB))}, block, 512),
        "downsample": (drawn(Downsample(c)), {}, down_up, split),
        "upsample": (drawn(Upsample(c)), {}, down_up, split),
    }


def layer_inputs():
    """The whole input and the output weights of each layer case: the loss
    is Σ out·r."""
    g = torch.Generator().manual_seed(22)
    x = torch.randn(LAYER_SHAPE, generator=g)
    n, h, w, c = LAYER_SHAPE
    r = {}
    for name in layer_cases():
        scale = {"conv3x3_stride2": 0.5, "downsample": 0.5, "upsample": 2}.get(name, 1)
        width = 8 if name.startswith(("conv", "resblock")) else c
        r[name] = torch.randn((n, int(h * scale), int(w * scale), width), generator=g)
    return x, r


def _gather(t, dim, group, size):
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def groups(mesh):
    """The mesh's (TensorGroup, SpatialGroup)."""
    return (TensorGroup(mesh.tensor_group, mesh.tensor, mesh.index("tensor")),
            SpatialGroup(mesh.spatial_group, mesh.spatial, mesh.index("spatial")))


def whole_of(t, mesh):
    """A rank's rows of its channel shard gathered whole: channels over the
    tensor group, then rows over the spatial group."""
    t = _gather(t, -1, mesh.tensor_group, mesh.tensor)
    return _gather(t, 1, mesh.spatial_group, mesh.spatial)


def layers(out, rank, world):
    """Each layer on the rank's rows of its channel shard, its split kernels
    bound as the rank's column shards: the output, the input's and every
    leaf's gradient of Σ out·r, gathered whole (activations and split
    leaves: the part the rank's rows give summed over the spatial group,
    then the shards gathered over the tensor group) or summed over the
    world (whole leaves and extras)."""
    got = {}
    x, r = layer_inputs()
    mesh = make_mesh(device="cpu", **COMPOSED)
    tgroup, where = groups(mesh)
    for name, (module, extra, call, size) in layer_cases().items():
        split = tensor_axes(dict(module.named_parameters()), mesh, size)
        for m in module.modules():
            m.tensor_group = tgroup
        params = {k: (v.chunk(mesh.tensor, split[k])[tgroup.index] if k in split else v)
                  .detach().requires_grad_(True) for k, v in module.named_parameters()}
        xr = tgroup.shard(where.rows(x)).detach().requires_grad_(True)
        extra = {k: v.detach().requires_grad_(True) for k, v in extra.items()}
        y = functional_call(_Call(module, call), {f"m.{k}": v for k, v in params.items()},
                            (xr, extra, where, tgroup))
        loss = (y * tgroup.shard(where.rows(r[name]))).sum()
        leaves = dict(params, **extra)
        grads = torch.autograd.grad(loss, [xr] + list(leaves.values()))
        summed = {}
        for k, v in zip(leaves, grads[1:]):
            v = v.clone()
            if k in split:
                dist.all_reduce(v, group=mesh.spatial_group)
                v = _gather(v, split[k], mesh.tensor_group, mesh.tensor)
            else:
                dist.all_reduce(v)
            summed[k] = v
        got[name] = {"y": whole_of(y.detach(), mesh), "dx": whole_of(grads[0], mesh),
                     "grads": summed, "split": sorted(split)}
    if rank == 0:
        torch.save(got, os.path.join(out, "layers.pt"))


class _Call(torch.nn.Module):
    """A layer case's ``call`` as a module, so ``functional_call`` binds the
    layer's parameters (a split kernel's column shard) around it."""

    def __init__(self, m, call):
        super().__init__()
        self.m, self.call = m, call

    def forward(self, x, extra, where, group):
        return self.call(self.m, x, extra, where, group)


class FirstGradients:
    """Keeps the reduced gradients of a run's first optimizer step, where
    ``TrainState.apply_gradients`` receives them, every shard gathered
    whole (fsdp, then tensor: a collective every rank reaches at the same
    step)."""

    def __init__(self):
        self.grads = None

    def __enter__(self):
        self.original = TrainState.apply_gradients

        def apply(state, grads, norm=None):
            if self.grads is None:
                whole = dict(grads)
                if state.mesh is not None:
                    whole.update(gather_leaves(state.mesh, whole, state.shard_axes))
                    whole.update(gather_leaves(state.mesh, whole, state.tensor_axes, "tensor"))
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


def parity(out, rank, world):
    """One step of each UNet at dropout 0 on the test's whole weights, (t, ε)
    injected through ``loss_given``, on the composed mesh at each
    ``PARITY_SIZES``: the step's loss, the first reduced gradient gathered
    whole, the leaves the tensor axis split and the state's digest."""
    given = torch.load(os.path.join(out, "parity_input.pt"), weights_only=False)
    got = {}
    for size_name, size in PARITY_SIZES.items():
        for kind in KINDS:
            g = given[kind]
            mesh = make_mesh(device="cpu", min_weight_size=size, **COMPOSED)
            h = lit(kind, dropout=0.0)
            state = h.init_state(0, device="cpu")
            state.params = {k: v.clone() for k, v in g["state"].items()}
            state.ema_params = {k: v.clone() for k, v in g["state"].items()}
            state = shard_state(state, mesh, model=h.model)
            x0, t, eps = (shard_batch(g[k], mesh) for k in ("x0", "t", "eps"))

            def loss_fn(params, generator, batch, h=h, t=t, eps=eps):
                return h.diffusion_model.loss_given(h.model_fn, params, batch, t, eps,
                                                    train=True, generator=generator)

            split = sorted(state.tensor_axes)
            with FirstGradients() as first:
                state, metrics = make_train_step(loss_fn, mesh=mesh)(state, x0, 0)
            digest, _ = _digest(state)
            got[f"{size_name}/{kind}"] = {"loss": float(metrics["loss"]), "grads": first.grads,
                                          "digest": digest, "split": split}
    torch.save(got, os.path.join(out, f"parity.{rank}.pt"))


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


def steps(out, rank, world):
    """Three steps of each UNet on each mesh: the logged losses and grad
    norms, the first step's reduced gradients, the gathered state and its
    digest, the leaves the tensor axis split."""
    for name, axes in MESHES.items():
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
                            "tensor_axes": dict(state.tensor_axes),
                            "expert_axes": dict(state.expert_axes), "params": whole.params,
                            "ema": whole.ema_params, "mu": whole.opt_state.mu,
                            "nu": whole.opt_state.nu},
                           os.path.join(out, f"steps_{name}_{kind}.pt"))


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
            if k in state.tensor_axes:
                want = want.chunk(mesh.tensor, state.tensor_axes[k])[mesh.index("tensor")]
            if not torch.equal(v, want):
                mismatched.append(f"{part}.{k}")
    torch.save({"mismatched": mismatched, "split": sorted(state.tensor_axes)},
               os.path.join(out, f"restored.{rank}.pt"))
    CheckpointManager(os.path.join(out, "plain_back"), mesh=mesh).save(state.step, state)


def cli_config(out, name, rank):
    """The path of ``CLI_CONFIG`` with its run under ``<out>/cli_<name>``,
    written by rank 0 (every rank waits for it)."""
    path = os.path.join(out, f"cli_{name}.yaml")
    if rank == 0:
        with open(path, "w") as f:
            f.write(CLI_CONFIG.format(root=os.path.join(out, f"cli_{name}")))
    dist.barrier()
    return path


def cli_runs(out, rank, world):
    """``trainer fit`` then ``trainer test`` of ``CLI_CONFIG`` on each mesh of
    ``CLI_MESHES``: what rank 0 printed of the test."""
    printed = {}
    for name, flow in CLI_MESHES.items():
        cfg = cli_config(out, name, rank)
        cli(["fit", "--config", cfg, "--trainer.mesh", flow], device="cpu")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli(["test", "--config", cfg, "--trainer.mesh", flow, "--trainer.limit_test_batches",
                 str(CLI_TEST_BATCHES)], device="cpu")
        printed[name] = buf.getvalue()
    torch.save(printed, os.path.join(out, f"cli.{rank}.pt"))


def main(argv) -> int:
    out, rank, world, port = argv[0], int(argv[1]), int(argv[2]), int(argv[3])
    initialize(f"localhost:{port}", world, rank, device="cpu")
    try:
        for scenario in (layers, parity, steps, checkpoints, cli_runs):
            scenario(out, rank, world)
            print(f"[spatial x tensor worker {rank}] {scenario.__name__} done", file=sys.stderr,
                  flush=True)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
