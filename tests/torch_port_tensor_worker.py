"""One rank of tests/test_torch_port_tensor.py: a gloo process on the CPU.

    python tests/torch_port_tensor_worker.py <dir> <rank> <world> <port>

The process joins a group of ``world`` ranks once and runs, in order, on
each tensor mesh of ``MESHES``: the tensor-parallel forward and injected
loss of each TINY UNet of ``KINDS`` on the test's weights and inputs
(``forward``); on ``{data: -1, tensor: 2}`` those of the denoisers of
``LitUpsampler``, ``LitLatentDDPM`` and ``LitLatentFlow`` laid out by
``shard_state`` from their harnesses' states, on the rank's batch slice
(``harnesses``); three-step fits of each UNet of ``KINDS`` from one drawn
state (``steps``), and the checkpoint round trip (``checkpoints``). Rank 0
writes what the test compares under ``<dir>``, every rank its notes. It
imports neither JAX nor the JAX package.
"""

import os
import sys

import torch
import torch.distributed as dist

torch.set_num_threads(1)

from torch.func import functional_call  # noqa: E402

from dmme_tpu_torch.data import CIFAR10  # noqa: E402
from dmme_tpu_torch.models import ddpm, iddpm  # noqa: E402
from dmme_tpu_torch.models.dit import DiT  # noqa: E402
from dmme_tpu_torch.models.vae import ConvVAE  # noqa: E402
from dmme_tpu_torch.parallel import initialize, make_mesh, shard_state, shutdown  # noqa: E402
from dmme_tpu_torch.parallel.mesh import gather_leaves, shard_of, tensor_axes  # noqa: E402
from dmme_tpu_torch.parallel.tensor import TensorGroup  # noqa: E402
from dmme_tpu_torch.training import (CheckpointManager, LitDDPM, LitIDDPM,  # noqa: E402
                                     LitLatentDDPM, LitLatentFlow, LitUpsampler, TrainState, fit)
from dmme_tpu_torch.training.checkpoint import FILE  # noqa: E402
from dmme_tpu_torch.training.lit import resize_bilinear  # noqa: E402

TINY = dict(pos_dim=4, emb_dim=8, num_groups=2, channels_per_depth=(4, 8, 8, 8), num_blocks=1)
#: {kind: (harness, UNet keywords)}: the DDPM UNet with dropout 0.1; the
#: IDDPM UNet (FiLM, two heads, six output channels) fused and with remat;
#: a class-conditional DDPM UNet on the fused GroupNorm with its pre-bias
KINDS = {"ddpm": ("ddpm", dict(TINY, dropout=0.1)),
         "iddpm": ("iddpm", dict(TINY, num_heads=2, attention_depths=(2, 3), dropout=0.1,
                                 fused_norm=True, remat=True)),
         "class": ("ddpm", dict(TINY, num_classes=10, fused_norm=True))}
CLASSES = KINDS["class"][1]["num_classes"]
TIMESTEPS = 20
#: {name: mesh axes}: on four ranks, two tensor groups of two as data
#: replicas ({data: -1, tensor: 2}) or as the fsdp shards of one batch slice
MESHES = {"data2_tensor2": dict(tensor=2), "fsdp2_tensor2": dict(data=1, fsdp=2, tensor=2)}
#: JAX's test_tp_train_step_matches_single: small kernels split too
MIN_WEIGHT_SIZE = 64
GLOBAL_BATCH = 8
STEPS = 3
CKPT = ("fsdp2_tensor2", "ddpm")
#: the denoisers of the harnesses that run a UNet or a DiT through
#: ``place_tensor``: the upsampler's (input x_t ‖ cond, 2·C channels), the
#: latent DDPM's over the frozen codec (which stays outside the state and
#: runs whole on every rank), and the latent flow DiT of
#: configs/latent/shapes_latent_flow_dit_demo.yaml at a tiny width
HARNESS_MODELS = {
    "upsampler": dict(in_channels=6, out_channels=3, pos_dim=4, emb_dim=8, num_groups=2,
                      channels_per_depth=(4, 8, 16), num_blocks=1, dropout=0.0,
                      attention_depths=(3,)),
    "latent_ddpm": dict(in_channels=4, pos_dim=4, emb_dim=8, num_groups=2,
                        channels_per_depth=(4, 8, 16, 16), num_blocks=1, dropout=0.0),
    "latent_flow_dit": dict(in_channels=4, patch_size=2, hidden=32, depth=2, num_heads=2,
                            pos_dim=16)}
CODEC = dict(latent_channels=4, base_channels=16, channel_multipliers=(1, 2), num_res_blocks=1)
LATENT_SCALE = 0.75
UPSAMPLE = 2


def model(kind):
    family, kw = KINDS[kind]
    return (iddpm if family == "iddpm" else ddpm).UNet(**kw)


def lit(kind):
    family, _ = KINDS[kind]
    cls = LitIDDPM if family == "iddpm" else LitDDPM
    extra = {"num_classes": CLASSES} if kind == "class" else {}
    return cls(model=model(kind), timesteps=TIMESTEPS, lr=1e-3, warmup=1, **extra)


def init_state(h):
    """``h``'s state at step 0 with every parameter drawn from one seed:
    each bias and GroupNorm affine at random, so a slice taken wrong shows."""
    state = h.init_state(0, device="cpu")
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for k, v in state.params.items():
            scale = v[0].numel() ** -0.5 if v.dim() > 1 else 0.1
            offset = 1.0 if k.endswith("norm1.weight") or k.endswith("norm2.weight") else 0.0
            v.copy_(torch.randn(v.shape, generator=g) * scale + offset)
            state.ema_params[k].copy_(v)
    return state


def data(kind, batch=GLOBAL_BATCH):
    return CIFAR10(synthetic=True, synthetic_size=32, batch_size=batch,
                   with_labels=kind == "class")


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
    """Keeps the reduced gradients of a run's first optimizer step, where
    ``TrainState.apply_gradients`` receives them, every shard gathered
    whole (fsdp, then expert, then tensor: a collective every rank reaches
    at the same step), and ends ``spy`` there."""

    def __init__(self, spy=None):
        self.grads, self.spy = None, spy

    def __enter__(self):
        self.original = TrainState.apply_gradients

        def apply(state, grads, norm=None):
            if self.grads is None:
                if self.spy is not None:
                    self.spy.on = False
                whole = dict(grads)
                if state.mesh is not None:
                    whole.update(gather_leaves(state.mesh, whole, state.shard_axes))
                    whole.update(gather_leaves(state.mesh, whole, state.expert_axes, "expert"))
                    whole.update(gather_leaves(state.mesh, whole, state.tensor_axes, "tensor"))
                self.grads = {k: v.detach().clone() for k, v in whole.items()}
            return self.original(state, grads, norm)

        TrainState.apply_gradients = apply
        return self

    def __exit__(self, *exc):
        TrainState.apply_gradients = self.original


class GatherSpy:
    """Keeps a flat copy of what each all-gather over ``group`` sends while ``on``."""

    def __init__(self, group):
        self.group, self.on, self.sent = group, True, []

    def __enter__(self):
        self.original = dist.all_gather

        def all_gather(tensor_list, tensor, group=None, async_op=False):
            if self.on and group is self.group:
                self.sent.append(tensor.detach().reshape(-1).clone())
            return self.original(tensor_list, tensor, group=group, async_op=async_op)

        dist.all_gather = all_gather
        return self

    def __exit__(self, *exc):
        dist.all_gather = self.original


def forward(out, rank, world):
    """Each UNet's eval forward and injected loss on the rank's tensor
    shards of the test's whole weights: the whole output on every rank."""
    given = torch.load(os.path.join(out, "forward_input.pt"), weights_only=False)
    got = {}
    for name, axes in MESHES.items():
        mesh = make_mesh(device="cpu", min_weight_size=MIN_WEIGHT_SIZE, **axes)
        for kind in KINDS:
            g = given[kind]
            h = lit(kind)
            split = tensor_axes(g["state"], mesh, MIN_WEIGHT_SIZE)
            h.model.place_tensor(TensorGroup(mesh.tensor_group, mesh.tensor,
                                             mesh.index("tensor")), split)
            params = {k: shard_of(mesh, v, split[k], "tensor") if k in split else v
                      for k, v in g["state"].items()}
            kw = {} if g["y"] is None else {"y": g["y"]}
            with torch.no_grad():
                y = functional_call(h.model, params, (g["x"], g["t"]), kw)
                loss = h.diffusion_model.loss_given(
                    lambda p, x, t, **k: functional_call(h.model, p, (x, t), {**k, **kw}),
                    params, g["x0"], g["t"], g["eps"])
            got[f"{name}/{kind}"] = {"y": y, "loss": loss, "split": sorted(split)}
    torch.save(got, os.path.join(out, f"forward.{rank}.pt"))


def harness(name, codec=None):
    """The harness of ``HARNESS_MODELS[name]``; ``codec``: the latent ones' state dict."""
    kw = HARNESS_MODELS[name]
    if name == "upsampler":
        return LitUpsampler(factor=UPSAMPLE, model=ddpm.UNet(**kw), timesteps=TIMESTEPS)
    latent = dict(vae=ConvVAE(**CODEC), vae_params=codec, latent_scale=LATENT_SCALE)
    if name == "latent_ddpm":
        return LitLatentDDPM(model=ddpm.UNet(**kw), timesteps=TIMESTEPS, **latent)
    return LitLatentFlow(model=DiT(**kw), **latent)


def harnesses(out, rank, world):
    """Each harness's state (the test's weights) laid out on ``{data: -1,
    tensor: 2}`` by ``shard_state``; the denoiser's forward and its loss
    with injected draws on the rank's batch slice: the upsampler's on the
    x_t ‖ cond of the slice, the latent ones' on the codec's latents of the
    slice under the given posterior noise."""
    given = torch.load(os.path.join(out, "harness_input.pt"), weights_only=False)
    mesh = make_mesh(device="cpu", min_weight_size=MIN_WEIGHT_SIZE, **MESHES["data2_tensor2"])
    got = {}
    for name in HARNESS_MODELS:
        g = {k: v.chunk(mesh.batch_ranks)[mesh.batch_index] if torch.is_tensor(v) else v
             for k, v in given[name].items()}
        h = harness(name, g.get("codec"))
        state = h.init_state(0, device="cpu")
        keys = sorted(state.params)
        state.params, state.ema_params = dict(g["state"]), dict(g["state"])
        state = shard_state(state, mesh, model=h.model)
        with torch.no_grad():
            y = functional_call(h.model, state.params, (g["x_in"], g["t"]))
            if name == "upsampler":
                cond = resize_bilinear(h.downsample(g["x"]), g["x"].shape[1:3])
                x0, model_fn = g["x"], h.bound_model_fn(cond)
            else:
                x0, model_fn = h.encode_target(None, g["x"], noise=g["noise"]), h.model_fn
            loss = h.diffusion_model.loss_given(model_fn, state.params, x0, g["a"], g["b"])
        got[name] = {"y": y, "loss": loss, "keys": keys, "split": sorted(state.tensor_axes),
                     "slice": mesh.batch_index}
    torch.save(got, os.path.join(out, f"harness.{rank}.pt"))


def steps(out, rank, world):
    """Three steps of each UNet on each mesh: the logged losses and grad
    norms, the first step's reduced gradients, what the step's all-gathers
    over the tensor group sent against the split kernels' shards, the
    gathered state, and the elements a rank holds."""
    for name, axes in MESHES.items():
        for kind in KINDS:
            mesh = make_mesh(device="cpu", min_weight_size=MIN_WEIGHT_SIZE, **axes)
            h = lit(kind)
            state = init_state(h)
            split = tensor_axes(state.params, mesh, MIN_WEIGHT_SIZE)
            shards = [shard_of(mesh, state.params[k], a, "tensor").reshape(-1)
                      for k, a in split.items()]
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
                            "shard_axes": dict(state.shard_axes),
                            "params": whole.params, "ema": whole.ema_params,
                            "mu": whole.opt_state.mu, "nu": whole.opt_state.nu},
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
            if k in state.shard_axes:
                want = want.chunk(mesh.fsdp, state.shard_axes[k])[mesh.fsdp_index]
            if not torch.equal(v, want):
                mismatched.append(f"{part}.{k}")
    torch.save({"mismatched": mismatched, "split": sorted(state.tensor_axes)},
               os.path.join(out, f"restored.{rank}.pt"))
    CheckpointManager(os.path.join(out, "plain_back"), mesh=mesh).save(state.step, state)


def main(argv) -> int:
    out, rank, world, port = argv[0], int(argv[1]), int(argv[2]), int(argv[3])
    initialize(f"localhost:{port}", world, rank, device="cpu")
    try:
        for scenario in (forward, harnesses, steps, checkpoints):
            scenario(out, rank, world)
            print(f"[tensor worker {rank}] {scenario.__name__} done", file=sys.stderr, flush=True)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
