"""The ``tensor`` mesh axis of the port against the JAX package and against
one process.

Without processes: the split-or-whole decision and its axis for every
parameter of the TINY UNet and of the full-width UNet of
configs/ddpm/lsun_church.yaml, against JAX's ``fsdp_param_spec`` through
the layout permutation, on three meshes, and what a rank of the LSUN
config's ``{data: -1, tensor: 2}`` holds; the model families without a
tensor-parallel forward refused naming A.11. Then one group of four gloo
workers on the CPU (tests/torch_port_tensor_worker.py), spawned once for
the module with a deadline that kills it, runs on ``{data: -1, tensor: 2}``
and ``{fsdp: 2, tensor: 2}`` (JAX's ``min_weight_size=64``) the TINY DDPM
UNet (dropout 0.1), a TINY IDDPM UNet (FiLM, two heads, fused, remat) and
a class-conditional one: each rank's forward and injected loss, which
this process holds against JAX's single-device ``apply`` on the same
weights; on ``{data: -1, tensor: 2}`` the same for the denoisers of
``LitUpsampler``, ``LitLatentDDPM`` (the frozen codec outside the state)
and ``LitLatentFlow`` (a tiny DiT), laid out from their harnesses' states,
each rank on its batch slice; three steps, which this process holds against one process at
half the batch accumulating 2, every leaf's first gradient included; and
checkpoints between the mesh and no mesh, bit for bit.
"""

import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmme_tpu.diffusion import DDPM as JaxDDPM
from dmme_tpu.diffusion import IDDPM as JaxIDDPM
from dmme_tpu.diffusion import FlowMatching as JaxFlow
from dmme_tpu.models import as_model_fn as jax_model_fn
from dmme_tpu.models import ddpm as jax_ddpm
from dmme_tpu.models import dit as jax_dit
from dmme_tpu.models import iddpm as jax_iddpm
from dmme_tpu.models import vae as jax_vae
from dmme_tpu.parallel import fsdp_param_spec as jax_fsdp_param_spec
from dmme_tpu.parallel import make_mesh as jax_make_mesh
from dmme_tpu.training import LitUpsampler as JaxLitUpsampler
from dmme_tpu_torch.models import ddpm as t_ddpm
from dmme_tpu_torch.models.adm import EncoderUNet, UNetModel
from dmme_tpu_torch.models.vae import ConvVAE
from dmme_tpu_torch.parallel import mesh as tmesh
from dmme_tpu_torch.parallel import shard_state
from dmme_tpu_torch.parallel.distributed import free_port
from dmme_tpu_torch.training import CheckpointManager, fit
from dmme_tpu_torch.training.state import TrainState
from dmme_tpu_torch.utils.convert import from_flax
from tests import torch_port_tensor_worker as worker

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
#: seconds the worker group may take before it is killed
DEADLINE = 240
#: the UNet of configs/ddpm/lsun_church.yaml
LSUN = dict(dropout=0.0, channels_per_depth=(128, 128, 256, 256, 512, 512), attention_depths=(5,))
#: a rank's share of the LSUN UNet on {data: -1, tensor: 2}: 140 kernels split
LSUN_PARAMS, LSUN_HELD, LSUN_SPLIT = 97_689_219, 48_897_667, 140
SHAPE = (4, 32, 32, 3)
FORWARD_ATOL = 2e-5
LOSS_RTOL = 2e-4
GRAD_REL = 1e-5
STEP_REL = 1e-6


def _jax_model(kind):
    family, kw = worker.KINDS[kind]
    kw = {k: v for k, v in kw.items() if k not in ("fused_norm", "remat")}
    return (jax_iddpm if family == "iddpm" else jax_ddpm).UNet(**kw)


def _jax_leaves(model, shape, y=None):
    """[(port name, JAX path, JAX shape)] of a JAX UNet's parameters."""
    args = (jnp.zeros(shape), jnp.zeros((shape[0],), jnp.int32))
    kw = {} if y is None else {"y": jnp.zeros((shape[0],), jnp.int32)}
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args, **kw))
    rename = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
    out = []
    for kp, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [k.key for k in kp if k.key != "params"]
        keys[-1] = rename.get(keys[-1], keys[-1])
        out.append((".".join(keys), jax.tree_util.keystr(kp), tuple(leaf.shape)))
    return out


@pytest.fixture(scope="module")
def unets():
    """{name: (JAX leaves, the port's ``state_dict`` on the meta device)}."""
    out = {}
    for name, kw in (("tiny", worker.KINDS["class"][1]), ("lsun", LSUN)):
        kw = {k: v for k, v in kw.items() if k not in ("fused_norm", "remat")}
        with torch.device("meta"):
            port = dict(t_ddpm.UNet(**kw).state_dict())
        out[name] = (_jax_leaves(jax_ddpm.UNet(**kw), (2, 32, 32, 3), kw.get("num_classes")),
                     port)
    return out


@pytest.mark.parametrize("axes", [dict(tensor=2), dict(tensor=4), dict(fsdp=2, tensor=2)],
                         ids=["tensor2", "tensor4", "fsdp2_tensor2"])
@pytest.mark.parametrize("name,min_weight_size", [("tiny", 64), ("lsun", 2**14)])
def test_tensor_spec_matches_jax_for_every_unet_leaf(unets, name, min_weight_size, axes):
    """JAX's decision on every leaf (the output axis of each conv and Dense
    kernel and the features of the label table, where the axis divides
    them; fsdp on another axis) carried through the layout permutation."""
    leaves, port = unets[name]
    n = int(np.prod(list(axes.values())))
    jmesh = jax_make_mesh(jax.devices()[:n], **axes)
    assert {k for k, _, _ in leaves} == set(port)
    for k, path, jshape in leaves:
        want = jax_fsdp_param_spec(jshape, jmesh, min_weight_size, path=path)
        perm = tmesh.jax_axes(k, len(jshape))
        expected = [None] * len(jshape)
        for i, axis in enumerate(want):
            expected[perm[i]] = axis
        expected = tuple(expected) if any(expected) else ()
        got = tmesh.fsdp_param_spec(tuple(port[k].shape), jmesh, min_weight_size, path=k)
        assert got == expected, (k, want)
    split = tmesh.tensor_axes(port, jmesh, min_weight_size)
    assert split and all(port[k].dim() >= 2 for k in split)
    if name == "lsun" and axes == dict(tensor=2):
        held = sum(v.numel() // (2 if k in split else 1) for k, v in port.items())
        assert (sum(v.numel() for v in port.values()), held, len(split)) == (
            LSUN_PARAMS, LSUN_HELD, LSUN_SPLIT)
        assert all(v.numel() < 2**14 for k, v in port.items() if k not in split)


def _hand_mesh(**axes):
    """Rank 0 of a mesh of these axes without a process group: enough for
    the refusals, which come before any collective."""
    shape = tmesh.mesh_shape(int(np.prod(list(axes.values()))), **axes)
    return tmesh.Mesh(shape=shape, rank=0, device=torch.device("cpu"), backend="gloo")


@pytest.mark.parametrize("family", ["adm", "classifier", "codec", "none"])
def test_families_without_a_tensor_forward_raise_naming_a11(family):
    """shard_state refuses a tensor mesh for a model with no tensor-parallel
    forward (naming A.11), and without the model, before the state changes.
    The DiT has one (tests/test_torch_port_tensor_dit.py)."""
    build = {"adm": lambda: UNetModel(image_size=16, model_channels=32, channel_mult=(1, 2),
                                      num_res_blocks=1, attention_resolutions=(),
                                      num_head_channels=32),
             "classifier": lambda: EncoderUNet(image_size=16, model_channels=32,
                                               channel_mult=(1, 2), num_res_blocks=1,
                                               attention_resolutions=(), num_head_channels=32,
                                               num_classes=10),
             "codec": lambda: ConvVAE(latent_channels=4, base_channels=32,
                                      channel_multipliers=(1, 2), num_res_blocks=1),
             "none": lambda: None}
    model = build[family]()
    params = ({"w": torch.ones(64, 64)} if model is None
              else {k: v.detach().clone() for k, v in model.state_dict().items()})
    state = TrainState(step=0, params=dict(params), ema_params=dict(params), opt_state=None,
                       tx=None)
    mesh = _hand_mesh(tensor=2)
    if model is None:
        with pytest.raises(ValueError, match="pass the model"):
            shard_state(state, mesh, min_weight_size=64)
    else:
        with pytest.raises(NotImplementedError, match=r"tensor=2.*ROADMAP A\.11"):
            shard_state(state, mesh, model=model, min_weight_size=64)
    assert state.mesh is None and all(state.params[k] is v for k, v in params.items())


def test_a_tensor_mesh_that_splits_no_unet_leaf_is_refused():
    model = t_ddpm.UNet(**worker.TINY)
    with pytest.raises(ValueError, match="splits no leaf"):
        model.place_tensor(object(), {})


# ------------------------------------------------------------- the group


def _forward_inputs():
    """{kind: JAX's module, its numpy params (every bias and GroupNorm scale
    redrawn), the inputs, the injected (t, ε) and the labels}."""
    r = np.random.default_rng(3)
    out = {}
    for kind in worker.KINDS:
        model = _jax_model(kind)
        y = (np.arange(SHAPE[0]) % worker.CLASSES).astype(np.int32) if kind == "class" else None
        kw = {} if y is None else {"y": jnp.asarray(y)}
        params = jax.jit(lambda k: model.init(k, jnp.zeros(SHAPE), jnp.zeros((SHAPE[0],),
                                                                             jnp.int32), **kw))(
            jax.random.PRNGKey(0))

        def fill(path, leaf):
            name = path[-1].key
            if name == "bias":
                return (0.1 * r.standard_normal(leaf.shape)).astype(np.float32)
            if name == "scale":
                return (1.0 + 0.1 * r.standard_normal(leaf.shape)).astype(np.float32)
            return np.asarray(leaf)

        params = jax.tree_util.tree_map_with_path(fill, params)
        out[kind] = dict(model=model, params=params, y=y,
                         x=r.standard_normal(SHAPE).astype(np.float32),
                         x0=np.clip(r.standard_normal(SHAPE), -1, 1).astype(np.float32),
                         eps=r.standard_normal(SHAPE).astype(np.float32),
                         # from 2: the IDDPM's t = 1 NLL is ill-conditioned in f32 at
                         # random weights (one process is 1e-3 from JAX there; JAX's own
                         # parity test leaves it out too)
                         t=r.integers(2, worker.TIMESTEPS, SHAPE[0]).astype(np.int32))
    return out


#: the harness cases' global batch of images (16 px: 8×8 latents at the codec's factor 2)
HARNESS_SHAPE = (4, 16, 16, 3)


def _random_params(shapes, r):
    """Kernels of variance 1/fan_in, GroupNorm scales 1 + 0.1·N(0, 1), every
    other leaf 0.1·N(0, 1) (the DiT's zero-initialised layers drawn too)."""

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


def _harness_inputs():
    """{harness: its JAX denoiser, params, the denoiser's global input
    ``x_in`` at ``t``, the images ``x``, the injected draws (a, b) of its
    ``loss_given`` and the latent ones' codec and posterior noise}."""
    r = np.random.default_rng(7)
    jvae = jax_vae.ConvVAE(**worker.CODEC)
    vparams = _random_params(jax.eval_shape(jvae.init, jax.random.PRNGKey(0),
                                            jnp.zeros((1, 8, 8, 3)), jax.random.PRNGKey(1)), r)
    n = HARNESS_SHAPE[0]
    x = np.clip(r.standard_normal(HARNESS_SHAPE), -1, 1).astype(np.float32)
    out = {}
    for name, kw in worker.HARNESS_MODELS.items():
        model = (jax_dit.DiT if name == "latent_flow_dit" else jax_ddpm.UNet)(**kw)
        hw = HARNESS_SHAPE[1] // (1 if name == "upsampler" else 2)
        in_shape = (n, hw, hw, kw["in_channels"])
        params = _random_params(jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                               jnp.zeros(in_shape), jnp.zeros((n,), jnp.int32)),
                                r)
        d = dict(model=model, params=params, x=x,
                 x_in=r.standard_normal(in_shape).astype(np.float32),
                 t=r.integers(2, worker.TIMESTEPS, n).astype(np.int32))
        target = HARNESS_SHAPE if name == "upsampler" else in_shape  # x₀'s shape
        d["b"] = r.standard_normal(target).astype(np.float32)
        d["a"] = (r.uniform(0.05, 0.95, n).astype(np.float32) if name == "latent_flow_dit"
                  else r.integers(2, worker.TIMESTEPS, n).astype(np.int32))
        if name != "upsampler":
            d.update(noise=r.standard_normal(in_shape).astype(np.float32), codec=vparams,
                     vae=jvae)
        out[name] = d
    return out


def _jax_harness(name, d):
    """[(JAX's denoiser output, its injected loss)] of harness ``name`` on
    each batch rank's slice of its inputs ``d``: the upsampler conditioned
    on its pooled-and-resized images, the latent ones on the codec's latents."""
    algo = JaxFlow.create() if name == "latent_flow_dit" else JaxDDPM.create(worker.TIMESTEPS)

    @jax.jit
    def run(params, codec, x, x_in, t, a, b, noise):
        if name == "upsampler":
            jlit = JaxLitUpsampler(factor=worker.UPSAMPLE, model=d["model"],
                                   timesteps=worker.TIMESTEPS)
            x0 = x
            model_fn = jlit.bound_model_fn(jax.image.resize(jlit.downsample(x), x.shape,
                                                            "linear"))
        else:
            mean, logvar = d["vae"].apply(codec, x, method=jax_vae.ConvVAE.encode)
            x0 = (mean + jnp.exp(0.5 * logvar) * noise) * worker.LATENT_SCALE
            model_fn = jax_model_fn(d["model"])
        return d["model"].apply(params, x_in, t), algo.loss_given(model_fn, params, x0, a, b)

    out = []
    for s in range(2):
        part = slice(2 * s, 2 * s + 2)
        y, loss = run(d["params"], d.get("codec"), *(
            jnp.asarray(d[k][part]) if k in d else None
            for k in ("x", "x_in", "t", "a", "b", "noise")))
        out.append((np.asarray(y), float(loss)))
    return out


def _plain_checkpoint(directory):
    """A mesh-less run's checkpoint at step 3 of the checkpoint UNet, every
    tensor drawn (the moments too)."""
    state = worker.lit(worker.CKPT[1]).init_state(0, device="cpu")
    g = torch.Generator().manual_seed(5)
    for part in (state.params, state.ema_params, state.opt_state.mu, state.opt_state.nu):
        for k in part:
            part[k] = torch.randn(part[k].shape, generator=g)
    state.step = state.opt_state.count = 3
    CheckpointManager(directory).save(3, state)


class _Group:
    """The spawned workers (``script``): their pipes drained by threads while
    they run, killed at the deadline (as ``parallel.mp_check.spawn``)."""

    script = worker.__file__

    def __init__(self, out):
        self.out, self.deadline = out, time.monotonic() + DEADLINE
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                    "MASTER_PORT"):
            env.pop(key, None)
        port = free_port()
        self.procs = [subprocess.Popen(
            [sys.executable, self.script, out, str(rank), str(WORLD), str(port)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(WORLD)]
        self.logs = [[] for _ in self.procs]
        self.threads = [threading.Thread(target=lambda p=p, lines=lines: lines.extend(p.stdout),
                                         daemon=True) for p, lines in zip(self.procs, self.logs)]
        for t in self.threads:
            t.start()
        self.rcs = None

    def wait(self):
        """The workers' directory once every worker ended with 0; fails otherwise."""
        if self.rcs is None:
            rcs = []
            for p in self.procs:
                try:
                    rcs.append(p.wait(timeout=max(0.1, self.deadline - time.monotonic())))
                except subprocess.TimeoutExpired:
                    rcs.append(None)
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for t in self.threads:
                t.join(30)
            self.rcs = rcs
        assert self.rcs == [0] * WORLD, "\n".join(
            f"rank {r} ended with {rc}:\n" + "".join(lines[-40:])[-3000:]
            for r, (rc, lines) in enumerate(zip(self.rcs, self.logs)) if rc != 0)
        return self.out


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tensor"))
    inputs = _forward_inputs()
    torch.save({kind: {"state": from_flax(d["params"]), "x": torch.tensor(d["x"]),
                       "t": torch.tensor(d["t"], dtype=torch.int64),
                       "x0": torch.tensor(d["x0"]), "eps": torch.tensor(d["eps"]),
                       "y": None if d["y"] is None else torch.tensor(d["y"], dtype=torch.int64)}
                for kind, d in inputs.items()}, os.path.join(out, "forward_input.pt"))
    harnesses = _harness_inputs()
    torch.save({name: {"state": from_flax(d["params"]),
                       "codec": from_flax(d["codec"]) if "codec" in d else None,
                       **{k: torch.tensor(d[k]) for k in ("x", "x_in", "a", "b", "noise", "t")
                          if k in d}}
                for name, d in harnesses.items()}, os.path.join(out, "harness_input.pt"))
    _plain_checkpoint(os.path.join(out, "plain"))
    g = _Group(out)
    try:
        # JAX's harness results while the workers run: each batch rank's slice
        wants = {name: _jax_harness(name, d) for name, d in harnesses.items()}
        yield dict(group=g, inputs=inputs, harnesses=harnesses, harness_wants=wants)
    finally:
        for p in g.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def one_process():
    """Each UNet's three steps in this process at half the global batch,
    accumulating 2: the logged metrics, the first step's gradients, the state."""
    out = {}
    for kind in worker.KINDS:
        rec = worker.Recorder()
        h = worker.lit(kind)
        with worker.FirstGradients() as first:
            state = fit(h, worker.data(kind, worker.GLOBAL_BATCH // 2), worker.STEPS, seed=0,
                        log_every=1, loggers=[rec], accumulate_grad_batches=2,
                        state=worker.init_state(h), device="cpu")
        out[kind] = dict(rows=rec.rows, grads=first.grads, state=state)
    return out


@pytest.mark.parametrize("kind", list(worker.KINDS))
@pytest.mark.parametrize("name", list(worker.MESHES))
def test_tensor_parallel_forward_and_loss_match_jax(group, name, kind):
    """Every rank's whole output within 2e-5 of JAX's single-device
    ``apply`` on the same weights, and its loss with (t, ε) injected within
    rtol 2e-4 of JAX's ``loss_given``."""
    d = group["inputs"][kind]
    kw = {} if d["y"] is None else {"y": jnp.asarray(d["y"])}
    want = np.asarray(d["model"].apply(d["params"], jnp.asarray(d["x"]),
                                       jnp.asarray(d["t"]), train=False, **kw))
    family = worker.KINDS[kind][0]
    algo = (JaxIDDPM if family == "iddpm" else JaxDDPM).create(worker.TIMESTEPS)
    base = jax_model_fn(d["model"])
    loss = float(algo.loss_given(lambda p, x, t, **k: base(p, x, t, **kw, **k), d["params"],
                                 jnp.asarray(d["x0"]), jnp.asarray(d["t"]),
                                 jnp.asarray(d["eps"])))
    out = group["group"].wait()
    for r in range(WORLD):
        got = torch.load(os.path.join(out, f"forward.{r}.pt"))[f"{name}/{kind}"]
        assert got["split"], "the tensor axis split nothing"
        np.testing.assert_allclose(got["y"].numpy(), want, rtol=0, atol=FORWARD_ATOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(float(got["loss"]), loss, rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", list(worker.HARNESS_MODELS))
def test_tensor_parallel_harness_denoisers_match_jax(group, name):
    """Each harness's state laid out on {data: -1, tensor: 2} holds the
    denoiser's leaves only (the latent codec stays outside it) and splits
    some; every rank's denoiser output on its batch slice within 2e-5 of
    JAX's single-device ``apply``, and its loss with injected draws (the
    upsampler's cond and the codec's latents made by the harness) within
    rtol 2e-4 of JAX's ``loss_given`` on the slice."""
    d, want = group["harnesses"][name], group["harness_wants"][name]
    out = group["group"].wait()
    for r in range(WORLD):
        got = torch.load(os.path.join(out, f"harness.{r}.pt"))[name]
        assert got["keys"] == sorted(from_flax(d["params"])) and got["split"]
        y, loss = want[got["slice"]]
        np.testing.assert_allclose(got["y"].numpy(), y, rtol=0, atol=FORWARD_ATOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(float(got["loss"]), loss, rtol=LOSS_RTOL)


def _flat(tensors, keys):
    """The tensors of ``keys`` flattened in f64, less the key third of each
    ``qkv_proj.bias``: softmax is invariant to it, so its gradient is
    rounding noise that Adam scales to a step of ±lr whatever its size
    (tests/test_torch_port_distributed.py leaves it out the same way)."""
    parts = []
    for k in keys:
        v = tensors[k].reshape(-1).double()
        if k.endswith("qkv_proj.bias"):
            c = v.shape[0] // 3
            v = torch.cat([v[:c], v[2 * c:]])
        parts.append(v)
    return torch.cat(parts)


def _rel_l2(a, b, keys=None):
    keys = sorted(a) if keys is None else keys
    x, y = _flat(a, keys), _flat(b, keys)
    return float((x - y).norm() / x.norm())


@pytest.mark.parametrize("kind", list(worker.KINDS))
@pytest.mark.parametrize("name", list(worker.MESHES))
def test_tensor_mesh_steps_match_one_accumulating_process(group, one_process, name, kind):
    """Three steps on the mesh: each step's loss and grad norm within 1e-6
    relative of one process at half the batch accumulating 2, every leaf's
    first reduced gradient within 1e-5 (relative L2; the whole biases,
    GroupNorm affines, ``output_conv`` and ``class_embed`` among them), the
    gathered parameters, EMA and moments within 1e-6; each rank holds its
    share of the split leaves only, and no all-gather over the tensor group
    sent a split kernel's shard."""
    out = group["group"].wait()
    got = torch.load(os.path.join(out, f"steps_{name}_{kind}.pt"))
    ref = one_process[kind]
    assert [r["step"] for r in got["rows"]] == [1, 2, 3]
    for row, want in zip(got["rows"], ref["rows"]):
        for k in ("loss", "grad_norm"):
            assert abs(row[k] - want[k]) <= STEP_REL * abs(want[k]), (k, row, want)
    assert set(got["grads"]) == set(ref["grads"])
    for k in ref["grads"]:
        assert float(ref["grads"][k].norm()) > 0, k
        assert _rel_l2(ref["grads"], got["grads"], [k]) <= GRAD_REL, k
    state = ref["state"]
    for part, mine in (("params", state.params), ("ema", state.ema_params),
                       ("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
        assert _rel_l2(mine, got[part]) <= STEP_REL, part
    axes = {"fsdp": 1, **worker.MESHES[name]}
    assert got["tensor_axes"] and bool(got["shard_axes"]) == (axes["fsdp"] > 1)
    assert "output_conv.weight" in got["tensor_axes"] or kind != "iddpm"
    held = sum(v.numel() / (2 if k in got["tensor_axes"] else 1)
               / (axes["fsdp"] if k in got["shard_axes"] else 1) for k, v in state.params.items())
    assert got["held"] == 4 * held
    assert got["gathers"] > 0 and got["weights_sent"] == 0


def _equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b) if torch.is_tensor(a) else a == b


def test_checkpoints_move_between_tensor_mesh_and_no_mesh_bitwise(group):
    """A mesh-less checkpoint restored on {fsdp: 2, tensor: 2}: every rank
    holds exactly its shards of it, and saving it from the mesh writes the
    same file; the mesh fit's own checkpoint is its ranks' gathered state
    and restores without a mesh bit for bit."""
    out = group["group"].wait()
    for r in range(WORLD):
        note = torch.load(os.path.join(out, f"restored.{r}.pt"))
        assert note["mismatched"] == [] and note["split"]
    assert _equal(CheckpointManager(os.path.join(out, "plain")).load(3),
                  CheckpointManager(os.path.join(out, "plain_back")).load(3))
    name, kind = worker.CKPT
    fitted = torch.load(os.path.join(out, f"steps_{name}_{kind}.pt"))
    state = CheckpointManager(os.path.join(out, "ckpt_mesh")).restore(
        worker.lit(kind).init_state(0, device="cpu"))
    assert state.step == worker.STEPS and not state.sharded
    for part, mine in (("params", state.params), ("ema", state.ema_params),
                       ("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
        assert _equal(mine, fitted[part]), part
