"""The ``spatial`` mesh axis of the port against the JAX package and against
one process.

Without processes: ``batch_sharding`` against JAX's for every case of
tests/test_training.py::TestSpatialParallel (the shape gate included), and
``fsdp_param_spec`` against JAX's for every leaf of the TINY and the LSUN
UNet on ``{data: 2, fsdp: 2, spatial: 2}`` (never ``spatial``); the
refusals of ROADMAP A.11 (``spatial`` with ``tensor`` or ``expert``, the
families without an H-split forward, rows that do not split, the
feature-capture arguments, a K1/K2 width outside ``group_norm.cu``'s
domain). Then one group of four gloo workers on the CPU
(tests/torch_port_spatial_worker.py, the first two of which go on as a
group of two), spawned once for the module with a deadline that kills it,
runs: each layer on H-shards over 2 and 4 ranks against the whole layer;
one step of the TINY DDPM UNet (plain GroupNorm) and of a TINY IDDPM UNet
(FiLM, two heads, the fused GroupNorm's split entries, remat) with (t, ε)
injected, on ``{spatial: 2}``, ``{data: 2, spatial: 2}`` and ``{fsdp: 2,
spatial: 2}``, whose loss and gradient this process holds against JAX's
single-device ``loss_given``; three steps at dropout 0.1 on each mesh held
against one process accumulating R, every rank's state bitwise equal; and
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
from dmme_tpu.models import as_model_fn as jax_model_fn
from dmme_tpu.models import ddpm as jax_ddpm
from dmme_tpu.models import iddpm as jax_iddpm
from dmme_tpu.parallel import fsdp_param_spec as jax_fsdp_param_spec
from dmme_tpu.parallel import make_mesh as jax_make_mesh
from dmme_tpu.parallel.mesh import batch_sharding as jax_batch_sharding
from dmme_tpu_torch.models import ddpm as t_ddpm
from dmme_tpu_torch.models.adm import EncoderUNet, UNetModel
from dmme_tpu_torch.models.dit import DiT
from dmme_tpu_torch.models.vae import ConvVAE
from dmme_tpu_torch.ops import group_norm as k_gn
from dmme_tpu_torch.parallel import mesh as tmesh
from dmme_tpu_torch.parallel import shard_state
from dmme_tpu_torch.parallel.distributed import free_port
from dmme_tpu_torch.parallel.spatial import SpatialGroup
from dmme_tpu_torch.training import CheckpointManager, fit
from dmme_tpu_torch.training.state import TrainState
from dmme_tpu_torch.utils.convert import from_flax
from tests import torch_port_spatial_worker as worker

torch.set_num_threads(1)

WORLD = 4
#: seconds the worker group may take before it is killed
DEADLINE = 240
#: the UNet of configs/ddpm/lsun_church.yaml
LSUN = dict(dropout=0.0, channels_per_depth=(128, 128, 256, 256, 512, 512), attention_depths=(5,))
SHAPE = (worker.GLOBAL_BATCH, 32, 32, 3)
#: the layers against their whole counterparts, in f32
LAYER_TOL = dict(rtol=1e-5, atol=1e-6)
#: JAX's own bound for this step (test_spatial_train_step_matches_single)
LOSS_RTOL = 2e-4
#: the gradients against JAX's, as tests/test_torch_port_training.py holds them
GRAD_TOL = dict(rtol=2e-3, atol=1e-5)
#: the first gradient against one process, as tests/test_torch_port_tensor.py holds it
GRAD_REL = 1e-5
#: the steps' metrics and states against one process: every sum over H (the
#: GroupNorm statistics, each kernel's gradient) adds the row shards' partial
#: sums, so the three steps differ from one process by f32 reassociation, up
#: to ≈ 1.5e-6 in the second moments on this run
STEP_REL = 1e-5
ALL_MESHES = {**worker.MESHES, **worker.PAIR}


def _jax_model(kind):
    family, kw = worker.KINDS[kind]
    kw = {k: v for k, v in kw.items() if k not in ("fused_norm", "remat")}
    return (jax_iddpm if family == "iddpm" else jax_ddpm).UNet(**kw, dropout=0.0)


# ------------------------------------------------------------ no processes


def test_batch_sharding_matches_jax_for_every_spatial_case(devices):
    """JAX's specs of TestSpatialParallel's cases on (data=2, spatial=4), the
    shape gate's refusals included, and one mesh without the axis."""
    jmesh = jax_make_mesh(devices, data=2, spatial=4)
    cases = [dict(ndim=4), dict(ndim=1), dict(chunked=True, ndim=5),
             dict(shape=(8, 32, 32, 3)), dict(shape=(8, 4, 4, 64)), dict(shape=(8, 30, 30, 3)),
             dict(shape=(8,)), dict(chunked=True, shape=(10, 8, 32, 32, 3)),
             dict(shape=(8, 6, 6, 3))]
    for kw in cases:
        assert tmesh.batch_sharding(jmesh, **kw) == tuple(jax_batch_sharding(jmesh, **kw).spec), kw
    flat = jax_make_mesh(devices, data=8)
    assert tmesh.batch_sharding(flat, shape=(8, 32, 32, 3)) == (("data", "fsdp"),)


@pytest.mark.parametrize("name,min_weight_size", [("tiny", 64), ("lsun", 2**14)])
def test_spatial_never_lands_on_a_leaf(devices, name, min_weight_size):
    """On (data=2, fsdp=2, spatial=2) every leaf's spec is JAX's through the
    layout permutation, and none names ``spatial``."""
    kw = dict(worker.TINY) if name == "tiny" else LSUN
    jmesh = jax_make_mesh(devices, data=2, fsdp=2, spatial=2)
    with torch.device("meta"):
        port = dict(t_ddpm.UNet(**kw).state_dict())
    shapes = jax.eval_shape(lambda: jax_ddpm.UNet(**kw).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)), jnp.zeros((2,), jnp.int32)))
    rename = {"kernel": "weight", "scale": "weight"}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [k.key for k in kp if k.key != "params"]
        keys[-1] = rename.get(keys[-1], keys[-1])
        k = ".".join(keys)
        want = jax_fsdp_param_spec(tuple(leaf.shape), jmesh, min_weight_size,
                                   path=jax.tree_util.keystr(kp))
        perm = tmesh.jax_axes(k, leaf.ndim)
        expected = [None] * leaf.ndim
        for i, axis in enumerate(want):
            expected[perm[i]] = axis
        got = tmesh.fsdp_param_spec(tuple(port[k].shape), jmesh, min_weight_size, path=k)
        assert got == (tuple(expected) if any(expected) else ()), k
        assert "spatial" not in got
    assert tmesh.split_axes(port, tmesh.Mesh(shape=tmesh.mesh_shape(8, data=2, fsdp=2, spatial=2),
                                             rank=0, device=torch.device("cpu"), backend="gloo",
                                             min_weight_size=min_weight_size), axis="spatial") == {}


def _hand_mesh(**axes):
    """Rank 0 of a mesh of these axes without a process group: enough for
    the refusals, which come before any collective."""
    shape = tmesh.mesh_shape(int(np.prod(list(axes.values()))), **axes)
    return tmesh.Mesh(shape=shape, rank=0, device=torch.device("cpu"), backend="gloo")


@pytest.mark.parametrize("other", ["tensor", "expert"])
def test_spatial_with_tensor_or_expert_raises_naming_a11(other):
    with pytest.raises(NotImplementedError, match=rf"spatial=2 composed with {other}=2.*A\.11"):
        tmesh.make_mesh(spatial=2, **{other: 2}, device="cpu")
    assert not torch.distributed.is_initialized()
    tmesh.require_ported({"spatial": 2, "fsdp": 2})  # data and fsdp compose


@pytest.mark.parametrize("family", ["adm", "classifier", "codec", "dit", "moe"])
def test_families_without_an_h_split_forward_raise_naming_a11(family):
    """shard_state refuses a spatial mesh for a model with no H-split
    forward, naming A.11, before the state changes."""
    build = {"adm": lambda: UNetModel(image_size=16, model_channels=32, channel_mult=(1, 2),
                                      num_res_blocks=1, attention_resolutions=(),
                                      num_head_channels=32),
             "classifier": lambda: EncoderUNet(image_size=16, model_channels=32,
                                               channel_mult=(1, 2), num_res_blocks=1,
                                               attention_resolutions=(), num_head_channels=32,
                                               num_classes=10),
             "codec": lambda: ConvVAE(latent_channels=4, base_channels=32,
                                      channel_multipliers=(1, 2), num_res_blocks=1),
             "dit": lambda: DiT(in_channels=3, patch_size=2, hidden=32, depth=2, num_heads=2,
                                pos_dim=16),
             "moe": lambda: DiT(in_channels=3, patch_size=2, hidden=32, depth=2, num_heads=2,
                                pos_dim=16, num_experts=4, moe_stride=2)}
    model = build[family]()
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = TrainState(step=0, params=dict(params), ema_params=dict(params), opt_state=None,
                       tx=None)
    with pytest.raises(NotImplementedError, match=r"spatial=2.*no H-split forward.*A\.11"):
        shard_state(state, _hand_mesh(spatial=2), model=model, min_weight_size=64)
    assert state.mesh is None and all(state.params[k] is v for k, v in params.items())


def test_rows_that_do_not_split_and_feature_capture_raise():
    """A height whose rows do not split into whole, even shards at every
    level raises naming A.11 before any collective; so do the
    feature-capture arguments on an H-split forward; a forward that is not
    a training one runs whole."""
    model = t_ddpm.UNet(**worker.TINY)
    model.place_spatial(SpatialGroup(None, 2, 0))  # no process group: nothing may reach one
    t = torch.zeros(2, dtype=torch.long)
    with pytest.raises(ValueError, match=r"height divisible by 16 .* got 24 \(ROADMAP A\.11\)"):
        model(torch.zeros(2, 24, 24, 3), t, train=True)
    with pytest.raises(ValueError, match="feature-capture arguments sample on whole images"):
        model(torch.zeros(2, 32, 32, 3), t, train=True, return_features=True)
    model.check_rows(32, 2)
    with torch.no_grad():
        assert model(torch.zeros(2, 24, 24, 3), t).shape == (2, 24, 24, 3)


def test_a_width_outside_the_split_kernels_domain_raises(monkeypatch):
    """On a CUDA route an H-shard of C % 8 != 0 raises naming A.11 before
    any launch: no simt.cu or plain fallback."""
    monkeypatch.setattr(k_gn, "route", lambda *a: "kernel")

    def launched(*a, **k):
        raise AssertionError("launched")

    for name in ("_launch_sums", "_launch_apply", "_launch_bwd_sums", "_launch_bwd_dx",
                 "_launch_simt", "gn_silu_sums_plain"):
        monkeypatch.setattr(k_gn, name, launched)
    with pytest.raises(NotImplementedError, match=r"C = 12; simt.cu .*A\.11"):
        k_gn.group_norm_silu_sums(torch.zeros(1, 2, 2, 12))


def test_split_plain_versions_equal_the_one_call_ones():
    """The four plain halves, the sums of two row shards added between them,
    against the one-call plain K1 and K2 (pre-bias and per-sample affine)."""
    g = torch.Generator().manual_seed(5)
    n, h, w, c, groups = 2, 8, 4, 16, 4
    x, dz = torch.randn(n, h, w, c, generator=g), torch.randn(n, h, w, c, generator=g)
    gamma, beta, bias = (torch.randn(n, c, generator=g) for _ in range(3))
    y, mean, inv = k_gn.gn_silu_plain(x, gamma, beta, bias, groups)
    parts = x.chunk(2, dim=1)
    sums = sum(k_gn.gn_silu_sums_plain(p) for p in parts)
    halves = [k_gn.gn_silu_apply_plain(p, sums, gamma, beta, bias, groups, h * w) for p in parts]
    np.testing.assert_allclose(torch.cat([a[0] for a in halves], 1).numpy(), y.numpy(),
                               **LAYER_TOL)
    for got in halves:
        np.testing.assert_allclose(got[1].numpy(), mean.numpy(), **LAYER_TOL)
        np.testing.assert_allclose(got[2].numpy(), inv.numpy(), **LAYER_TOL)
    dx, dgamma, dbeta, dbias = k_gn.gn_silu_bwd_plain(x, dz, gamma, beta, bias, mean, inv, groups)
    mine = [k_gn.gn_silu_bwd_sums_plain(p, d, gamma, beta, bias, mean, inv, groups)
            for p, d in zip(parts, dz.chunk(2, dim=1))]
    total = sum(mine)
    outs = [k_gn.gn_silu_bwd_dx_plain(p, d, gamma, beta, bias, mean, inv, total, groups, h * w)
            for p, d in zip(parts, dz.chunk(2, dim=1))]
    np.testing.assert_allclose(torch.cat([o[0] for o in outs], 1).numpy(), dx.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sum(o[1] for o in outs).numpy(), dbias.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(total[:, :c].numpy(), dbeta.numpy(), **LAYER_TOL)
    np.testing.assert_allclose(total[:, c:].numpy(), dgamma.numpy(), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- the group


def _parity_inputs():
    """{kind: JAX's module, its numpy params (every bias and GroupNorm scale
    redrawn), x₀, the injected t and ε}."""
    r = np.random.default_rng(3)
    out = {}
    for kind in worker.KINDS:
        model = _jax_model(kind)
        params = jax.jit(lambda k: model.init(k, jnp.zeros(SHAPE), jnp.zeros((SHAPE[0],),
                                                                             jnp.int32)))(
            jax.random.PRNGKey(0))

        def fill(path, leaf):
            name = path[-1].key
            if name == "bias":
                return (0.1 * r.standard_normal(leaf.shape)).astype(np.float32)
            if name == "scale":
                return (1.0 + 0.1 * r.standard_normal(leaf.shape)).astype(np.float32)
            return np.asarray(leaf)

        out[kind] = dict(model=model, params=jax.tree_util.tree_map_with_path(fill, params),
                         x0=np.clip(r.standard_normal(SHAPE), -1, 1).astype(np.float32),
                         eps=r.standard_normal(SHAPE).astype(np.float32),
                         # from 2: the IDDPM's t = 1 NLL is ill-conditioned in f32 at
                         # random weights (JAX's own parity test leaves it out too)
                         t=r.integers(2, worker.TIMESTEPS, SHAPE[0]).astype(np.int32))
    return out


def _jax_step(kind, d):
    """JAX's single-device loss and its gradient, as the port's leaves."""
    algo = (JaxIDDPM if worker.KINDS[kind][0] == "iddpm" else JaxDDPM).create(worker.TIMESTEPS)
    fn = jax_model_fn(d["model"])
    loss, grads = jax.jit(jax.value_and_grad(lambda p: algo.loss_given(
        fn, p, jnp.asarray(d["x0"]), jnp.asarray(d["t"]), jnp.asarray(d["eps"]))))(d["params"])
    return float(loss), from_flax(jax.tree_util.tree_map(np.asarray, grads))


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
    """The spawned workers: their pipes drained by threads while they run,
    killed at the deadline (as ``parallel.mp_check.spawn``)."""

    def __init__(self, out):
        self.out, self.deadline = out, time.monotonic() + DEADLINE
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
        for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                    "MASTER_PORT"):
            env.pop(key, None)
        ports = [str(free_port()), str(free_port())]
        self.procs = [subprocess.Popen(
            [sys.executable, worker.__file__, out, str(rank), str(WORLD), *ports],
            env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
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
    out = str(tmp_path_factory.mktemp("spatial"))
    inputs = _parity_inputs()
    torch.save({kind: {"state": from_flax(d["params"]), "x0": torch.tensor(d["x0"]),
                       "t": torch.tensor(d["t"], dtype=torch.int64),
                       "eps": torch.tensor(d["eps"])}
                for kind, d in inputs.items()}, os.path.join(out, "parity_input.pt"))
    _plain_checkpoint(os.path.join(out, "plain"))
    g = _Group(out)
    try:
        # JAX's steps while the workers run
        wants = {kind: _jax_step(kind, d) for kind, d in inputs.items()}
        yield dict(group=g, jax=wants)
    finally:
        for p in g.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def one_process():
    """Each UNet's three steps in this process at 1/R of the global batch,
    accumulating R, for R = 1 and 2: the logged metrics, the first step's
    gradients, the state."""
    out = {}
    for accumulate in (1, 2):
        for kind in worker.KINDS:
            rec = worker.Recorder()
            h = worker.lit(kind)
            with worker.FirstGradients() as first:
                state = fit(h, worker.data(worker.GLOBAL_BATCH // accumulate), worker.STEPS,
                            seed=0, log_every=1, loggers=[rec],
                            accumulate_grad_batches=accumulate, state=worker.init_state(h),
                            device="cpu")
            out[accumulate, kind] = dict(rows=rec.rows, grads=first.grads, state=state)
    return out


@pytest.mark.parametrize("mesh", ["spatial2", "spatial4"])
@pytest.mark.parametrize("name", list(worker.layer_cases()))
def test_layers_on_h_shards_equal_the_whole_layer(group, name, mesh):
    """The output and the input's gradient of Σ out·r on H-shards, gathered,
    within rtol 1e-5 and atol 1e-6 of the whole layer's; every leaf's
    gradient (the pre-bias and FiLM rows included), a sum over the rows
    that the shards add in another order, within rtol 1e-5 and an atol of
    1e-6 of its largest magnitude (f32 reassociation of a cancelling sum)."""
    module, extra, call = worker.layer_cases()[name]
    x, r = worker.layer_inputs()
    x = x.detach().requires_grad_(True)
    extra = {k: v.detach().requires_grad_(True) for k, v in extra.items()}
    y = call(module, x, extra, None)
    leaves = dict(module.named_parameters(), **extra)
    grads = torch.autograd.grad((y * r[name]).sum(), [x] + list(leaves.values()))
    got = torch.load(os.path.join(group["group"].wait(), "layers.pt"))[f"{mesh}/{name}"]
    np.testing.assert_allclose(got["y"].numpy(), y.detach().numpy(), **LAYER_TOL)
    np.testing.assert_allclose(got["dx"].numpy(), grads[0].numpy(), **LAYER_TOL)
    for k, g in zip(leaves, grads[1:]):
        scale = max(1.0, float(g.abs().max()))
        np.testing.assert_allclose(got["grads"][k].numpy(), g.numpy(), err_msg=k,
                                   rtol=LAYER_TOL["rtol"], atol=LAYER_TOL["atol"] * scale)


def _parity(out, name):
    world = 2 if name in worker.PAIR else WORLD
    return [torch.load(os.path.join(out, f"parity_{world}.{r}.pt"))
            for r in range(world)]


@pytest.mark.parametrize("kind", list(worker.KINDS))
@pytest.mark.parametrize("name", list(ALL_MESHES))
def test_spatial_step_matches_jax_single_device(group, name, kind):
    """One step on the mesh with (t, ε) injected: its loss within rtol 2e-4
    of JAX's single-device ``loss_given`` and every leaf's reduced gradient
    within the port's gradient tolerance of JAX's; every rank's state after
    it bitwise equal."""
    want_loss, want_grads = group["jax"][kind]
    ranks = _parity(group["group"].wait(), name)
    for r, got in enumerate(ranks):
        got = got[f"{name}/{kind}"]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=LOSS_RTOL, err_msg=f"rank {r}")
        assert got["digest"] == ranks[0][f"{name}/{kind}"]["digest"], f"rank {r}"
    grads = ranks[0][f"{name}/{kind}"]["grads"]
    assert set(grads) == set(want_grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[k].numpy(), err_msg=k, **GRAD_TOL)


def _flat(tensors, keys):
    """The tensors of ``keys`` flattened in f64, less the key third of each
    ``qkv_proj.bias``: softmax is invariant to it, so its gradient is
    rounding noise that Adam scales to a step of ±lr whatever its size."""
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
@pytest.mark.parametrize("name", list(ALL_MESHES))
def test_spatial_mesh_steps_match_one_accumulating_process(group, one_process, name, kind):
    """Three steps at dropout 0.1: each step's loss and grad norm within
    1e-5 relative of one process at 1/R of the batch accumulating R (R the
    batch ranks), every leaf's first reduced gradient within 1e-5 (relative
    L2), the gathered parameters, EMA and moments within 1e-5; every rank's
    gathered state bitwise equal."""
    out = group["group"].wait()
    world = 2 if name in worker.PAIR else WORLD
    axes = {"data": -1, "fsdp": 1, **ALL_MESHES[name]}
    ranks = world // axes["spatial"]  # the batch ranks: data × fsdp
    got = torch.load(os.path.join(out, f"steps_{name}_{kind}.pt"))
    ref = one_process[ranks, kind]
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
    assert bool(got["shard_axes"]) == (axes["fsdp"] > 1)
    digests = [torch.load(os.path.join(out, f"digest_{name}_{kind}.{r}.pt"))
               for r in range(world)]
    assert all(d == digests[0] for d in digests)


def _equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b) if torch.is_tensor(a) else a == b


def test_checkpoints_move_between_spatial_mesh_and_no_mesh_bitwise(group):
    """A mesh-less checkpoint restored on {fsdp: 2, spatial: 2}: every rank
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
