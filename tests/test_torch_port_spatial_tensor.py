"""The ``spatial`` mesh axis composed with ``tensor`` and with ``expert``,
against the JAX package and against one process.

Without processes: ``Mesh.batch_index``, the groups of the grid and
``batch_sharding`` on composed meshes against JAX's; ``fsdp_param_spec``
against JAX's for every leaf of the TINY and the LSUN UNet on ``{tensor:
2, spatial: 2}`` and ``{fsdp: 2, tensor: 2, spatial: 2}``
(``tensor`` on output axes, never ``spatial``); the MoE-DiT on ``{expert:
2, spatial: 2}`` refused naming A.11 before its state changes. Then one
group of four gloo workers on the CPU
(tests/torch_port_spatial_tensor_worker.py), spawned once for the module
with a deadline that kills it, runs: each layer on a rank's rows of its
channel shard on ``{tensor: 2, spatial: 2}`` against the whole layer; one
step of the TINY DDPM UNet (plain GroupNorm) and of a TINY IDDPM UNet
(FiLM, two heads, the fused GroupNorm's split entries, remat) with (t, ε)
injected on that mesh, every kernel split and some left whole, whose loss
and gradient this process holds against JAX's single-device
``loss_given``; three steps at dropout 0.1 on ``{tensor: 2, spatial: 2}``
and on the UNet's ``{expert: 2, spatial: 2}`` held against one process
accumulating R (1 and 2), every rank's gathered state bitwise equal;
checkpoints between the composed mesh and no mesh, bit for bit; and
``trainer fit`` and ``trainer test`` with ``--trainer.mesh "{data: -1,
tensor: 2, spatial: 2}"`` and ``"{data: -1, expert: 2, spatial: 2}"``,
the fits held against the same command in one process.
"""

import json
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
from dmme_tpu_torch.models.dit import DiT
from dmme_tpu_torch.parallel import mesh as tmesh
from dmme_tpu_torch.parallel import shard_state
from dmme_tpu_torch.parallel.distributed import free_port
from dmme_tpu_torch.training import CheckpointManager, fit
from dmme_tpu_torch.trainer import main as cli
from dmme_tpu_torch.training.state import TrainState
from dmme_tpu_torch.utils.convert import from_flax
from tests import torch_port_spatial_tensor_worker as worker

torch.set_num_threads(1)

WORLD = 4
#: seconds the worker group may take before it is killed
DEADLINE = 240
#: the UNet of configs/ddpm/lsun_church.yaml
LSUN = dict(dropout=0.0, channels_per_depth=(128, 128, 256, 256, 512, 512), attention_depths=(5,))
SHAPE = (worker.GLOBAL_BATCH, 32, 32, 3)
#: the layers against their whole counterparts, in f32
LAYER_TOL = dict(rtol=1e-5, atol=1e-6)
#: JAX's own bound for a sharded step (test_spatial_train_step_matches_single)
LOSS_RTOL = 2e-4
#: the gradients against JAX's, as tests/test_torch_port_training.py holds them
GRAD_TOL = dict(rtol=2e-3, atol=1e-5)
#: the first gradient against one process, as tests/test_torch_port_tensor.py holds it
GRAD_REL = 1e-5
#: the steps' metrics and states against one process: every sum over H and
#: over a channel shard's groups adds the shards' partial sums, so three
#: steps differ from one process by f32 reassociation
STEP_REL = 1e-5


def _jax_model(kind):
    family, kw = worker.KINDS[kind]
    kw = {k: v for k, v in kw.items() if k not in ("fused_norm", "remat")}
    return (jax_iddpm if family == "iddpm" else jax_ddpm).UNet(**kw, dropout=0.0)


def _hand_mesh(rank=0, **axes):
    """Rank ``rank`` of a mesh of these axes without a process group."""
    shape = tmesh.mesh_shape(int(np.prod(list(axes.values()))), **axes)
    return tmesh.Mesh(shape=shape, rank=rank, device=torch.device("cpu"), backend="gloo")


# ------------------------------------------------------------ no processes


@pytest.mark.parametrize("axes", [dict(tensor=2, spatial=2), dict(data=2, tensor=2, spatial=2),
                                  dict(expert=2, spatial=2), dict(fsdp=2, expert=2, spatial=2)],
                         ids=["t2s2", "d2t2s2", "e2s2", "f2e2s2"])
def test_batch_index_and_groups_of_the_composed_grid(axes):
    """A rank's batch index is its (data, fsdp, expert) coordinate, shared
    by its tensor and spatial groups; the spatial groups are consecutive
    ranks and the tensor groups stride over them, as JAX reshapes its
    device list; a tensor-split leaf's replicas differ along ``spatial``."""
    n = int(np.prod(list(axes.values())))
    shape = tmesh.mesh_shape(n, **axes)
    devices = np.arange(n).reshape([shape[a] for a in tmesh.GRID])
    for rank in range(n):
        mesh = _hand_mesh(rank, **axes)
        where = np.argwhere(devices == rank)[0]
        coords = dict(zip(tmesh.GRID, where))
        assert mesh.batch_index == (coords["data"] * shape["fsdp"] + coords["fsdp"]) * \
            shape["expert"] + coords["expert"]
        assert all(mesh.index(a) == coords[a] for a in tmesh.GRID)
        spatial = devices[tuple(where[:-1])].tolist()
        assert spatial == list(range(rank - coords["spatial"],
                                     rank - coords["spatial"] + shape["spatial"]))
        tensor = devices[tuple(where[:3])][:, where[4]].tolist()
        assert rank in tensor and len(tensor) == shape["tensor"]
        assert {tmesh.Mesh(shape=shape, rank=r, device=torch.device("cpu"),
                           backend="gloo").batch_index for r in spatial + tensor} == {
            mesh.batch_index}
    assert tmesh.replica_axes(("tensor",)) == ("data", "fsdp", "expert", "spatial")
    assert tmesh._varying(shape, tmesh.replica_axes(("tensor",))) == tuple(
        a for a in ("data", "fsdp", "expert", "spatial") if shape[a] > 1)


def test_batch_sharding_matches_jax_on_composed_meshes(devices):
    """JAX's specs of a batch and an image leaf on meshes with ``spatial``
    beside ``tensor`` and beside ``expert``."""
    cases = [dict(ndim=4), dict(ndim=1), dict(chunked=True, ndim=5),
             dict(shape=(8, 32, 32, 3)), dict(shape=(8, 4, 4, 64)), dict(shape=(8, 30, 30, 3)),
             dict(shape=(8,)), dict(chunked=True, shape=(10, 8, 32, 32, 3))]
    for axes in (dict(data=2, tensor=2, spatial=2), dict(data=2, expert=2, spatial=2),
                 dict(tensor=2, expert=2, spatial=2)):
        jmesh = jax_make_mesh(devices, **axes)
        for kw in cases:
            assert tmesh.batch_sharding(jmesh, **kw) == tuple(
                jax_batch_sharding(jmesh, **kw).spec), (axes, kw)


@pytest.mark.parametrize("axes", [dict(tensor=2, spatial=2), dict(fsdp=2, tensor=2, spatial=2)],
                         ids=["t2s2", "f2t2s2"])
@pytest.mark.parametrize("name,min_weight_size", [("tiny", 64), ("tiny", 512), ("lsun", 2**14)])
def test_composed_spec_matches_jax_for_every_unet_leaf(devices, name, min_weight_size, axes):
    """Every leaf's spec on the composed mesh is JAX's through the layout
    permutation: ``tensor`` on a kernel's output axis, never ``spatial``."""
    kw = dict(worker.TINY) if name == "tiny" else LSUN
    n = int(np.prod(list(axes.values())))
    jmesh = jax_make_mesh(devices[:n], **axes)
    with torch.device("meta"):
        port = dict(t_ddpm.UNet(**kw).state_dict())
    shapes = jax.eval_shape(lambda: jax_ddpm.UNet(**kw).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)), jnp.zeros((2,), jnp.int32)))
    rename = {"kernel": "weight", "scale": "weight"}
    split = 0
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
        if "tensor" in got:
            split += 1
            assert got.index("tensor") == 0, k  # the output axis of OIHW and (out, in)
    assert split > 0


def test_moe_dit_on_expert_spatial_raises_naming_a11():
    """The MoE-DiT has no H-split forward: ``shard_state`` refuses
    ``{expert: 2, spatial: 2}`` naming A.11 before the state changes, though
    the expert axis would split its stacks."""
    model = DiT(in_channels=3, patch_size=2, hidden=32, depth=2, num_heads=2, pos_dim=16,
                num_experts=4, moe_stride=2)
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = TrainState(step=0, params=dict(params), ema_params=dict(params), opt_state=None,
                       tx=None)
    mesh = _hand_mesh(expert=2, spatial=2)
    assert tmesh.expert_axes(params, mesh, 64)
    with pytest.raises(NotImplementedError, match=r"spatial=2.*no H-split forward.*A\.11"):
        shard_state(state, mesh, model=model, min_weight_size=64)
    assert state.mesh is None and all(state.params[k] is v for k, v in params.items())
    assert all(getattr(m, "expert_group", None) is None for m in model.modules())


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
        port = str(free_port())
        self.procs = [subprocess.Popen(
            [sys.executable, worker.__file__, out, str(rank), str(WORLD), port],
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
    out = str(tmp_path_factory.mktemp("spatial_tensor"))
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


@pytest.mark.parametrize("name", list(worker.layer_cases()))
def test_layers_on_composed_shards_equal_the_whole_layer(group, name):
    """The output, the input's gradient of Σ out·r on a rank's rows of its
    channel shard, gathered, and every leaf's gradient (the split kernels'
    summed over the spatial group and gathered over the tensor group; the
    pre-bias, FiLM and condition rows included) within rtol 1e-5 and an
    atol of 1e-6 of the largest magnitude of the whole layer's (at least
    1): a ResBlock's output (|y| up to ≈ 4.7) passes two convs and a
    GroupNorm whose sums the shards add in another order, and lands ≈
    1.2e-6 from one process where a sum of ≈ 1 cancels to ≈ 0.02."""
    module, extra, call, size = worker.layer_cases()[name]
    x, r = worker.layer_inputs()
    x = x.detach().requires_grad_(True)
    extra = {k: v.detach().requires_grad_(True) for k, v in extra.items()}
    y = call(module, x, extra, None, None)
    leaves = dict(module.named_parameters(), **extra)
    grads = torch.autograd.grad((y * r[name]).sum(), [x] + list(leaves.values()))
    got = torch.load(os.path.join(group["group"].wait(), "layers.pt"))[name]
    kernels = any(v.dim() > 1 for v in module.parameters())
    assert bool(got["split"]) == (kernels and size < 1 << 20), got["split"]
    pairs = dict(y=(got["y"], y.detach()), dx=(got["dx"], grads[0]),
                 **{k: (got["grads"][k], g) for k, g in zip(leaves, grads[1:])})
    for k, (mine, want) in pairs.items():
        scale = max(1.0, float(want.abs().max()))
        np.testing.assert_allclose(mine.numpy(), want.numpy(), err_msg=k,
                                   rtol=LAYER_TOL["rtol"], atol=LAYER_TOL["atol"] * scale)


@pytest.mark.parametrize("kind", list(worker.KINDS))
@pytest.mark.parametrize("size", list(worker.PARITY_SIZES))
def test_composed_step_matches_jax_single_device(group, size, kind):
    """One step on {tensor: 2, spatial: 2} with (t, ε) injected, every kernel
    split (``all``) or some left whole (``some``): its loss within rtol
    2e-4 of JAX's single-device ``loss_given`` and every leaf's reduced
    gradient within the port's gradient tolerance of JAX's; every rank's
    gathered state after it bitwise equal."""
    want_loss, want_grads = group["jax"][kind]
    out = group["group"].wait()
    ranks = [torch.load(os.path.join(out, f"parity.{r}.pt")) for r in range(WORLD)]
    for r, got in enumerate(ranks):
        got = got[f"{size}/{kind}"]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=LOSS_RTOL, err_msg=f"rank {r}")
        assert got["digest"] == ranks[0][f"{size}/{kind}"]["digest"], f"rank {r}"
    lead = ranks[0][f"{size}/{kind}"]
    # "some" leaves kernels whole that "all" splits (the only ones "all"
    # leaves whole have an output width the axis does not divide)
    every = set(ranks[0][f"all/{kind}"]["split"])
    assert set(lead["split"]) and set(lead["split"]) <= every
    assert (set(lead["split"]) == every) == (size == "all")
    assert set(lead["grads"]) == set(want_grads)
    for k, g in lead["grads"].items():
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
@pytest.mark.parametrize("name", list(worker.MESHES))
def test_composed_mesh_steps_match_one_accumulating_process(group, one_process, name, kind):
    """Three steps at dropout 0.1: each step's loss and grad norm within
    1e-5 relative of one process at 1/R of the batch accumulating R (R the
    batch ranks: 1 on {tensor: 2, spatial: 2}, 2 on {expert: 2, spatial:
    2}), every leaf's first reduced gradient within 1e-5 (relative L2), the
    gathered parameters, EMA and moments within 1e-5; every rank's gathered
    state bitwise equal (not one process's: the GroupNorm sums add per
    shard)."""
    out = group["group"].wait()
    axes = worker.MESHES[name]
    ranks = WORLD // (axes.get("tensor", 1) * axes["spatial"])
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
    assert bool(got["tensor_axes"]) == ("tensor" in axes) and not got["expert_axes"]
    digests = [torch.load(os.path.join(out, f"digest_{name}_{kind}.{r}.pt"))
               for r in range(WORLD)]
    assert all(d == digests[0] for d in digests)


def _equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b) if torch.is_tensor(a) else a == b


def test_checkpoints_move_between_composed_mesh_and_no_mesh_bitwise(group):
    """A mesh-less checkpoint restored on {tensor: 2, spatial: 2}: every rank
    holds exactly its tensor shards of it, and saving it from the mesh
    writes the same file; the mesh fit's own checkpoint is its ranks'
    gathered state and restores without a mesh bit for bit."""
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


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.mark.parametrize("name", list(worker.CLI_MESHES))
def test_trainer_fit_and_test_take_a_composed_mesh(group, tmp_path, name):
    """``trainer fit`` with ``--trainer.mesh`` set to the composed mesh (the
    64-wide kernels split, the 16-wide ones whole) logs each step's loss
    and grad norm within 1e-5 relative of the same command in one process
    at 1/R of the batch accumulating R, and its checkpoint's parameters,
    EMA and moments lie within 1e-5 of that process's; ``trainer test`` on
    the mesh prints its results once, on rank 0, over every test batch."""
    out = group["group"].wait()
    printed = [torch.load(os.path.join(out, f"cli.{r}.pt"))[name] for r in range(WORLD)]
    assert not any(printed[1:])
    results = eval(printed[0].strip().splitlines()[-1])
    assert results["num_batches"] == worker.CLI_TEST_BATCHES
    assert np.isfinite(results["fid"]) and np.isfinite(results["inception_score"])
    ranks = 2 if "expert" in name else 1
    cfg = tmp_path / "one.yaml"
    cfg.write_text(worker.CLI_CONFIG.format(root=tmp_path / "one"))
    cli(["fit", "--config", str(cfg), "--trainer.mesh", "null", "--data.init_args.batch_size",
         str(8 // ranks), "--trainer.accumulate_grad_batches", str(ranks)], device="cpu")
    mesh_rows = _jsonl(os.path.join(out, f"cli_{name}", "metrics.jsonl"))
    one_rows = _jsonl(tmp_path / "one" / "metrics.jsonl")
    assert [r["step"] for r in mesh_rows] == [r["step"] for r in one_rows] == [1, 2]
    for row, want in zip(mesh_rows, one_rows):
        for k in ("loss", "grad_norm"):
            assert abs(row[k] - want[k]) <= STEP_REL * abs(want[k]), (k, row, want)
    mine = CheckpointManager(os.path.join(out, f"cli_{name}")).load(2)
    want = CheckpointManager(str(tmp_path / "one")).load(2)
    for part in ("params", "ema_params", "mu", "nu"):
        a, b = (s[part] if part in s else s["opt_state"][part] for s in (want, mine))
        assert _rel_l2(a, b) <= STEP_REL, part
