"""The ``expert`` mesh axis of the port against the JAX package and against
one process.

Without processes: the split-or-whole decision and its axis for every
parameter of the full-width MoE-DiT of configs/flow/cifar10_dit_moe.yaml,
against JAX's ``fsdp_param_spec`` through the layout permutation, on four
meshes. Then one group of four gloo workers on the CPU
(tests/torch_port_expert_worker.py), spawned once for the module with a
deadline that kills it, runs: each rank's expert-parallel ``MoEMlp`` on
its slice of a global input, which this process holds against JAX's
``MoEMlp`` on the same slice (each rank routes its own tokens, as JAX's
accumulation routes a microbatch); two steps of a tiny MoE-DiT on
``{expert: 4}``, ``{data: 2, expert: 2}`` and ``{fsdp: 2, expert: 2}``, with
and without remat (and on ``{expert: 4}`` with ``b_in`` split too), which
this process holds against one process at a quarter of the batch
accumulating 4; and checkpoints between a mesh and no mesh, bit for bit.
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
from flax import linen as fnn

from dmme_tpu.models import dit as jax_dit
from dmme_tpu.models.moe import MoEMlp as JaxMoEMlp
from dmme_tpu.parallel import fsdp_param_spec as jax_fsdp_param_spec
from dmme_tpu.parallel import make_mesh as jax_make_mesh
from dmme_tpu_torch.models.dit import DiT
from dmme_tpu_torch.parallel import mesh as tmesh
from dmme_tpu_torch.parallel.distributed import free_port
from dmme_tpu_torch.training import CheckpointManager, fit
from dmme_tpu_torch.utils.convert import from_flax
from tests import torch_port_expert_worker as worker

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
#: seconds the worker group may take before it is killed
DEADLINE = 240
#: the full-width MoE-DiT of configs/flow/cifar10_dit_moe.yaml
MOE_DIT = dict(patch_size=4, hidden=384, depth=12, num_heads=6, num_experts=8, moe_stride=2,
               moe_top_k=2, moe_capacity_factor=1.25)
#: the layer case: d, E, f, and a global batch of 4 slices of (2, 8) tokens
LAYER = dict(dim=8, num_experts=4, mlp_dim=16, top_k=2, capacity_factor=1.25)
LAYER_X = (WORLD * 2, 8, 8)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_REL = 1e-6


class _NoiseProbe(fnn.Module):
    """The root scope's first ``make_rng("dropout")`` draw, as MoEMlp makes it."""

    shape: tuple

    @fnn.compact
    def __call__(self):
        return jax.random.normal(self.make_rng("dropout"), self.shape, jnp.float32)


def _jax_leaves(model, shape):
    """[(port name, JAX path, JAX shape)] of a JAX DiT's parameters."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros(shape),
                            jnp.zeros((shape[0],), jnp.int32))
    shapes = {"params": shapes["params"]}  # init also sows the routers' statistics
    rename = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
    out = []
    for kp, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [k.key for k in kp if k.key != "params"]
        keys[-1] = rename.get(keys[-1], keys[-1])
        out.append((".".join(keys), jax.tree_util.keystr(kp), tuple(leaf.shape)))
    return out


@pytest.fixture(scope="module")
def full_width():
    """(JAX leaves, the port's ``state_dict`` on the meta device) of the full-width MoE-DiT."""
    with torch.device("meta"):
        port = dict(DiT(**MOE_DIT).state_dict())
    return _jax_leaves(jax_dit.DiT(**MOE_DIT), (2, 32, 32, 3)), port


@pytest.mark.parametrize("axes", [dict(expert=2), dict(data=2, expert=2),
                                  dict(fsdp=2, expert=2), dict(expert=3)],
                         ids=["expert2", "data2_expert2", "fsdp2_expert2", "expert3"])
def test_expert_spec_matches_jax_for_every_moe_dit_leaf(full_width, axes):
    """JAX's decision on every leaf (the expert axis on E of each rank-3 MoE
    stack of 2¹⁴ elements or more that it divides; fsdp on another axis)
    carried through the layout permutation; at expert=3 E = 8 stays whole."""
    leaves, port = full_width
    n = int(np.prod(list(axes.values())))
    jmesh = jax_make_mesh(jax.devices()[:n], **axes)
    assert {name for name, _, _ in leaves} == set(port)
    for name, path, jshape in leaves:
        want = jax_fsdp_param_spec(jshape, jmesh, path=path)
        perm = tmesh.jax_axes(name, len(jshape))
        expected = [None] * len(jshape)
        for i, axis in enumerate(want):
            expected[perm[i]] = axis
        expected = tuple(expected) if any(expected) else ()
        assert tmesh.fsdp_param_spec(tuple(port[name].shape), jmesh, path=name) == expected, (
            name, want)
    split = tmesh.expert_axes(port, jmesh, tmesh.MIN_WEIGHT_SIZE)
    stacks = {k for k in port if k.endswith(("moe_mlp.w_in", "moe_mlp.w_out"))}
    assert len(stacks) == 12
    assert split == ({} if axes.get("expert") == 3 else {k: 0 for k in stacks})
    # the biases stay whole: (8, 1, 1536) and (8, 1, 384) are under 2¹⁴
    assert not any(k.endswith(("b_in", "b_out")) for k in split)


# ------------------------------------------------------------- the group


def _layer_inputs():
    """JAX's layer, its numpy params, the global input and each slice's router noise."""
    jlayer = JaxMoEMlp(num_experts=LAYER["num_experts"], mlp_dim=LAYER["mlp_dim"],
                       top_k=LAYER["top_k"], capacity_factor=LAYER["capacity_factor"])
    shapes = jax.eval_shape(jlayer.init, jax.random.PRNGKey(0), jnp.zeros(LAYER_X))
    r = np.random.default_rng(3)

    def fill(path, leaf):
        name = path[-1].key
        if name in ("kernel", "w_in", "w_out"):
            return (r.standard_normal(leaf.shape) / np.sqrt(leaf.shape[-2])).astype(np.float32)
        return (0.1 * r.standard_normal(leaf.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes["params"])
    x = r.standard_normal(LAYER_X).astype(np.float32)
    tokens = LAYER_X[0] // WORLD * LAYER_X[1]
    noise = [np.asarray(_NoiseProbe((tokens, LAYER["num_experts"])).apply(
        {}, rngs={"dropout": jax.random.PRNGKey(100 + k)})) for k in range(WORLD)]
    return jlayer, params, x, noise


def _plain_checkpoint(directory):
    """A mesh-less run's checkpoint at step 3 of the tiny MoE-DiT, every
    tensor drawn (the moments too)."""
    state = worker.lit().init_state(0, device="cpu")
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
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                    "MASTER_PORT"):
            env.pop(key, None)
        port = free_port()
        self.procs = [subprocess.Popen(
            [sys.executable, worker.__file__, out, str(rank), str(WORLD), str(port)],
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
    out = str(tmp_path_factory.mktemp("expert"))
    jlayer, params, x, noise = _layer_inputs()
    state = from_flax(params)
    torch.save({"dims": (LAYER["dim"], LAYER["num_experts"], LAYER["mlp_dim"]),
                "kw": dict(top_k=LAYER["top_k"], capacity_factor=LAYER["capacity_factor"]),
                "state": state, "x": torch.tensor(x), "noise": [torch.tensor(n) for n in noise]},
               os.path.join(out, "layer_input.pt"))
    _plain_checkpoint(os.path.join(out, "plain"))
    g = _Group(out)
    try:
        yield dict(group=g, jlayer=jlayer, params=params, x=x, noise=noise)
    finally:
        for p in g.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def one_process():
    """The tiny MoE-DiT's two steps in this process at a quarter of the
    global batch, accumulating 4: the logged metrics, the first step's
    b_in/b_out gradients, and the state."""
    rec = worker.Recorder()
    h = worker.lit()
    with worker.FirstGradients(worker.is_bias) as first:
        state = fit(h, worker.data(worker.GLOBAL_BATCH // WORLD), worker.STEPS, seed=0,
                    log_every=1, loggers=[rec], accumulate_grad_batches=WORLD,
                    state=worker.init_state(h), device="cpu")
    return dict(rows=rec.rows, bias_grads=first.grads, state=state)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_expert_parallel_layer_matches_jax_on_each_slice(group, train):
    """Each rank's output and router statistics (its own capacity, Sinkhorn
    balance, f_e, moe_aux/align/z) within 1e-5 of JAX's layer on its slice,
    training with JAX's router noise for that slice."""
    jlayer = group["jlayer"].clone(deterministic=not train)
    want = []
    for r, x in enumerate(np.split(group["x"], WORLD)):
        rngs = {"dropout": jax.random.PRNGKey(100 + r)} if train else None
        y, vs = jlayer.apply({"params": group["params"]}, jnp.asarray(x), rngs=rngs,
                             mutable=["losses", "moe_stats"])
        stats = {k: np.asarray(v[0]) for k, v in {**vs["losses"], **vs["moe_stats"]}.items()}
        want.append(dict(stats, y=np.asarray(y)))
    out = group["group"].wait()
    for r in range(WORLD):
        got = torch.load(os.path.join(out, f"layer.{r}.pt"))["train" if train else "eval"]
        assert set(got) == set(want[r])
        for k, v in want[r].items():
            np.testing.assert_allclose(got[k].numpy(), v, **LAYER_TOL, err_msg=f"rank {r} {k}")


def _flat(tensors, keys):
    """The tensors of ``keys`` flattened in f64, less the key third of each
    ``qkv.bias``: softmax is invariant to it, so its gradient is rounding
    noise that Adam scales to a step of ±lr whatever its size
    (tests/test_torch_port_distributed.py leaves it out the same way)."""
    parts = []
    for k in keys:
        v = tensors[k].reshape(-1).double()
        if k.endswith("qkv.bias"):
            c = v.shape[0] // 3
            v = torch.cat([v[:c], v[2 * c:]])
        parts.append(v)
    return torch.cat(parts)


def _rel_l2(a, b):
    x, y = _flat(a, sorted(a)), _flat(b, sorted(a))
    return float((x - y).norm() / x.norm())


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("name", list(worker.MESHES))
def test_expert_mesh_steps_match_one_accumulating_process(group, one_process, name, remat):
    """Two steps on the mesh: each step's loss and grad norm within 1e-6
    relative of one process at batch B/4 accumulating 4; the gathered
    parameters, EMA and moments within 1e-6 relative L2; each rank holds
    its share of the expert stacks and of the fsdp leaves only."""
    out = group["group"].wait()
    got = torch.load(os.path.join(out, f"steps_{name}_{int(remat)}.pt"))
    ref = one_process
    assert [r["step"] for r in got["rows"]] == [1, 2]
    for row, want in zip(got["rows"], ref["rows"]):
        for k in ("loss", "grad_norm"):
            assert abs(row[k] - want[k]) <= STEP_REL * abs(want[k]), (k, row, want)
    state = ref["state"]
    for part, mine in (("params", state.params), ("ema", state.ema_params),
                       ("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
        assert _rel_l2(mine, got[part]) <= STEP_REL, part
    axes, min_weight_size = worker.MESHES[name]
    axes = {"fsdp": 1, **axes}
    stacks = {k for k, v in state.params.items() if "moe" in k and v.dim() == 3
              and v.numel() >= min_weight_size}
    assert {"block_1.moe_mlp.w_in", "block_1.moe_mlp.w_out"} <= stacks
    assert ("block_1.moe_mlp.b_in" in stacks) == (min_weight_size <= 512)
    assert got["expert_axes"] == {k: 0 for k in stacks}
    assert bool(got["shard_axes"]) == (axes["fsdp"] > 1)
    held = sum(v.numel() / (axes["expert"] if k in stacks else 1)
               / (axes["fsdp"] if k in got["shard_axes"] else 1) for k, v in state.params.items())
    assert got["held"] == 4 * held


@pytest.mark.parametrize("name", [k for k, (_, size) in worker.MESHES.items() if size > 512])
def test_expert_mesh_whole_bias_gradients_match(group, one_process, name):
    """b_in and b_out stay whole on every rank; a rank's gradient is zero
    for the experts it does not hold, and the world's sum over the batch
    ranks is the accumulating process's gradient (within 1e-6 relative L2)."""
    out = group["group"].wait()
    got = torch.load(os.path.join(out, f"steps_{name}_0.pt"))["bias_grads"]
    want = one_process["bias_grads"]
    assert set(got) == set(want) == {"block_1.moe_mlp.b_in", "block_1.moe_mlp.b_out"}
    for k in want:
        assert float(want[k].norm()) > 0
        assert got[k].shape == want[k].shape
        assert float((got[k] - want[k]).norm() / want[k].norm()) <= STEP_REL, k


def _equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b) if torch.is_tensor(a) else a == b


def test_checkpoints_move_between_expert_mesh_and_no_mesh_bitwise(group):
    """A mesh-less checkpoint restored on {data: 2, expert: 2}: every rank
    holds exactly its shards of it, and saving it from the mesh writes the
    same file; the mesh fit's own checkpoint is its ranks' gathered state
    and restores without a mesh bit for bit."""
    out = group["group"].wait()
    for r in range(WORLD):
        note = torch.load(os.path.join(out, f"restored.{r}.pt"))
        assert note["mismatched"] == [] and len(note["split"]) == 2
    assert _equal(CheckpointManager(os.path.join(out, "plain")).load(3),
                  CheckpointManager(os.path.join(out, "plain_back")).load(3))
    fitted = torch.load(os.path.join(out, f"steps_{worker.CKPT_MESH}_0.pt"))
    h = worker.lit()
    state = CheckpointManager(os.path.join(out, "ckpt_mesh")).restore(
        h.init_state(0, device="cpu"))
    assert state.step == worker.STEPS and not state.sharded
    for part, mine in (("params", state.params), ("ema", state.ema_params),
                       ("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
        assert _equal(mine, fitted[part]), part
