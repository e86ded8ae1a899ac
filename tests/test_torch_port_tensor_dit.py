"""The ``tensor`` mesh axis of the port for the DiT and the MoE-DiT, against
the JAX package and against one process.

Without processes: the split-or-whole decision and its axis for every
parameter of the full-width DiT of configs/flow/cifar10_dit.yaml and
MoE-DiT of configs/flow/cifar10_dit_moe.yaml, and of the tiny DiTs at JAX's
test threshold (``min_weight_size=64``), against JAX's ``fsdp_param_spec``
through the layout permutation, on four meshes, and what a rank of either
config's ``{data: -1, tensor: 2}`` holds. Then one group of four gloo
workers on the CPU (tests/torch_port_tensor_dit_worker.py), spawned once
for the module with a deadline that kills it, runs on ``{data: -1,
tensor: 2}``, ``{fsdp: 2, tensor: 2}`` and, for the MoE-DiT, ``{expert: 2,
tensor: 2}`` and a ``{data: -1, tensor: 2}`` that leaves the router and the
expert biases whole: JAX's tiny DiT (hidden 64, 4 heads, patch 4), with
dropout, class-conditional with remat, and with 4 experts top-2, each
rank's forward and injected flow loss on its batch slice, which this
process holds against JAX's single-device ``apply`` on that slice (every
parameter + 0.02, as tests/test_dit.py does; each batch rank routes its
own tokens); three steps, which this process holds against one process at
half the batch accumulating 2, every leaf's first gradient (the router's
too, at ``moe_aux_weight`` 0.01) included; and checkpoints between the
expert × tensor mesh and no mesh, bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmme_tpu.diffusion import FlowMatching as JaxFlow
from dmme_tpu.models import as_model_fn as jax_model_fn
from dmme_tpu.models import dit as jax_dit
from dmme_tpu.parallel import fsdp_param_spec as jax_fsdp_param_spec
from dmme_tpu.parallel import make_mesh as jax_make_mesh
from dmme_tpu_torch.models.dit import DiT
from dmme_tpu_torch.parallel import mesh as tmesh
from dmme_tpu_torch.training import CheckpointManager, fit
from dmme_tpu_torch.utils.convert import from_flax
from tests import torch_port_tensor_dit_worker as worker
from tests.test_torch_port_tensor import _equal, _Group

torch.set_num_threads(1)

WORLD = 4
#: the DiT-S/4 of configs/flow/cifar10_dit.yaml and the MoE-DiT of cifar10_dit_moe.yaml
FULL = {"dit": dict(patch_size=4, hidden=384, depth=12, num_heads=6),
        "moe": dict(patch_size=4, hidden=384, depth=12, num_heads=6, num_experts=8,
                    moe_stride=2, moe_top_k=2, moe_capacity_factor=1.25)}
#: {config: (parameters, the bytes a rank holds on {data: -1, tensor: 2}
#: (parameters, EMA and both moments in f32), kernels split)}
FULL_HELD = {"dit": (32_499_120, 260_561_664, 65), "moe": (82_143_456, 658_509_312, 65)}
SHAPE = (4, 16, 16, 3)
FORWARD_ATOL = 2e-5
LOSS_RTOL = 2e-4
GRAD_REL = 1e-5
STEP_REL = 1e-6


def _jax_model(kw):
    return jax_dit.DiT(**{k: v for k, v in kw.items() if k != "remat"})


def _jax_leaves(model, shape, y=None):
    """[(port name, JAX path, JAX shape)] of a JAX DiT's parameters."""
    args = (jnp.zeros(shape), jnp.zeros((shape[0],), jnp.int32))
    kw = {} if y is None else {"y": jnp.zeros((shape[0],), jnp.int32)}
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args, **kw))
    shapes = {"params": shapes["params"]}  # init also sows the routers' statistics
    rename = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
    out = []
    for kp, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [k.key for k in kp if k.key != "params"]
        keys[-1] = rename.get(keys[-1], keys[-1])
        out.append((".".join(keys), jax.tree_util.keystr(kp), tuple(leaf.shape)))
    return out


@pytest.fixture(scope="module")
def dits():
    """{name: (JAX leaves, the port's ``state_dict`` on the meta device, min_weight_size)}."""
    out = {}
    models = [(k, kw, 2**14, (2, 32, 32, 3)) for k, kw in FULL.items()]
    models += [(k, worker.KINDS[k], 64, SHAPE) for k in ("dit", "class", "moe")]
    for name, kw, size, shape in models:
        with torch.device("meta"):
            port = dict(DiT(**kw).state_dict())
        key = name if size == 2**14 else f"tiny_{name}"
        out[key] = (_jax_leaves(_jax_model(kw), shape, kw.get("num_classes")), port, size)
    return out


@pytest.mark.parametrize("axes", [dict(tensor=2), dict(tensor=4), dict(fsdp=2, tensor=2),
                                  dict(expert=2, tensor=2)],
                         ids=["tensor2", "tensor4", "fsdp2_tensor2", "expert2_tensor2"])
@pytest.mark.parametrize("name", ["dit", "moe", "tiny_dit", "tiny_class", "tiny_moe"])
def test_tensor_spec_matches_jax_for_every_dit_leaf(dits, name, axes):
    """JAX's decision on every leaf (the output axis of each Dense and conv
    kernel, the features of the label table and the last axis of each
    expert stack, where the axis divides them; expert on E of the stacks,
    fsdp on another axis) carried through the layout permutation."""
    leaves, port, min_weight_size = dits[name]
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
    if "moe" in name:
        stacks = {k for k in port if k.endswith(("moe_mlp.w_in", "moe_mlp.w_out"))}
        assert stacks <= set(split) and all(split[k] == 2 for k in stacks)
        if "expert" in axes:
            assert stacks <= set(tmesh.expert_axes(port, jmesh, min_weight_size))
    if name in FULL and axes == dict(tensor=2):
        held = sum(v.numel() // (2 if k in split else 1) for k, v in port.items())
        total = sum(v.numel() for v in port.values())
        assert (total, 16 * held, len(split)) == FULL_HELD[name]
        assert all(v.numel() < 2**14 for k, v in port.items() if k not in split)


# ------------------------------------------------------------- the group


def _forward_inputs():
    """{kind: JAX's module, its params (JAX's init + 0.02), the global
    batch's inputs, the injected flow (t, x₁) and the labels}."""
    r = np.random.default_rng(3)
    out = {}
    for kind, kw in worker.KINDS.items():
        model = _jax_model(kw)
        y = (np.arange(SHAPE[0]) % worker.CLASSES).astype(np.int32) if "num_classes" in kw \
            else None
        ykw = {} if y is None else {"y": jnp.asarray(y)}
        params = jax.jit(lambda k: model.init(k, jnp.zeros(SHAPE), jnp.zeros((SHAPE[0],),
                                                                             jnp.int32), **ykw))(
            jax.random.PRNGKey(0))
        params = jax.tree_util.tree_map(lambda p: np.asarray(p + 0.02),
                                        {"params": params["params"]})
        out[kind] = dict(model=model, params=params, y=y,
                         x=r.standard_normal(SHAPE).astype(np.float32),
                         t=r.uniform(1, 999, SHAPE[0]).astype(np.float32),
                         x0=np.clip(r.standard_normal(SHAPE), -1, 1).astype(np.float32),
                         x1=r.standard_normal(SHAPE).astype(np.float32),
                         s=r.uniform(0.05, 0.95, SHAPE[0]).astype(np.float32))
    return out


def _plain_checkpoint(directory):
    """A mesh-less run's checkpoint at step 3 of the checkpoint DiT, every
    tensor drawn (the moments too)."""
    state = worker.lit(worker.CKPT[1]).init_state(0, device="cpu")
    g = torch.Generator().manual_seed(5)
    for part in (state.params, state.ema_params, state.opt_state.mu, state.opt_state.nu):
        for k in part:
            part[k] = torch.randn(part[k].shape, generator=g)
    state.step = state.opt_state.count = 3
    CheckpointManager(directory).save(3, state)


class _DiTGroup(_Group):
    script = worker.__file__


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tensor_dit"))
    inputs = _forward_inputs()
    torch.save({kind: {"state": from_flax(d["params"]["params"]),
                       **{k: torch.tensor(d[k]) for k in ("x", "t", "x0", "x1", "s")},
                       "y": None if d["y"] is None else torch.tensor(d["y"], dtype=torch.int64)}
                for kind, d in inputs.items()}, os.path.join(out, "forward_input.pt"))
    _plain_checkpoint(os.path.join(out, "plain"))
    g = _DiTGroup(out)
    try:
        yield dict(group=g, inputs=inputs)
    finally:
        for p in g.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def one_process():
    """Each DiT's three steps in this process at half the global batch,
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


CASES = [(name, kind) for name, (_, _, kinds) in worker.MESHES.items() for kind in kinds]


@pytest.mark.parametrize("name,kind", CASES, ids=[f"{n}-{k}" for n, k in CASES])
def test_tensor_parallel_dit_forward_and_loss_match_jax(group, name, kind):
    """Every rank's whole output on its batch slice within 2e-5 of JAX's
    single-device ``apply`` on that slice with the same weights, and its
    flow loss with (t, x₁) injected within rtol 2e-4 of JAX's ``loss_given``."""
    d = group["inputs"][kind]
    algo = JaxFlow.create()
    out = group["group"].wait()
    for r in range(WORLD):
        got = torch.load(os.path.join(out, f"forward.{r}.pt"))[f"{name}/{kind}"]
        assert got["split"], "the tensor axis split nothing"
        assert bool(got["experts"]) == ("expert" in worker.MESHES[name][0])
        part = slice(2 * got["slice"], 2 * got["slice"] + 2)
        kw = {} if d["y"] is None else {"y": jnp.asarray(d["y"][part])}
        want = np.asarray(d["model"].apply(d["params"], jnp.asarray(d["x"][part]),
                                           jnp.asarray(d["t"][part]), **kw))
        base = jax_model_fn(d["model"])
        loss = float(algo.loss_given(lambda p, x, t, **k: base(p, x, t, **kw, **k),
                                     d["params"], jnp.asarray(d["x0"][part]),
                                     jnp.asarray(d["s"][part]), jnp.asarray(d["x1"][part])))
        np.testing.assert_allclose(got["y"].numpy(), want, rtol=0, atol=FORWARD_ATOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(float(got["loss"]), loss, rtol=LOSS_RTOL)


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


def _rel_l2(a, b, keys=None):
    keys = sorted(a) if keys is None else keys
    x, y = _flat(a, keys), _flat(b, keys)
    return float((x - y).norm() / x.norm())


@pytest.mark.parametrize("name,kind", CASES, ids=[f"{n}-{k}" for n, k in CASES])
def test_tensor_mesh_dit_steps_match_one_accumulating_process(group, one_process, name, kind):
    """Three steps on the mesh: each step's loss and grad norm within 1e-6
    relative of one process at half the batch accumulating 2, every leaf's
    first reduced gradient within 1e-5 (relative L2; the router's, the
    whole biases and the sliced modulation among them), the gathered
    parameters, EMA and moments within 1e-6; each rank holds its share of
    the split leaves only, and no all-gather over the tensor group sent a
    split kernel's shard."""
    out = group["group"].wait()
    got = torch.load(os.path.join(out, f"steps_{name}_{kind}.pt"))
    ref = one_process[kind]
    assert [r["step"] for r in got["rows"]] == [1, 2, 3]
    for row, want in zip(got["rows"], ref["rows"]):
        for k in ("loss", "grad_norm"):
            assert abs(row[k] - want[k]) <= STEP_REL * abs(want[k]), (k, row, want)
    assert set(got["grads"]) == set(ref["grads"])
    for k in ref["grads"]:
        if k.endswith("qkv.bias"):
            continue  # its key third is rounding noise (_flat); held in the state below
        assert float(ref["grads"][k].norm()) > 0, k
        assert _rel_l2(ref["grads"], got["grads"], [k]) <= GRAD_REL, k
    assert _rel_l2(ref["grads"], got["grads"]) <= GRAD_REL
    state = ref["state"]
    for part, mine in (("params", state.params), ("ema", state.ema_params),
                       ("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
        assert _rel_l2(mine, got[part]) <= STEP_REL, part
    axes = {"fsdp": 1, "expert": 1, **worker.MESHES[name][0]}
    assert got["tensor_axes"] and bool(got["shard_axes"]) == (axes["fsdp"] > 1)
    assert bool(got["expert_axes"]) == (axes["expert"] > 1)
    router = [k for k in state.params if k.endswith("router.weight")]
    assert all((k in got["tensor_axes"]) == (worker.MESHES[name][1] == 64) for k in router)
    held = sum(v.numel() / (2 if k in got["tensor_axes"] else 1)
               / (axes["fsdp"] if k in got["shard_axes"] else 1)
               / (axes["expert"] if k in got["expert_axes"] else 1)
               for k, v in state.params.items())
    assert got["held"] == 4 * held
    assert got["gathers"] > 0 and got["weights_sent"] == 0


def test_checkpoints_move_between_expert_tensor_mesh_and_no_mesh_bitwise(group):
    """A mesh-less checkpoint restored on {expert: 2, tensor: 2}: every rank
    holds exactly its shards of it (the expert shard, then the tensor
    shard), and saving it from the mesh writes the same file; the mesh
    fit's own checkpoint is its ranks' gathered state and restores without
    a mesh bit for bit."""
    out = group["group"].wait()
    for r in range(WORLD):
        note = torch.load(os.path.join(out, f"restored.{r}.pt"))
        assert note["mismatched"] == [] and note["split"] and note["experts"]
        assert set(note["experts"]) <= set(note["split"])
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
