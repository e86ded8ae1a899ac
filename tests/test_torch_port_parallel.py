"""The port's mesh layer against the JAX package's, in this process.

Mesh sizes and their assertions against ``dmme_tpu.parallel.make_mesh``
over the tests' 8 virtual CPU devices, and each parallel axis on one
process (JAX's size assertion; ROADMAP A.11); the fsdp split-or-whole
decision and its axis for every leaf of the TINY and the CIFAR-10 UNet
against JAX's ``fsdp_param_spec`` through the layout permutation (HWIO →
OIHW, (in, out) → (out, in)); the statistics merges against JAX's ``psum``
over two devices; and a mesh of one process (a gloo group of 1), which
must leave a run bitwise as it is without one. Two ranks are
tests/test_torch_port_distributed.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from dmme_tpu.eval import fid as jfid
from dmme_tpu.eval import inception_score as jis
from dmme_tpu.models import ddpm as jax_ddpm
from dmme_tpu.parallel import fsdp_param_spec as jax_fsdp_param_spec
from dmme_tpu.parallel import make_mesh as jax_make_mesh
from dmme_tpu_torch import parallel
from dmme_tpu_torch.data import CIFAR10
from dmme_tpu_torch.eval import FrechetInceptionDistance, InceptionScore
from dmme_tpu_torch.eval.fid import FeatureStats
from dmme_tpu_torch.eval.inception_score import ISStats
from dmme_tpu_torch.models import ddpm as t_ddpm
from dmme_tpu_torch.parallel import distributed, mesh as tmesh
from dmme_tpu_torch.training import LitDDPM, fit
from dmme_tpu_torch.utils import device as tdevice

torch.set_num_threads(1)

TINY = dict(pos_dim=4, emb_dim=8, num_groups=2, channels_per_depth=(4, 8, 16, 32),
            num_blocks=2)
EXPORTS = {"make_mesh", "batch_sharding", "replicated", "params_sharding", "state_sharding",
           "fsdp_param_spec", "shard_state", "shard_batch", "initialize", "global_batch",
           "make_train_step", "make_train_chunk", "make_eval_step", "global_norm"}
STATS_RTOL = 1e-6


@pytest.fixture
def world_of_one():
    """A mesh over a gloo group of this process alone, shut down after."""
    assert not dist.is_initialized()
    mesh = parallel.make_mesh(device="cpu")
    try:
        yield mesh
    finally:
        parallel.shutdown()


def test_exports_mirror_jax():
    import dmme_tpu.parallel as jpar

    assert EXPORTS <= set(parallel.__all__)
    assert set(jpar.__all__) <= set(parallel.__all__)


@pytest.mark.parametrize("n,axes", [
    (1, {}), (2, {}), (8, {}), (8, dict(fsdp=2)), (8, dict(fsdp=4)), (8, dict(fsdp=8)),
    (8, dict(data=2, fsdp=4)), (8, dict(fsdp=2, tensor=2)), (8, dict(expert=2, spatial=2)),
    (4, dict(data=-1, fsdp=1)),
])
def test_mesh_sizes_match_jax(n, axes):
    want = jax_make_mesh(jax.devices()[:n], **axes).shape
    got = tmesh.mesh_shape(n, **axes)
    assert list(got) == list(want) and dict(got) == dict(want)


@pytest.mark.parametrize("n,axes", [(8, dict(fsdp=3)), (8, dict(data=3, fsdp=2)),
                                    (2, dict(data=2, fsdp=2))])
def test_mesh_size_errors_match_jax(n, axes):
    with pytest.raises(AssertionError) as want:
        jax_make_mesh(jax.devices()[:n], **axes)
    with pytest.raises(AssertionError) as got:
        tmesh.mesh_shape(n, **axes)
    assert got.value.args == want.value.args


@pytest.mark.parametrize("axis", ["tensor", "spatial", "expert"])
def test_unported_axes_raise_naming_a11(axis):
    """``expert``, ``tensor`` and ``spatial`` are ported (A.11), and on one
    process raise JAX's size assertion and leave no group behind
    (``spatial`` composed with ``tensor`` or ``expert`` still raises naming
    A.11: tests/test_torch_port_spatial.py)."""
    with pytest.raises(AssertionError) as want:
        jax_make_mesh(jax.devices()[:1], **{axis: 2})
    with pytest.raises(AssertionError) as got:
        parallel.make_mesh(device="cpu", **{axis: 2})
    assert got.value.args == want.value.args
    assert got.value.args == ({"expert": (1, 1, 2, 1, 1), "tensor": (1, 1, 1, 2, 1),
                               "spatial": (1, 1, 1, 1, 2)}[axis],)
    assert not dist.is_initialized()


def test_a_mesh_of_one_process_is_a_world_of_one(world_of_one):
    mesh = world_of_one
    assert dict(mesh.shape) == dict(data=1, fsdp=1, expert=1, tensor=1, spatial=1)
    assert (mesh.rank, mesh.world, mesh.batch_ranks, mesh.backend) == (0, 1, 1, "gloo")
    assert mesh.owns_group and mesh.device == torch.device("cpu")
    again = parallel.make_mesh(data=-1, fsdp=1, device="cpu")
    assert not again.owns_group and dict(again.shape) == dict(mesh.shape)
    with pytest.raises(AssertionError, match="mesh 1x2x1x1x1 != 1 devices"):
        parallel.make_mesh(data=1, fsdp=2, device="cpu")
    with pytest.raises(ValueError, match="spans the whole process group"):
        parallel.make_mesh([0, 1], device="cpu")


def test_backend_rule_and_the_ranks_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert distributed.choose_backend(torch.device("cpu"), 1) == "gloo"
    assert distributed.choose_backend(torch.device("cuda:0"), 1) == "nccl"
    assert distributed.choose_backend(torch.device("cuda:0"), 2) == "gloo"  # ranks share a card
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert tdevice.resolve_device(None) == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert tdevice.resolve_device(None) == torch.device("cuda:1")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")


def _jax_leaves(model, shape):
    """[(port name, JAX path, JAX shape)] of a JAX UNet's parameters."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros(shape),
                            jnp.zeros((shape[0],), jnp.int32))
    rename = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
    out = []
    for kp, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [k.key for k in kp if k.key != "params"]
        keys[-1] = rename.get(keys[-1], keys[-1])
        out.append((".".join(keys), jax.tree_util.keystr(kp), tuple(leaf.shape)))
    return out


@pytest.mark.parametrize("which,fsdp", [("tiny", 2), ("tiny", 4), ("cifar", 2), ("cifar", 4),
                                        ("cifar", 8)])
def test_fsdp_param_spec_matches_jax_for_every_leaf(which, fsdp):
    """JAX's decision (whole under 2¹⁴ elements, else the largest axis fsdp
    divides) and axis, carried through the layout permutation, on every leaf
    of the port's ``state_dict`` (built on the meta device)."""
    kw = TINY if which == "tiny" else {}
    with torch.device("meta"):
        port = dict(t_ddpm.UNet(**kw).state_dict())
    jmesh = jax_make_mesh(jax.devices()[:fsdp], data=1, fsdp=fsdp)
    leaves = _jax_leaves(jax_ddpm.UNet(**kw), (2, 32, 32, 3))
    assert {name for name, _, _ in leaves} == set(port)
    split = 0
    for name, path, jshape in leaves:
        want = jax_fsdp_param_spec(jshape, jmesh, path=path)
        perm = tmesh.jax_axes(name, len(jshape))
        assert tuple(port[name].shape[p] for p in perm) == jshape, name
        expected = [None] * len(jshape)
        for i, axis in enumerate(want):
            expected[perm[i]] = axis
        expected = tuple(expected) if any(expected) else ()
        got = tmesh.fsdp_param_spec(tuple(port[name].shape), jmesh, path=name)
        assert got == expected, (name, jshape, want, got)
        split += "fsdp" in got
    assert split > 0
    specs = tmesh.params_sharding(port, jmesh)
    assert specs == {k: tmesh.fsdp_param_spec(tuple(v.shape), jmesh, path=k)
                     for k, v in port.items()}


def test_state_sharding_and_placements_mirror_jax(world_of_one):
    lit = LitDDPM(model=t_ddpm.UNet(**TINY), timesteps=10)
    state = lit.init_state(0, device="cpu")
    specs = parallel.state_sharding(state, world_of_one)
    assert specs["step"] == specs["opt_state"]["count"] == ()
    assert specs["params"] == specs["ema_params"] == specs["opt_state"]["mu"]
    assert all(v == () for v in specs["params"].values())  # fsdp = 1: all whole
    assert parallel.batch_sharding(world_of_one) == (("data", "fsdp"),)
    assert parallel.batch_sharding(world_of_one, chunked=True) == (None, ("data", "fsdp"))
    assert parallel.replicated(world_of_one) == ()


def test_batch_placement_at_world_one(world_of_one):
    x = np.arange(2 * 4 * 3, dtype=np.uint8).reshape(2, 4, 3)
    got = parallel.global_batch(x, world_of_one, global_size=2)
    assert torch.equal(got, torch.from_numpy(x))
    stacked = parallel.global_batch((x[None], x[None, :, 0]), world_of_one, chunked=True,
                                    global_size=2)
    assert stacked[0].shape == (1, 2, 4, 3)
    with pytest.raises(ValueError, match="must hold 4 rows, got 2"):
        parallel.global_batch(x, world_of_one, global_size=4)
    assert torch.equal(parallel.shard_batch(x, world_of_one), torch.from_numpy(x))


def _halves_jax_psum(make, update, merge, data):
    """JAX's per-device statistics of the two halves of ``data``, psum-ed
    over two devices (``merge_across`` inside ``shard_map``)."""
    mesh = jax_make_mesh(jax.devices()[:2], data=2)

    def body(x):
        return merge(update(make(), x))

    return jax.shard_map(body, mesh=mesh, in_specs=P("data"), out_specs=P())(jnp.asarray(data))


def test_statistics_merges_match_jax_psum(world_of_one):
    """Two ranks' FeatureStats and ISStats summed (what ``merge_across``
    all-reduces) against JAX's psum of the same halves; at a world of one
    ``merge_across`` leaves both as they are."""
    r = np.random.default_rng(0)
    feats = r.standard_normal((16, 64)).astype(np.float32)
    logits = r.standard_normal((16, 10)).astype(np.float32)
    halves = [FeatureStats.create(64).update(torch.from_numpy(h)) for h in np.split(feats, 2)]
    summed = FeatureStats(*(a + b for a, b in zip(*halves)))
    want = _halves_jax_psum(lambda: jfid.FeatureStats.create(64), jfid.FeatureStats.update,
                            lambda s: jax.tree.map(lambda t: jax.lax.psum(t, "data"), s), feats)
    for got, w in zip(summed, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=STATS_RTOL, atol=1e-5)
    per_half = []
    for h in np.split(logits, 2):
        score = InceptionScore()
        score.update(torch.from_numpy(h))
        per_half.append(score.stats)
    want = _halves_jax_psum(lambda: jis.ISStats.create(10),
                            lambda s, x: jis.InceptionScore._update_impl(s, x),
                            lambda s: jax.tree.map(lambda t: jax.lax.psum(t, "data"), s), logits)
    for a, b, w in zip(*per_half, want):
        np.testing.assert_allclose((a + b).numpy(), np.asarray(w), rtol=STATS_RTOL, atol=1e-6)
    fid, score = FrechetInceptionDistance(dim=64), InceptionScore()
    fid.update(torch.from_numpy(feats), real=True)
    fid.update(torch.from_numpy(feats[:8]), real=False)
    score.update(torch.from_numpy(logits))
    before = [t.clone() for t in (*fid.real, *fid.fake, *score.stats)]
    fid.merge_across(world_of_one)
    score.merge_across(world_of_one)
    assert all(torch.equal(a, b) for a, b in zip(before, (*fid.real, *fid.fake, *score.stats)))
    assert isinstance(score.stats, ISStats)


@pytest.mark.parametrize("fsdp_min", [None, 16])
def test_fit_on_a_mesh_of_one_is_bitwise_without(world_of_one, fsdp_min):
    """``{data: -1}`` (and the fsdp layout, which splits nothing at fsdp = 1)
    in a world of one: the state after 3 steps is bitwise the run's without
    a mesh; the loop gathers nothing and the checkpoint is the same file."""
    def run(mesh):
        lit = LitDDPM(model=t_ddpm.UNet(**TINY, dropout=0.1), timesteps=10, warmup=2)
        return fit(lit, CIFAR10(synthetic=True, synthetic_size=16, batch_size=4), 3, seed=3,
                   log_every=100, mesh=mesh, device="cpu")

    mesh = world_of_one
    if fsdp_min is not None:
        mesh = parallel.make_mesh(fsdp=1, device="cpu", min_weight_size=fsdp_min)
    a, b = run(mesh), run(None)
    assert a.mesh is mesh and not a.shard_axes and b.mesh is None
    for x, y in ((a.params, b.params), (a.ema_params, b.ema_params),
                 (a.opt_state.mu, b.opt_state.mu), (a.opt_state.nu, b.opt_state.nu)):
        assert all(torch.equal(x[k], y[k]) for k in x)
