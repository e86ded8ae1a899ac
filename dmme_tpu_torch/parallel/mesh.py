"""The mesh and the sharding layout (mirrors ``dmme_tpu/parallel/mesh.py``).

JAX builds a device mesh, annotates shardings and lets XLA insert the
collectives. The port runs one process a device (PyTorch's idiom), so a
:class:`Mesh` is the ``torch.distributed`` process group seen through JAX's
axis sizes, and the collectives are written out (``parallel/train_step.py``):

* ``data``: data parallelism; the gradients are all-reduced.
* ``fsdp``: ZeRO sharding; each leaf of 2¹⁴ elements or more is split along
  the axis JAX's rule picks (:func:`fsdp_param_spec`), so a rank holds its
  shard of the parameters, the EMA and both Adam moments; the parameters
  are all-gathered for the forward and the gradients reduce-scattered.
* ``expert``: expert parallelism (GShard) for the MoE layers: each rank-3
  expert stack of a ``moe`` module (E, d_in, d_out) of 2¹⁴ elements or
  more is split along E when the axis divides it, so a rank holds E/P
  experts of its expert group (size P); the tokens of the group go to
  their experts and back by two all-to-alls a MoE layer
  (``models/moe.py``). The expert shards are never gathered for the
  forward. Each rank routes its own tokens as one routing group (its own
  capacity, balance and router losses), as JAX's accumulation routes a
  microbatch. A stack can carry both axes: ``expert`` on E and ``fsdp``
  on another axis, by JAX's rule.
* ``tensor``: tensor (channel) parallelism for the UNet and the DiT
  (Megatron's column split): each conv and Dense kernel, embedding table
  and MoE stack of 2¹⁴ elements or more whose last axis the axis divides
  (in JAX's layout) is split on it, so a rank of a tensor group (size T)
  holds 1/T of the output channels of each, with their EMA and moments;
  biases and GroupNorm affines stay whole. The T ranks share one batch
  slice; activations flow channel-split between them and are
  all-gathered before each layer that reads every channel
  (``parallel/tensor.py``, ``models/blocks.py``). The split weights are
  never gathered for the forward. A leaf can carry ``tensor`` on its
  output axis and ``fsdp`` on another, and a MoE stack ``expert`` on E.
* ``spatial``: spatial (sequence) parallelism for the UNet: the S ranks
  of a spatial group share one batch slice, and each holds H/S rows of
  every activation; the 3×3 convs exchange one halo row with each
  neighbour and the GroupNorms all-reduce their statistics over the group
  (``parallel/spatial.py``, ``models/blocks.py``). No leaf is ever split
  on it. It composes with every other axis. Beside ``tensor``, a rank
  holds its H/S rows of its C/T channel shard of each activation: the
  halos, row gathers and statistics all-reduces run over its spatial
  group (the ranks of its tensor index, so the same channels), the
  channel gathers over its tensor group (the ranks of its rows). Beside
  ``expert``, a UNet has no leaf the axis splits (JAX's rule needs
  ``moe`` in the path), so ``expert`` is one more batch axis there; the
  MoE-DiT has no H-split forward yet (ROADMAP A.11).

Rank r sits at (d, f, e, t, s) of the (data, fsdp, expert, tensor,
spatial) grid, row-major, as JAX reshapes its device list, so a tensor
group is T consecutive ranks and a spatial group S. Its batch index is its
(d, f, e) coordinate: it takes that slice of the global batch, which is
split over data × fsdp × expert (the batch ranks), and draws as that batch
rank. A spec
is JAX's ``PartitionSpec`` as a tuple, in the port's layout: a mesh-axis
name (or a tuple of them) or None per tensor axis, ``()`` for a whole
(replicated) leaf.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from dmme_tpu_torch.parallel import distributed
from dmme_tpu_torch.utils.device import resolve_device

AXES = ("data", "fsdp", "expert", "tensor", "spatial")
#: JAX's threshold: smaller leaves stay whole (their all-gather costs more than it saves)
MIN_WEIGHT_SIZE = 2**14
#: elements a bucket of a flattened collective holds at most (64 MiB of f32)
BUCKET = 1 << 24
#: modules whose 2-D ``weight`` is an embedding table, kept in flax's layout
#: (``utils/convert.py``); every other 2-D ``weight`` is a Dense kernel transposed
_EMBEDDINGS = ("class_embed", "label_emb")


def mesh_shape(n: int, data: int = -1, fsdp: int = 1, tensor: int = 1, spatial: int = 1,
               expert: int = 1) -> Dict[str, int]:
    """JAX's axis sizes of a mesh over ``n`` devices (``data=-1`` absorbs
    the rest), with its assertions and messages."""
    if data == -1:
        assert n % (fsdp * expert * tensor * spatial) == 0, (
            n, fsdp, expert, tensor, spatial,
        )
        data = n // (fsdp * expert * tensor * spatial)
    assert data * fsdp * expert * tensor * spatial == n, (
        f"mesh {data}x{fsdp}x{expert}x{tensor}x{spatial} != {n} devices"
    )
    return {"data": data, "fsdp": fsdp, "expert": expert, "tensor": tensor, "spatial": spatial}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A process group seen as JAX's ``(data, fsdp, expert, tensor, spatial)``
    mesh: this rank, its device and the groups its collectives run in
    (None: the whole world)."""

    shape: Mapping[str, int]
    rank: int
    device: torch.device
    backend: str
    #: leaves smaller than this stay whole under fsdp (JAX's ``min_weight_size``)
    min_weight_size: int = MIN_WEIGHT_SIZE
    #: whether :func:`make_mesh` made the process group (and its owner shuts it down)
    owns_group: bool = False
    #: the groups of the ranks that differ from this one only along the
    #: named axes (:data:`GROUPS`); None where such a group is the world,
    #: or this rank alone (then no collective runs over it)
    fsdp_group: Any = None
    expert_group: Any = None
    tensor_group: Any = None
    spatial_group: Any = None
    #: {axes: group} of every set of grid axes a split leaf's replicas
    #: differ along (:func:`replica_axes`), None as above
    replica_groups: Mapping[Tuple[str, ...], Any] = dataclasses.field(default_factory=dict)
    #: a gloo group for the host's flags where the backend is NCCL
    control_group: Any = None

    @property
    def world(self) -> int:
        n = 1
        for axis in AXES:
            n *= self.shape[axis]
        return n

    @property
    def fsdp(self) -> int:
        return self.shape["fsdp"]

    @property
    def expert(self) -> int:
        return self.shape["expert"]

    @property
    def tensor(self) -> int:
        return self.shape["tensor"]

    @property
    def spatial(self) -> int:
        return self.shape["spatial"]

    @property
    def batch_ranks(self) -> int:
        """The ranks the batch is split over: data × fsdp × expert."""
        return self.shape["data"] * self.shape["fsdp"] * self.shape["expert"]

    @property
    def batch_index(self) -> int:
        """This rank's place among the batch ranks, its (data, fsdp, expert)
        coordinate row-major: the slice of the global batch it takes and
        the batch rank it draws as (its tensor and spatial groups share both)."""
        return self.rank // (self.shape["tensor"] * self.shape["spatial"])

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (a name of :data:`GRID`)."""
        return _coords(self.shape, self.rank)[axis]

    @property
    def fsdp_index(self) -> int:
        return self.index("fsdp")

    def size(self, *axes: str) -> int:
        return math.prod(self.shape[a] for a in axes)

    def replicas(self, axes: Tuple[str, ...]):
        """The group of the ranks that differ from this one along ``axes``
        (:func:`replica_axes`; None: the world, or this rank alone)."""
        return self.replica_groups.get(_varying(self.shape, axes))


def make_mesh(devices: Optional[Sequence[int]] = None, data: int = -1, fsdp: int = 1,
              tensor: int = 1, spatial: int = 1, expert: int = 1, *, device=None,
              min_weight_size: int = MIN_WEIGHT_SIZE) -> Mesh:
    """The ``(data, fsdp, expert, tensor, spatial)`` mesh over the process
    group, ``data=-1`` absorbing the rest. Without a group it first joins
    one (:func:`~dmme_tpu_torch.parallel.distributed.initialize`: a world of
    1 on a single process without a launcher), and the mesh then owns it.
    ``devices`` is None or the group's ranks in order: the port's mesh spans
    the whole group. ``device``: the rank's device (None: its card)."""
    owns = not dist.is_initialized()
    if owns:
        device = distributed.initialize(device=device)
    else:
        device = resolve_device(device)
    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        if devices is not None and list(devices) != list(range(world)):
            raise ValueError(f"the port's mesh spans the whole process group: devices must be "
                             f"None or its ranks 0..{world - 1} in order, got {list(devices)}")
        shape = mesh_shape(world, data, fsdp, tensor, spatial, expert)
        backend = dist.get_backend()
        groups = _groups(shape, rank, backend)
    except BaseException:
        if owns:
            distributed.shutdown()
        raise
    return Mesh(shape=shape, rank=rank, device=device, backend=backend,
                min_weight_size=min_weight_size, owns_group=owns, **groups)


#: the axes of the grid a rank sits on, row-major (spatial innermost)
GRID = ("data", "fsdp", "expert", "tensor", "spatial")
#: the axes that split leaves (``spatial`` splits activations only)
SPLITTING = ("fsdp", "expert", "tensor")
#: {Mesh field: the axes along which its ranks differ}
GROUPS = {"fsdp_group": ("fsdp",), "expert_group": ("expert",), "tensor_group": ("tensor",),
          "spatial_group": ("spatial",)}


def replica_axes(split: Sequence[str]) -> Tuple[str, ...]:
    """The grid axes along which the ranks holding the same shard of a leaf
    differ: every axis but the ``split`` ones that split it."""
    return tuple(a for a in GRID if a not in split)


def _varying(shape: Mapping[str, int], axes: Sequence[str]) -> Tuple[str, ...]:
    return tuple(a for a in GRID if a in axes and shape[a] > 1)


def _coords(shape: Mapping[str, int], rank: int) -> Dict[str, int]:
    """``rank``'s coordinates on :data:`GRID`, row-major."""
    out = {}
    for axis in reversed(GRID):
        rank, out[axis] = divmod(rank, shape[axis])
    return out


def _rank(shape: Mapping[str, int], coords: Mapping[str, int]) -> int:
    r = 0
    for axis in GRID:
        r = r * shape[axis] + coords[axis]
    return r


def _groups(shape: Mapping[str, int], rank: int, backend: str) -> dict:
    """The groups of :data:`GROUPS` and the replica groups of every split
    (each set of splitting axes) that hold ``rank`` (None where a group is
    the world or the rank alone), and the control group; every rank makes
    every group, in the same order."""
    world = math.prod(shape[a] for a in GRID)
    made = {}
    wanted = list(GROUPS.values()) + [replica_axes(split) for n in range(len(SPLITTING) + 1)
                                      for split in itertools.combinations(SPLITTING, n)]
    for axes in wanted:
        varying = _varying(shape, axes)
        if not varying or math.prod(shape[a] for a in varying) == world or varying in made:
            continue  # the rank alone, the world, or a group already made for the same ranks
        fixed = [a for a in GRID if a not in varying]
        for at in itertools.product(*(range(shape[a]) for a in fixed)):
            ranks = [_rank(shape, dict(zip(fixed, at), **dict(zip(varying, v))))
                     for v in itertools.product(*(range(shape[a]) for a in varying))]
            group = dist.new_group(sorted(ranks))
            if rank in ranks:
                made[varying] = group
    out = {name: made.get(_varying(shape, axes)) for name, axes in GROUPS.items()}
    out["replica_groups"] = made
    if backend != "gloo" and world > 1:
        out["control_group"] = dist.new_group(backend="gloo")
    return out


def batch_sharding(mesh: Mesh, chunked: bool = False, ndim: Optional[int] = None,
                   shape: Optional[Sequence[int]] = None) -> tuple:
    """JAX's spec of a batch leaf: the batch axis split over data × fsdp,
    and × expert where that axis is above 1 (axis 1 of ``chunked`` (steps,
    batch, …) inputs); with a ``spatial`` axis above 1, the H axis of an
    image leaf split over it too. ``shape`` tells an image leaf by JAX's
    gate: trailing (H, W, C) with C ≤ 16, H divisible by the spatial size
    and at least two rows a shard; ``ndim`` alone (JAX's legacy form) by
    its rank. The port's step takes whole images on each rank of a spatial
    group and splits the rows inside the model (``parallel/spatial.py``)."""
    spec = ((None,) if chunked else ()) + (
        ("data", "fsdp", "expert") if mesh.shape.get("expert", 1) > 1 else ("data", "fsdp"),)
    spatial = mesh.shape.get("spatial", 1)
    if spatial > 1:
        if shape is not None:
            image = (len(shape) >= len(spec) + 3 and shape[-1] <= 16
                     and shape[-3] % spatial == 0 and shape[-3] >= 2 * spatial)
        else:
            image = ndim is not None and ndim >= len(spec) + 3
        if image:
            spec = spec + ("spatial",)
    return spec


def replicated(mesh: Mesh) -> tuple:
    return ()


def jax_axes(path: str, ndim: int) -> Tuple[int, ...]:
    """The port's axis of each axis of the leaf in JAX's layout: conv
    kernels HWIO ↔ OIHW, Dense kernels (in, out) ↔ (out, in), everything
    else (biases, GroupNorm scales, embedding tables, MoE stacks) as is."""
    module, _, name = path.rpartition(".")
    if name == "weight" and ndim == 4:
        return (2, 3, 1, 0)
    if name == "weight" and ndim == 2 and module.rpartition(".")[2] not in _EMBEDDINGS:
        return (1, 0)
    return tuple(range(ndim))


def fsdp_param_spec(shape: Sequence[int], mesh, min_weight_size: int = MIN_WEIGHT_SIZE,
                    path: str = "") -> tuple:
    """The spec of one parameter of the port's layout, named ``path`` as in
    the ``state_dict``: JAX's decision on the leaf in JAX's layout
    (``dmme_tpu/parallel/mesh.py:fsdp_param_spec``) carried through
    :func:`jax_axes`. Under fsdp a leaf of ``min_weight_size`` elements or
    more is split along its largest axis that the fsdp size divides, the
    last of equals. ``mesh`` is anything with JAX's ``shape`` mapping."""
    sizes = mesh.shape
    tensor_size, fsdp_size, expert_size = (sizes.get(a, 1) for a in ("tensor", "fsdp", "expert"))
    perm = jax_axes(path, len(shape))
    jshape = [shape[p] for p in perm]
    total = 1
    for s in shape:
        total *= int(s)
    if total < min_weight_size:
        return ()
    spec: List[Optional[str]] = [None] * len(jshape)
    ep_axis = tp_axis = None
    if expert_size > 1 and len(jshape) == 3 and jshape[0] % expert_size == 0 \
            and "moe" in path.lower():
        ep_axis, spec[0] = 0, "expert"
    if tensor_size > 1 and len(jshape) >= 2 and jshape[-1] % tensor_size == 0:
        tp_axis = len(jshape) - 1
        spec[tp_axis] = "tensor"
    if fsdp_size > 1:
        order = sorted(range(len(jshape)), key=lambda i: (jshape[i], i), reverse=True)
        for i in order:
            if i not in (tp_axis, ep_axis) and jshape[i] % fsdp_size == 0:
                spec[i] = "fsdp"
                break
    if all(s is None for s in spec):
        return ()
    out: List[Optional[str]] = [None] * len(shape)
    for i, p in enumerate(perm):
        out[p] = spec[i]
    return tuple(out)


def params_sharding(params: Mapping[str, torch.Tensor], mesh,
                    min_weight_size: int = MIN_WEIGHT_SIZE) -> Dict[str, tuple]:
    """{name: spec} of a ``state_dict`` (fsdp-aware)."""
    return {k: fsdp_param_spec(tuple(v.shape), mesh, min_weight_size, path=k)
            for k, v in params.items()}


def state_sharding(state, mesh, min_weight_size: int = MIN_WEIGHT_SIZE) -> dict:
    """The specs of a train state in the structure of its checkpoint:
    parameters, EMA and Adam moments follow the fsdp layout; the counters
    are whole."""
    specs = params_sharding(state.params, mesh, min_weight_size)
    return {"step": (), "params": specs, "ema_params": dict(specs),
            "opt_state": {"count": (), "mu": dict(specs), "nu": dict(specs)}}


def split_axes(params: Mapping[str, torch.Tensor], mesh: Mesh,
               min_weight_size: Optional[int] = None, axis: str = "fsdp") -> Dict[str, int]:
    """{name: the tensor axis it is split along} of the leaves that the
    mesh axis ``axis`` (``fsdp``, ``expert`` or ``tensor``) splits."""
    if mesh.shape[axis] == 1:
        return {}
    size = mesh.min_weight_size if min_weight_size is None else min_weight_size
    return {k: spec.index(axis) for k, spec in params_sharding(params, mesh, size).items()
            if axis in spec}


def expert_axes(params: Mapping[str, torch.Tensor], mesh: Mesh,
                min_weight_size: Optional[int] = None) -> Dict[str, int]:
    """{name: the tensor axis it is split along} of the expert stacks the
    ``expert`` axis splits (axis 0, E), by JAX's rule."""
    return split_axes(params, mesh, min_weight_size, "expert")


def tensor_axes(params: Mapping[str, torch.Tensor], mesh: Mesh,
                min_weight_size: Optional[int] = None) -> Dict[str, int]:
    """{name: the tensor axis it is split along} of the leaves the
    ``tensor`` axis splits: the output axis of each conv and Dense kernel
    and the features of each embedding table, by JAX's rule."""
    return split_axes(params, mesh, min_weight_size, "tensor")


# --------------------------------------------------------------- collectives


def agree(mesh: Mesh, flags: Sequence[bool]) -> List[bool]:
    """Each flag OR-ed over the world, on the host (the safe points' vote)."""
    t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.control_group)
    return [bool(v) for v in t.tolist()]


def barrier(mesh: Mesh) -> None:
    """Wait for every rank (nothing to wait for in a world of 1)."""
    if mesh.world > 1:
        dist.barrier(group=mesh.control_group)


def _buckets(tensors: Sequence[torch.Tensor]):
    """Indices of ``tensors`` in runs of one dtype of at most ``BUCKET`` elements."""
    run, size, dtype = [], 0, None
    for i, t in enumerate(tensors):
        if run and (t.dtype != dtype or size + t.numel() > BUCKET):
            yield run
            run, size = [], 0
        run.append(i)
        size += t.numel()
        dtype = t.dtype
    if run:
        yield run


def _copy_back(flat: torch.Tensor, tensors: Sequence[torch.Tensor], run) -> None:
    """``flat``'s pieces into the tensors of ``run``, in one multi-tensor copy
    (the host issues one launch, not one a tensor)."""
    pieces = flat.split([tensors[i].numel() for i in run])
    torch._foreach_copy_([tensors[i] for i in run],
                         [p.view(tensors[i].shape) for i, p in zip(run, pieces)])


def flat_all_reduce(tensors: Sequence[torch.Tensor], divisor: float = 1.0, group=None) -> None:
    """Sum ``tensors`` over ``group`` and divide by ``divisor``, in place,
    through flat buckets (one collective a bucket). The results go back
    into the tensors themselves: the optimizer's multi-tensor kernels then
    see the buffers (and alignments) they see without a mesh, and round
    alike."""
    for run in _buckets(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in run])
        dist.all_reduce(flat, group=group)
        if divisor != 1.0:
            flat.div_(divisor)
        _copy_back(flat, tensors, run)


def broadcast_(tensors: Sequence[torch.Tensor]) -> None:
    """Rank 0's values into every rank's ``tensors``, in place, in flat buckets."""
    for run in _buckets(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in run])
        dist.broadcast(flat, 0)
        _copy_back(flat, tensors, run)


def shard_of(mesh: Mesh, full: torch.Tensor, axis: int, along: str = "fsdp") -> torch.Tensor:
    """This rank's shard of ``full`` on the mesh axis ``along``: chunk
    ``mesh.index(along)`` of tensor axis ``axis``, contiguous."""
    return full.chunk(mesh.shape[along], dim=axis)[mesh.index(along)].contiguous()


def gather_leaves(mesh: Mesh, shards: Mapping[str, torch.Tensor],
                  axes: Mapping[str, int], along: str = "fsdp") -> Dict[str, torch.Tensor]:
    """The tensors of the leaves ``axes`` names, all-gathered along the
    mesh axis ``along`` (over its group) in flat buckets (every rank calls it)."""
    names = [k for k in shards if k in axes]
    n = mesh.shape[along]
    out = {}
    for run in _buckets([shards[k] for k in names]):
        keys = [names[i] for i in run]
        mine = torch.cat([shards[k].reshape(-1) for k in keys])
        rows = torch.empty((n, mine.numel()), dtype=mine.dtype, device=mine.device)
        dist.all_gather(list(rows.unbind(0)), mine, group=getattr(mesh, f"{along}_group"))
        sizes = [shards[k].numel() for k in keys]
        pieces = [row.split(sizes) for row in rows.unbind(0)]
        for j, k in enumerate(keys):
            shape = shards[k].shape
            out[k] = torch.cat([p[j].view(shape) for p in pieces], dim=axes[k])
    return out


def scatter_leaves(mesh: Mesh, fulls: Mapping[str, torch.Tensor],
                   axes: Mapping[str, int]) -> Dict[str, torch.Tensor]:
    """This rank's shard of each split leaf of ``fulls``, summed over the
    fsdp group (a reduce-scatter a flat bucket)."""
    names = [k for k in fulls if k in axes]
    out = {}
    for run in _buckets([fulls[k] for k in names]):
        keys = [names[i] for i in run]
        chunks = [fulls[k].chunk(mesh.fsdp, dim=axes[k]) for k in keys]
        rows = torch.stack([torch.cat([c[f].reshape(-1) for c in chunks])
                            for f in range(mesh.fsdp)])
        mine = torch.empty_like(rows[0])
        dist.reduce_scatter(mine, list(rows.unbind(0)), group=mesh.fsdp_group)
        for k, c, piece in zip(keys, chunks, mine.split([c[mesh.fsdp_index].numel()
                                                         for c in chunks])):
            out[k] = piece.view(c[mesh.fsdp_index].shape)
    return out
