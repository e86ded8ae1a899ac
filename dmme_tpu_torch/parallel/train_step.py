"""The train step (mirrors ``dmme_tpu/parallel/train_step.py``).

JAX compiles the step with ``jit`` and donates the state; here the step
runs eagerly and updates the state in place (see
:mod:`dmme_tpu_torch.training.state`). A loss function is
``loss_fn(params, generator, batch) -> scalar``; every random draw of a
step comes from one ``torch.Generator`` on the batch's device, seeded from
the run seed and the state's step, as ``fold_in(rng, state.step)`` seeds
JAX's, so a resumed run can reproduce the stream.

On a mesh (:mod:`dmme_tpu_torch.parallel.mesh`) each rank steps on its
slice of the global batch, and the collectives JAX's partitioner inserts
are written out. ``data``: the gradients and the loss are all-reduced in
flat buckets and divided by the batch ranks R, so every rank clips and
steps on the same gradients. ``fsdp``: the split leaves are all-gathered
for the forward and their gradients reduce-scattered; Adam and the EMA run
on the shard. ``expert``: the MoE layers run on the rank's expert shards
(never gathered; their all-to-alls bring the expert group's tokens), so a
shard's gradient already sums its group's tokens and is summed only over
the ranks that hold the same shard. ``tensor``: the UNet and the DiT run
on channel shards (``parallel/tensor.py``); a split kernel's gradient is its shard's
whole gradient, summed over its replicas only, and a whole leaf's is a
partial sum over the tensor group, which the world all-reduce completes;
the loss, alike on the T ranks of a group, is divided by T before that
all-reduce. ``spatial``: the UNet runs on the rank's rows of each
activation (``parallel/spatial.py``); no leaf is split on it, so every
gradient is a partial sum over the spatial group that the same
all-reduces complete (a split leaf's replicas include the spatial ranks),
and the loss is divided by S as by T. The axes compose: on ``tensor``
and ``spatial`` together a rank runs on its rows of its channel shards
(halos, row gathers and statistics all-reduces over its spatial group,
channel gathers over its tensor group), a split kernel's gradient is the
part its rows give, summed over its replicas (the spatial ranks among
them), every whole leaf's a partial sum over the T·S ranks of its batch
slice, and the loss is divided by T·S; ``expert`` beside ``spatial``
splits no UNet leaf and is one more batch axis. The clip's norm counts
each distinct shard once. A rank cannot draw dropout or router noise over the
global batch as JAX's one program does, so batch rank r of R
(``Mesh.batch_index``, shared by a tensor group and by a spatial group)
draws as microbatch r of an accumulated step
(:func:`microbatch_generators`), and routes its own tokens as one routing
group: R batch ranks at global batch B compute what one process computes
at batch B/R with ``accumulate_grad_batches=R``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from dmme_tpu_torch.models.moe import ExpertGroup, place_experts
from dmme_tpu_torch.parallel.mesh import (broadcast_, expert_axes, flat_all_reduce,
                                          gather_leaves, replica_axes, scatter_leaves, shard_of,
                                          split_axes, tensor_axes)
from dmme_tpu_torch.parallel.spatial import SpatialGroup
from dmme_tpu_torch.parallel.tensor import TensorGroup

LossFn = Callable[[Dict[str, torch.Tensor], torch.Generator, Any], torch.Tensor]


def _device(batch) -> torch.device:
    return (batch[0] if isinstance(batch, (tuple, list)) else batch).device


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step`` of the run seeded ``seed``: its seed
    mixes both numbers (numpy's SeedSequence), so neighbouring steps and
    neighbouring runs get unrelated streams."""
    mixed = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(mixed & ((1 << 63) - 1))


def microbatch_generators(generator: torch.Generator, k: int):
    """The k generators of a step's microbatches, each seeded from the step
    generator's seed and the microbatch's index (no draw from it, so no
    device read)."""
    return [step_generator(generator.initial_seed(), j, generator.device) for j in range(k)]


def make_train_step(loss_fn: LossFn, debug_nans: bool = False, mesh=None):
    """``step(state, batch, seed) -> (state, metrics)``: the loss and its
    gradient with respect to every parameter, one optimizer step in place,
    and the metrics ``loss`` and ``grad_norm`` (the norm before clipping) as
    0-dim tensors on the device, read by the caller when it logs. A
    ``loss_fn`` marked ``is_grad_fn`` returns ``(loss, grads)`` itself
    (gradient accumulation; on a mesh it draws each rank's microbatches
    itself). With ``debug_nans`` the step reads both metrics and raises
    ``FloatingPointError``, before the update, where one is not finite.
    ``mesh``: the state is :func:`shard_state`'s and ``batch`` this rank's
    slice; loss and gradients are the global batch's."""
    is_grad_fn = getattr(loss_fn, "is_grad_fn", False)

    def step(state, batch, seed: int):
        generator = step_generator(seed, state.step, _device(batch))
        if mesh is not None and mesh.batch_ranks > 1 and not is_grad_fn:
            generator = microbatch_generators(generator, mesh.batch_ranks)[mesh.batch_index]
        whole = state.params
        if state.shard_axes:
            whole = dict(whole, **gather_leaves(mesh, whole, state.shard_axes))
        params = {k: v.detach().requires_grad_(True) for k, v in whole.items()}
        del whole
        if is_grad_fn:
            loss, grads = loss_fn(params, generator, batch)
        else:
            with torch.enable_grad():
                loss = loss_fn(params, generator, batch)
                grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        del params
        loss = loss.detach()
        if mesh is None:
            norm = global_norm(grads.values())
        else:
            loss, grads = reduce_gradients(mesh, loss, grads, state.split)
            norm = sharded_norm(mesh, grads, state.split)
        metrics = {"loss": loss, "grad_norm": norm}
        if debug_nans and not all(bool(torch.isfinite(v)) for v in metrics.values()):
            raise FloatingPointError(
                f"step {state.step + 1}: loss {float(metrics['loss'])}, grad_norm "
                f"{float(metrics['grad_norm'])} (debug_nans; the state is not updated)")
        state.apply_gradients(grads, norm if state.sharded else None)
        return state, metrics

    return step


def reduce_gradients(mesh, loss: torch.Tensor, grads: Dict[str, torch.Tensor],
                     split: Dict[str, Dict[str, int]]):
    """The global batch's loss and gradients from this rank's, all divided
    by the batch ranks: every whole leaf and the loss (divided by the
    tensor and spatial sizes first: the ranks of such a group compute it
    alike) all-reduced
    over the world in flat buckets (in place); every fsdp-split leaf
    reduce-scattered over the fsdp group; then each split leaf summed over
    the replicas of its shard (an expert shard's gradient already holds its
    expert group's tokens, a tensor shard's its group's whole gradient).
    ``split``: {mesh axis: {name: axis}} of the split leaves
    (``TrainState.split``). Returns (loss, grads) with the fsdp leaves as
    this rank's shards."""
    ranks = float(mesh.batch_ranks)
    loss = loss.reshape(1) / (mesh.tensor * mesh.spatial)
    flat_all_reduce([g for k, g in grads.items() if not _splitting(k, split)] + [loss],
                    divisor=ranks)
    if split["fsdp"]:
        grads = dict(grads, **scatter_leaves(mesh, grads, split["fsdp"]))
    by_replicas: Dict[tuple, list] = {}
    for k in grads:
        if _splitting(k, split):
            by_replicas.setdefault(_replicas(k, split), []).append(k)
    for axes, names in by_replicas.items():
        if mesh.size(*axes) > 1:
            flat_all_reduce([grads[k] for k in names], group=mesh.replicas(axes))
        for k in names:
            grads[k].div_(ranks)
    return loss.reshape(()), grads


def _splitting(name: str, split) -> tuple:
    """The mesh axes that split leaf ``name``."""
    return tuple(axis for axis, names in split.items() if name in names)


def _replicas(name: str, split) -> tuple:
    """The grid axes along which the ranks holding the same shard of split
    leaf ``name`` differ."""
    return replica_axes(_splitting(name, split))


def make_train_chunk(loss_fn: LossFn, steps: int, debug_nans: bool = False, mesh=None):
    """``chunk(state, batches, seed) -> (state, metrics)`` over ``batches``
    stacked on a leading axis of length ``steps``: the steps in order, with
    each metric stacked likewise. JAX scans the steps inside one program;
    here it is a Python loop over the same step."""
    step = make_train_step(loss_fn, debug_nans, mesh)

    def chunk(state, batches, seed: int):
        if isinstance(batches, (tuple, list)):
            per_step = [tuple(b[i] for b in batches) for i in range(steps)]
        else:
            per_step = [batches[i] for i in range(steps)]
        metrics = []
        for batch in per_step:
            state, m = step(state, batch, seed)
            metrics.append(m)
        return state, {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}

    return chunk


def make_eval_step(loss_fn: LossFn):
    """``step(params, batch, generator) -> loss`` with no gradient and no update."""

    def step(params, batch, generator: torch.Generator):
        with torch.no_grad():
            return loss_fn(params, generator, batch)

    return step


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """ℓ2 norm over all elements of all tensors, in f32, on their device."""
    norms = torch._foreach_norm([t.to(torch.float32) for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def sharded_norm(mesh, grads: Dict[str, torch.Tensor],
                 split: Dict[str, Dict[str, int]]) -> torch.Tensor:
    """:func:`global_norm` of the whole gradients, of which the split leaves
    are this rank's shards: their squares summed over the world (one
    all-reduce), each distinct shard counted once (by the first of its
    replicas), the whole leaves' added once."""
    parted = {k for k in grads if _splitting(k, split)}
    if not parted:
        return global_norm(grads.values())
    mine = [g for k, g in grads.items() if k in parted
            and all(mesh.index(a) == 0 for a in _replicas(k, split))]
    sq = (global_norm(mine).square() if mine
          else torch.zeros((), dtype=torch.float32, device=grads[next(iter(parted))].device))
    sq = sq.reshape(1)
    flat_all_reduce([sq])
    whole = [g for k, g in grads.items() if k not in parted]
    if whole:
        sq = sq + global_norm(whole).square()
    return sq.sqrt().reshape(())


def shard_state(state, mesh, min_weight_size: Optional[int] = None, model=None):
    """Lay ``state`` out on ``mesh``, in place: rank 0's parameters, EMA and
    Adam moments broadcast to every rank, then each split leaf replaced by
    this rank's shard: its expert shard (the ``expert`` axis, by JAX's rule:
    :func:`~dmme_tpu_torch.parallel.mesh.expert_axes`) or its tensor shard
    (:func:`~dmme_tpu_torch.parallel.mesh.tensor_axes`), then its fsdp
    shard of that (:func:`~dmme_tpu_torch.parallel.mesh.split_axes`;
    ``min_weight_size`` defaults to the mesh's). ``model``: the module the
    params bind to, whose MoE layers learn where their experts live and
    whose UNet or DiT learns its ``TensorGroup``, and whose UNet its
    ``SpatialGroup``, both where the mesh has both axes (an expert mesh
    that splits a stack, and any tensor or spatial mesh, need it; a model
    without a tensor-parallel or an H-split forward raises there, before
    the state changes: the MoE-DiT on an ``{expert, spatial}`` mesh too).
    Returns the state."""
    experts = expert_axes(state.params, mesh, min_weight_size)
    tensors = tensor_axes(state.params, mesh, min_weight_size)
    axes = split_axes(state.params, mesh, min_weight_size)
    if model is None and (experts or mesh.tensor > 1):
        raise ValueError(f"the {'expert' if experts else 'tensor'} axis splits "
                         f"{len(experts or tensors)} leaves: pass the model (shard_state(..., "
                         "model=)) so that its layers learn where their shards live")
    if mesh.spatial > 1 and not hasattr(model, "place_spatial"):
        raise NotImplementedError(
            f"mesh axis spatial={mesh.spatial}: {type(model).__name__} has no H-split forward "
            "yet (the UNet has one; ADM's UNetModel, the noisy classifier's EncoderUNet, the "
            "codec's ConvVAE, the DiT and the MoE-DiT have none; ROADMAP A.11, distribution)")
    if mesh.tensor > 1 and not hasattr(model, "place_tensor"):
        raise NotImplementedError(
            f"mesh axis tensor={mesh.tensor}: {type(model).__name__} has no tensor-parallel "
            "forward yet (ADM's UNetModel, the noisy classifier's EncoderUNet and the codec's "
            "ConvVAE have none; ROADMAP A.11, distribution)")
    if model is not None:
        if mesh.spatial > 1:
            model.place_spatial(SpatialGroup(mesh.spatial_group, mesh.spatial,
                                             mesh.index("spatial")))
            if mesh.rank == 0:
                print(f"[shard_state] activations split along H over {mesh.spatial} spatial "
                      f"ranks; halos and statistics over {mesh.backend}", flush=True)
        if mesh.tensor > 1:
            model.place_tensor(TensorGroup(mesh.tensor_group, mesh.tensor,
                                           mesh.index("tensor")), tensors)
            if mesh.rank == 0:
                print(f"[shard_state] {len(tensors)} leaves split over {mesh.tensor} tensor "
                      f"ranks; activations gathered over {mesh.backend}", flush=True)
        where = None
        if experts:
            where = ExpertGroup(mesh.expert_group, mesh.expert, mesh.index("expert"))
            if mesh.rank == 0:
                print(f"[shard_state] {len(experts)} expert stacks split over {mesh.expert} "
                      f"ranks; all-to-all over {mesh.backend}, direct on {mesh.device.type} "
                      "tensors", flush=True)
        place_experts(model, where)
    parts = [state.params, state.ema_params, state.opt_state.mu, state.opt_state.nu]
    if mesh.world > 1:
        broadcast_([t for part in parts for t in part.values()])
    for part in parts:
        for k, a in experts.items():
            part[k] = shard_of(mesh, part[k], a, "expert")
        for k, a in tensors.items():
            part[k] = shard_of(mesh, part[k], a, "tensor")
        for k, a in axes.items():
            part[k] = shard_of(mesh, part[k], a)
    state.mesh, state.shard_axes, state.expert_axes = mesh, axes, experts
    state.tensor_axes = tensors
    return state


def shard_batch(batch, mesh, chunked: bool = False):
    """This rank's slice of a GLOBAL batch (numpy arrays or tensors, or a
    tuple of them): the batch axis (axis 1 if ``chunked``) split over the
    batch ranks, slice ``mesh.batch_index``, on the rank's device."""
    if isinstance(batch, tuple):
        return tuple(shard_batch(b, mesh, chunked) for b in batch)
    t = torch.as_tensor(batch)
    part = t.chunk(mesh.batch_ranks, dim=1 if chunked else 0)[mesh.batch_index]
    return part.contiguous().to(mesh.device)
