"""Checkpoints of a train state (mirrors ``dmme_tpu/training/checkpoint.py``).

The JAX package writes Orbax checkpoints; the port writes its own, and reads
no Orbax checkpoint. A checkpoint is ``<directory>/<step>/state.pt``, one
``torch.save`` of ``{step, params, ema_params, opt_state: {count, mu, nu}}``.
A save writes into a temporary directory beside it, flushes the file to
disk (``fsync``), renames the directory to ``<step>`` (``os.replace``) and
syncs the parent directory, so a checkpoint is whole or absent after a
crash of the process or of the machine. The
optimizer transformation and schedule are rebuilt from the harness, as in
JAX.

``restore`` copies into the given state's tensors in place, on their device,
under ``torch.no_grad()``: never ``inference_mode``, which leaves a tensor's
version as it is, and the fused ResBlock kernel's packed-weight cache keys
on that version (:func:`dmme_tpu_torch.ops.resblock.pack_weights`), so
sampling after a restore reads the restored weights.

On a mesh every rank calls ``save``: the ranks gather a sharded state
(fsdp, expert) whole, rank 0 writes the same files a run without a mesh
writes, and the others wait at a barrier (JAX leaves this to its
checkpoint library). Every rank restores, taking its shards, so a
checkpoint moves freely between runs with and without a mesh.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Dict, List, Optional

import torch

from dmme_tpu_torch.parallel.mesh import barrier, shard_of
from dmme_tpu_torch.training.state import TrainState

FILE = "state.pt"


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _pure(state: TrainState) -> dict:
    return {"step": int(state.step), "params": state.params, "ema_params": state.ema_params,
            "opt_state": {"count": int(state.opt_state.count), "mu": state.opt_state.mu,
                          "nu": state.opt_state.nu}}


@torch.no_grad()
def _copy_into(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor], what: str) -> None:
    if set(dst) != set(src):
        missing, extra = sorted(set(dst) - set(src)), sorted(set(src) - set(dst))
        raise ValueError(f"checkpoint {what} keys differ: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    for k, t in dst.items():
        if t.shape != src[k].shape:
            raise ValueError(f"checkpoint {what}[{k!r}] has shape {tuple(src[k].shape)}, "
                             f"the state {tuple(t.shape)}")
        t.copy_(src[k])


class CheckpointManager:
    """Numbered checkpoints under ``directory``, the newest ``max_to_keep``
    kept (``None`` keeps all); ``mesh``: the ranks that save together."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3, mesh=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.mesh = mesh
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> List[int]:
        """The saved steps, oldest first."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.isfile(os.path.join(self.directory, name,
                                                                        FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, *, force: bool = False) -> bool:
        """Write ``state`` as checkpoint ``step``. A step that is already saved
        is replaced only with ``force``; returns whether it wrote."""
        final = os.path.join(self.directory, str(int(step)))
        if self.mesh is None:
            return self._write(final, step, state, force)
        barrier(self.mesh)  # every rank sees the directory as it was
        wrote = not os.path.exists(final) or force
        if wrote:
            state = state.whole()
            if self.mesh.rank == 0:
                self._write(final, step, state, force)
        barrier(self.mesh)
        return wrote

    def _write(self, final: str, step: int, state: TrainState, force: bool) -> bool:
        if os.path.exists(final) and not force:
            return False
        tmp = tempfile.mkdtemp(prefix=f".{int(step)}-", dir=self.directory)
        try:
            with open(os.path.join(tmp, FILE), "wb") as f:
                torch.save(_pure(state), f)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
            if os.path.exists(final):  # forced: set the old one aside, then swap
                old = tempfile.mkdtemp(prefix=f".{int(step)}-old-", dir=self.directory)
                os.replace(final, os.path.join(old, "ckpt"))
                os.replace(tmp, final)
                shutil.rmtree(old, ignore_errors=True)
            else:
                os.replace(tmp, final)
            _fsync_dir(self.directory)
        finally:
            if os.path.exists(tmp):
                shutil.rmtree(tmp, ignore_errors=True)
        self._prune()
        return True

    def _prune(self) -> None:
        if self.max_to_keep is None:
            return
        for step in self.steps()[:-self.max_to_keep or None]:
            shutil.rmtree(os.path.join(self.directory, str(step)), ignore_errors=True)

    def load(self, step: Optional[int] = None) -> dict:
        """The saved dict of ``step`` (default: the latest), tensors on the CPU."""
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return torch.load(os.path.join(self.directory, str(step), FILE), map_location="cpu",
                          weights_only=True)

    def restore(self, state_like: TrainState, step: Optional[int] = None) -> TrainState:
        """Copy checkpoint ``step`` (default: the latest) into ``state_like``
        in place; returns it."""
        saved = self.load(step)
        if state_like.sharded:  # this rank's shards of the whole tensors
            for part in (saved["params"], saved["ema_params"], saved["opt_state"]["mu"],
                         saved["opt_state"]["nu"]):
                for k, a in state_like.expert_axes.items():
                    part[k] = shard_of(state_like.mesh, part[k], a, "expert")
                for k, a in state_like.tensor_axes.items():
                    part[k] = shard_of(state_like.mesh, part[k], a, "tensor")
                for k, a in state_like.shard_axes.items():
                    part[k] = shard_of(state_like.mesh, part[k], a)
        _copy_into(state_like.params, saved["params"], "params")
        _copy_into(state_like.ema_params, saved["ema_params"], "ema_params")
        _copy_into(state_like.opt_state.mu, saved["opt_state"]["mu"], "mu")
        _copy_into(state_like.opt_state.nu, saved["opt_state"]["nu"], "nu")
        state_like.opt_state.count = int(saved["opt_state"]["count"])
        state_like.step = int(saved["step"])
        return state_like

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open."""
