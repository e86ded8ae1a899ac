"""Multi-process self-check: several ranks on the CPU without a cluster
(mirrors ``dmme_tpu/parallel/mp_check.py``).

N fresh processes join one gloo group (:func:`~dmme_tpu_torch.parallel.initialize`),
each ``fit``s a tiny UNet on synthetic CIFAR-10 with ``mesh=make_mesh()``
(its slice of every global batch, the gradients reduced over the ranks),
then prints a probe: a fixed-generator loss on its gathered parameters, so
equal probes mean equal parameters. The invariants:

* every rank's probe is bitwise the same;
* at N = 2 the ``data`` run's probe is bitwise that of one process at half
  the batch with ``accumulate_grad_batches=2`` (rank r draws as microbatch
  r; an all-reduce of two summands is the accumulation's sum);
* an ``fsdp=2`` run (every leaf of 16 elements or more split) is within
  1e-6 relative of the ``data`` run.

Run the check: ``python -m dmme_tpu_torch.parallel.mp_check [--nproc 2]``.
Worker entry: ``python -m dmme_tpu_torch.parallel.mp_check worker <pid>
<nproc> <port> <steps> <fsdp> <accumulate>``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List

from dmme_tpu_torch.parallel.distributed import free_port

#: the tiny UNet of the JAX check (2 depths, no attention), T = 5, a global batch of 8
UNET = dict(pos_dim=4, emb_dim=8, num_groups=2, channels_per_depth=(4, 8), num_blocks=1,
            attention_depths=())
GLOBAL_BATCH = 8
#: the fsdp run splits every leaf of this many elements or more
FSDP_MIN_WEIGHT_SIZE = 16
PROBE_RTOL = 1e-6


def worker(pid: int, nproc: int, port: int, steps: int = 3, fsdp: int = 1,
           accumulate: int = 1) -> float:
    """One process's fit and probe. Runs in a fresh interpreter."""
    t0 = time.monotonic()

    def log(msg: str) -> None:
        # stderr, flushed: a hung worker's last lines say where it hung
        print(f"[mp_check p{pid} {time.monotonic() - t0:6.1f}s] {msg}", file=sys.stderr,
              flush=True)

    import torch

    torch.set_num_threads(1)
    from dmme_tpu_torch.data import CIFAR10
    from dmme_tpu_torch.models import ddpm as ddpm_models
    from dmme_tpu_torch.parallel import initialize, make_mesh, shutdown
    from dmme_tpu_torch.training import LitDDPM, fit
    from dmme_tpu_torch.utils.norm import norm

    mesh = None
    if nproc > 1:
        log("initialize ...")
        initialize(f"localhost:{port}", nproc, pid, device="cpu")
        mesh = make_mesh(fsdp=fsdp, device="cpu", min_weight_size=FSDP_MIN_WEIGHT_SIZE)
        log(f"mesh {dict(mesh.shape)}")
    lit = LitDDPM(model=ddpm_models.UNet(**UNET), timesteps=5)
    dm = CIFAR10(synthetic=True, synthetic_size=32, batch_size=GLOBAL_BATCH // accumulate,
                 horizontal_flip=False)
    log("fit ...")
    state = fit(lit, dm, max_steps=steps, seed=0, mesh=mesh, log_every=100,
                accumulate_grad_batches=accumulate, device="cpu")
    params = state.whole().params
    log("fit done; probe ...")
    batch = norm(torch.from_numpy(dm.train_data[:16]).to(torch.float32) / 255.0)
    with torch.no_grad():
        loss = lit.make_loss_fn(None)(params, torch.Generator().manual_seed(7), batch)
    if nproc > 1:
        shutdown()
    log("probe done")
    return float(loss)


class MpCheckTimeout(RuntimeError):
    """The workers passed the parent's deadline (a worker that fails raises
    a plain RuntimeError with its stderr). ``tails`` holds each worker's
    last progress lines: past ``fit ...`` means slow, before it a hang in
    the rendezvous."""

    def __init__(self, msg: str, tails: List[str]):
        super().__init__(msg)
        self.tails = tails


def _launch(nproc: int, steps: int, fsdp: int, accumulate: int) -> dict:
    """Start ``nproc`` workers, their pipes drained by threads as they run."""
    port = free_port()
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(key, None)  # a launcher's environment must not leak into the workers
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dmme_tpu_torch.parallel.mp_check", "worker", str(pid),
         str(nproc), str(port), str(steps), str(fsdp), str(accumulate)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(nproc)]
    # drain every pipe while the workers run: a worker blocked on a full
    # pipe would stall its peers inside a collective
    err: List[List[str]] = [[] for _ in procs]
    out: List[List[str]] = [[] for _ in procs]

    def drain(stream, lines):
        for line in stream:
            lines.append(line.rstrip())

    threads = [threading.Thread(target=drain, args=(stream, lines), daemon=True)
               for p, e, o in zip(procs, err, out) for stream, lines in ((p.stderr, e),
                                                                          (p.stdout, o))]
    for t in threads:
        t.start()
    return {"procs": procs, "threads": threads, "err": err, "out": out}


def _collect(run: dict, deadline: float) -> List[float]:
    """Wait for ``_launch``'s workers until ``deadline`` (monotonic), kill
    them past it; their probes."""
    procs, err = run["procs"], run["err"]
    timed_out = False
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            timed_out = True
            break
    if timed_out:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    for t in run["threads"]:
        t.join(30)
    if timed_out:
        tails = [" | ".join([ln for ln in lines if ln.startswith("[mp_check")][-3:])
                 or "(no progress lines)" for lines in err]
        raise MpCheckTimeout("mp_check workers did not finish in time; last progress per "
                             "worker:\n" + "\n".join(f"  p{i}: {t}" for i, t in enumerate(tails)),
                             tails)
    probes = []
    for i, p in enumerate(procs):
        if p.returncode != 0:
            tail = "\n".join(err[i][-60:])
            raise RuntimeError(f"mp_check worker {i} failed (rc={p.returncode}):\n{tail[-4000:]}")
        line = [ln for ln in run["out"][i] if ln.startswith("PROBE ")][-1]
        probes.append(float.fromhex(line.split()[1]))
    return probes


def spawn(nproc: int, steps: int = 3, timeout: float = 300, fsdp: int = 1,
          accumulate: int = 1) -> List[float]:
    """Run ``nproc`` fresh CPU workers (one without a group); their probes."""
    return _collect(_launch(nproc, steps, fsdp, accumulate), time.monotonic() + timeout)


def check(nproc: int = 2, steps: int = 3, timeout: float = 300) -> Dict[str, List[float]]:
    """The three runs side by side (``data``, ``fsdp`` and one accumulating
    process) and the invariants; raises ``AssertionError`` where one fails."""
    deadline = time.monotonic() + timeout
    runs = {"data": _launch(nproc, steps, 1, 1), "fsdp": _launch(nproc, steps, nproc, 1),
            "one": _launch(1, steps, 1, nproc)}
    probes = {}
    try:
        for name, run in runs.items():
            probes[name] = _collect(run, deadline)
    finally:
        for run in runs.values():
            for p in run["procs"]:
                if p.poll() is None:
                    p.kill()
    data, fsdp, one = probes["data"], probes["fsdp"], probes["one"]
    assert len(set(data)) == 1, f"the data ranks' probes differ: {data}"
    assert len(set(fsdp)) == 1, f"the fsdp ranks' probes differ: {fsdp}"
    if nproc == 2:
        assert data[0] == one[0], (f"data={nproc} probe {data[0]!r} is not the accumulating "
                                   f"process's {one[0]!r}")
    assert abs(fsdp[0] - data[0]) <= PROBE_RTOL * abs(data[0]), (
        f"fsdp={nproc} probe {fsdp[0]!r} is not within {PROBE_RTOL} of data's {data[0]!r}")
    return probes


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "worker":
        pid, nproc, port, steps, fsdp, accumulate = map(int, argv[1:7])
        loss = worker(pid, nproc, port, steps, fsdp, accumulate)
        print(f"PROBE {loss.hex()} {loss!r}", flush=True)
        return 0
    parser = argparse.ArgumentParser(prog="dmme_tpu_torch.parallel.mp_check")
    parser.add_argument("--nproc", type=int, default=2)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--timeout", type=float, default=300)
    args = parser.parse_args(argv)
    probes = check(args.nproc, args.steps, args.timeout)
    for name, values in probes.items():
        print(f"{name}: " + " ".join(repr(v) for v in values), flush=True)
    print("mp_check: ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
