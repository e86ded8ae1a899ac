#!/usr/bin/env python3
"""The default harness in f32 (and fp16) on one GPU: a training step and a DDIM-50 request.

    python3 scripts/torch_f32_time.py [--root DIR] [--dtypes f32,fp16] [--label NAME]
                                      [--out FILE.json]

Needs one CUDA device and ``nvcc``. Imports ``dmme_tpu_torch`` from ``DIR``
(default: the checkout this script is in) and builds its CUDA sources. For
each dtype it measures the full-width ``LitDDPM(dtype=...)`` (the DDPM UNet
of ``configs/ddpm/cifar10.yaml``, the harness's init from seed 0) on
synthetic CIFAR-10 at batch 128:

- ``step_ms``: the median of 25 training steps, CUDA events around each,
  no host wait between steps, after 3 warm steps;
- ``step_busy_ms`` and ``step_idle_share``: device time (kernels, copies,
  memsets) a step and 1 − busy / wall over 3 steps under ``torch.profiler``;
- ``request_s``: the host wall of one DDIM-50 request at n = 8 (``LitDDIM``
  on the same module and state, ``generate``), after a warm one;
- ``request_busy_ms`` and ``request_idle_share``: the same over one more
  request under the profiler.

``time_dtype`` is also what ``chip_smoke.py`` runs for its f32 and fp16
readings. To compare two trees, run both in one call in the order A, B, B,
A: unpack the other with ``git archive <rev> dmme_tpu_torch | tar -x -C
build/other`` and pass ``--root build/other``. The last line of the output
is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

BATCH = 128
REQUEST_N = 8
SEED = 0
STEPS = 25


def busy_ms(torch, fn) -> tuple:
    """(wall ms, device busy ms) of ``fn()`` under torch.profiler: busy is
    the sum of kernel, copy and memset durations in its trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    busy = sum(ev["dur"] / 1e3 for ev in events
               if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in ev)
    if busy <= 0:
        raise RuntimeError("the profiler trace holds no device time")
    return wall, busy


def time_dtype(torch, dtype: str, dev, steps: int = STEPS) -> dict:
    """The readings above for ``LitDDPM(dtype=dtype)`` on ``dev``, the step's
    median over ``steps``."""
    from dmme_tpu_torch.data import CIFAR10
    from dmme_tpu_torch.parallel import make_train_step
    from dmme_tpu_torch.training import LitDDIM, LitDDPM

    lit = LitDDPM(dtype=dtype)
    state = lit.init_state(SEED, device=dev)
    dm = CIFAR10(synthetic=True, synthetic_size=2 * BATCH, batch_size=BATCH)
    dm.setup("fit")
    batch = torch.from_numpy(next(dm.train_iter(SEED))).to(dev)
    step = make_train_step(lit.make_loss_fn(dm))
    for _ in range(3):
        state, _ = step(state, batch, SEED)
    torch.cuda.synchronize()
    pairs = []
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch, SEED)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    step_ms = statistics.median(s.elapsed_time(e) for s, e in pairs)
    holder = {"state": state}

    def three_steps():
        for _ in range(3):
            holder["state"], _ = step(holder["state"], batch, SEED)

    wall, busy = busy_ms(torch, three_steps)
    out = {"dtype": dtype, "loss": float(metrics["loss"]), "step_ms": step_ms,
           "step_busy_ms": busy / 3, "step_idle_share": 1.0 - busy / wall}

    ddim = LitDDIM(model=lit.model)  # T = 1000, DDIM-50, quadratic τ

    def request():
        gen = torch.Generator(device=dev).manual_seed(11)
        return ddim.generate(holder["state"], gen, (REQUEST_N, 32, 32, 3), use_ema=False)

    request()  # warm: the f32/fp16 packed weights of this state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = request()
    torch.cuda.synchronize()
    out["request_s"] = time.perf_counter() - t0
    if not bool(x.isfinite().all()):
        raise RuntimeError(f"the {dtype} DDIM-50 request gave values that are not finite")
    wall, busy = busy_ms(torch, request)
    out.update(request_busy_ms=busy, request_idle_share=1.0 - busy / wall)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="directory that holds the dmme_tpu_torch package to measure")
    ap.add_argument("--dtypes", default="f32,fp16", help="comma-separated harness dtypes")
    ap.add_argument("--label", default=None, help="name of this run in the output")
    ap.add_argument("--out", default=None, help="also write the result here (JSON)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the port on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    import dmme_tpu_torch
    from dmme_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"dmme_tpu_torch from {Path(dmme_tpu_torch.__file__).parent}", flush=True)
    build.build_all()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    result = {"label": args.label, "root": args.root, "device": torch.cuda.get_device_name(0),
              "card": card, "dtypes": {}}
    for dtype in args.dtypes.split(","):
        r = time_dtype(torch, dtype, dev)
        result["dtypes"][dtype] = r
        print(f"{dtype}: step {r['step_ms']:.3f} ms median of {STEPS} (device busy "
              f"{r['step_busy_ms']:.3f} ms, idle share {r['step_idle_share']:.3f}); DDIM-50 "
              f"n={REQUEST_N} request {r['request_s']:.3f} s (device busy "
              f"{r['request_busy_ms']:.3f} ms, idle share {r['request_idle_share']:.3f})",
              flush=True)
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
