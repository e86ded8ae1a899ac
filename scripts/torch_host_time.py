#!/usr/bin/env python3
"""Host time of the PyTorch port's CUDA kernel wrappers and of one UNet forward.

    python3 scripts/torch_host_time.py [--root DIR] [--reps 50] [--label NAME] [--out FILE.json]

Needs one CUDA device and ``nvcc``. Imports ``dmme_tpu_torch`` from ``DIR``
(default: the checkout this script is in) and builds its CUDA sources. Then it
records the inputs that K3 (``attention_heads``) and K4
(``resblock_forward``) receive at every call site of one full-width bf16 UNet
forward at batch 8, with both switches on and random weights from seed 0.
It measures three things:

- ``wrapper_us``: the host time of one wrapper call at each recorded shape,
  the mean over ``--reps`` calls issued back to back;
- ``forward_host_ms``: the host time to issue one whole UNet forward, the
  median of 10;
- ``forward_ms``: the forward as ``chip_smoke.py`` phase 4 reads it, with CUDA
  events after a queued ~1 ms sleep, the median of 10. It reads the longer of
  the device's work and the host's enqueue.

While the host times are taken, a long sleep kernel holds the device. So no
launch waits for the device, and each time counts only the host's Python,
ctypes and launch work. The script checks that the device was still busy at
the end of each timed loop. To compare two trees, run it on both in one call,
in the order A, B, B, A. The last line of its output is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

BATCH = 8
SEED = 0
HOLD_CYCLES = 400_000_000  # ~0.2 s of sleep at the H100's clock: longer than any timed loop


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="directory that holds the dmme_tpu_torch package to measure")
    ap.add_argument("--reps", type=int, default=50, help="wrapper calls per shape")
    ap.add_argument("--label", default=None, help="name of this run in the output")
    ap.add_argument("--out", default=None, help="also write the result here (JSON)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the port on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    import dmme_tpu_torch
    import dmme_tpu_torch.models.blocks as blocks
    from dmme_tpu_torch.models import ddpm as ddpm_models
    from dmme_tpu_torch.models import init_weights
    from dmme_tpu_torch.ops import build

    print(f"dmme_tpu_torch from {Path(dmme_tpu_torch.__file__).parent}", flush=True)
    build.build_all()
    dev = torch.device("cuda")
    model = ddpm_models.UNet(dtype=torch.bfloat16, fused_norm=True, fused_block=True)
    init_weights(model, torch.Generator().manual_seed(SEED))
    model = model.to(dev).eval()
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn((BATCH, 32, 32, 3), generator=gen).to(dev)
    t = torch.randint(1, 1000, (BATCH,), generator=gen).to(dev)

    # the first call of each distinct shape keeps its inputs; counts per shape
    recorded = {"attention_heads": {}, "resblock_forward": {}}
    originals = {name: getattr(blocks, name) for name in recorded}

    def recorder(name):
        def wrapped(*a, **k):
            key = (tuple(a[0].shape), tuple(a[0].stride()),
                   tuple(a[6].shape) if name == "resblock_forward" else (),
                   k.get("wr") is not None)
            entry = recorded[name].setdefault(key, [0, a, k])
            entry[0] += 1
            return originals[name](*a, **k)
        return wrapped

    with torch.no_grad():
        for name in recorded:
            setattr(blocks, name, recorder(name))
        try:
            model(x, t)
        finally:
            for name, fn in originals.items():
                setattr(blocks, name, fn)
        torch.cuda.synchronize()

        def host_seconds(fn, reps):
            """Mean host time of ``fn()`` over ``reps`` calls, the device held
            busy; and whether it still was at the end."""
            torch.cuda.synchronize()
            torch.cuda._sleep(HOLD_CYCLES)
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            secs = (time.perf_counter() - t0) / reps
            done = torch.cuda.Event()
            done.record()
            busy = not done.query()
            torch.cuda.synchronize()
            return secs, busy

        rows, all_busy = [], True
        for name, entries in recorded.items():
            fn_ = originals[name]
            for key, (count, a, k) in entries.items():
                fn_(*a, **k)  # warm: plans, packed weights
                secs, busy = host_seconds(lambda a=a, k=k, fn_=fn_: fn_(*a, **k), args.reps)
                all_busy &= busy
                rows.append({"wrapper": name, "shape": list(key[0]), "sites": count,
                             "us": 1e6 * secs})
                print(f"{name:17s} {str(key[0]):22s} sites {count:2d} host {1e6 * secs:8.2f} us"
                      + ("" if busy else "  (device went idle)"), flush=True)
        per_forward = {name: sum(r["us"] * r["sites"] for r in rows if r["wrapper"] == name)
                       for name in recorded}

        model(x, t)
        host_ms = []
        for _ in range(10):
            secs, busy = host_seconds(lambda: model(x, t), 1)
            all_busy &= busy
            host_ms.append(1e3 * secs)
        pairs = []
        for _ in range(10):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            start.record()
            model(x, t)
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        fwd_ms = [s.elapsed_time(e) for s, e in pairs]

    result = {"label": args.label or str(args.root), "torch": torch.__version__,
              "device": torch.cuda.get_device_name(0), "reps": args.reps,
              "wrapper_us": rows, "wrapper_us_per_forward": per_forward,
              "forward_host_ms": statistics.median(host_ms), "forward_host_ms_all": host_ms,
              "forward_ms": statistics.median(fwd_ms), "forward_ms_all": fwd_ms,
              "device_held_throughout": all_busy}
    print(f"per forward: K3 wrappers {per_forward['attention_heads']:.1f} us, K4 wrappers "
          f"{per_forward['resblock_forward']:.1f} us; forward issued in "
          f"{result['forward_host_ms']:.3f} ms (host), phase-4 reading "
          f"{result['forward_ms']:.3f} ms", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
