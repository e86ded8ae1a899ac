#!/usr/bin/env python3
"""K1 and K2 (GroupNorm+SiLU forward and backward) under every launch plan that fits, on one GPU.

    python3 scripts/torch_gn_plans.py [--dtypes f32,fp16,bf16] [--cluster16] [--out FILE.json]

Needs one CUDA device and ``nvcc``; builds ``csrc/group_norm.cu`` and
``csrc/simt.cu``. For each
GroupNorm+SiLU shape of a full-width batch-128 training step of the CIFAR-10
UNet (the nine (H, W, C) of ``tests/test_torch_port_gn_plan.py``, G = 32) and
each dtype it draws random inputs from seed 0 (x, an incoming gradient, a
(C,) affine and an (N, C) pre-bias) and times K1 and K2 under:

- ``gn_plan``'s plan (marked ``*``);
- every one-pass plan of a cluster of 1, 2, 4 or 8 blocks along a sample's
  pixels whose shared memory fits a block (``_one_pass`` picks the threads,
  ``chunk_pixels`` the bulk copies);
- two passes over global memory in chunks of ``TWO_PASS_BYTES``;
- ``simt.cu``'s kernel (``_launch_simt``/``_launch_bwd_simt``: a block per
  (group, sample)), which these widths took before ``group_norm.cu`` took
  fp16 and f32;
- with ``--cluster16``, a cluster of 16 blocks (H100's non-portable size)
  where its shared memory fits, launched from a copy of ``group_norm.cu``
  built under ``build/`` with ``MAX_CLUSTER`` 16 and the non-portable
  attribute set (the product's kernels take at most 8).

Each time is the median of 25 runs between CUDA events, each run queued
behind a sleep kernel so that the interval holds device time only; every plan's
output is held against the plain version first (rtol 2e-2 / 4e-3 / 1e-4 for
bf16 / fp16 / f32, atol that share of the largest reference value). One line
per (dtype, shape, kernel), then one JSON object as the last line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

BATCH = 128
GROUPS = 32
SEED = 0
SITES = ((4, 4, 256), (4, 4, 512), (8, 8, 256), (8, 8, 512), (16, 16, 128), (16, 16, 256),
         (16, 16, 512), (32, 32, 128), (32, 32, 256))
CLUSTER_SIZES = (1, 2, 4, 8)
RTOL = {"bf16": 2e-2, "fp16": 4e-3, "f32": 1e-4}


def device_ms(torch, fn, reps: int = 25) -> float:
    """Median device ms of ``fn()``, each run behind a queued sleep."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def cluster16_fns(build, k_gn) -> dict:
    """{entry point: ctypes function} of ``csrc/group_norm.cu`` patched to
    launch clusters of up to 16 blocks, built under ``build/``."""
    src = (build.CSRC / "group_norm.cu").read_text()
    patches = (("constexpr int MAX_CLUSTER = 8;", "constexpr int MAX_CLUSTER = 16;"),
               ("  cudaLaunchConfig_t cfg = {};\n",
                "  if (blocks > 8) {\n"
                "    err = cudaFuncSetAttribute(kernel, "
                "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
                "    if (err != cudaSuccess) return err;\n"
                "  }\n  cudaLaunchConfig_t cfg = {};\n"))
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"group_norm.cu changed: cannot patch {old.strip()!r}")
        src = src.replace(old, new)
    out_dir = build.BUILD_DIR / "gn_cluster16"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "group_norm.cu").write_text(src)
    lib = out_dir / "libgroup_norm16.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o", str(lib),
                    str(out_dir / "group_norm.cu")], check=True)
    cdll = ctypes.CDLL(str(lib))
    fns = {}
    for name, bound in (("dmme_gn_silu_fwd", k_gn._fwd_fn()),
                        ("dmme_gn_silu_bwd", k_gn._bwd_fn())):
        fn = getattr(cdll, name)
        fn.argtypes, fn.restype = bound.argtypes, bound.restype
        fns[name] = fn
    return fns


def one_pass(k_gn, k: int, backward: bool, hw: int, c: int, size: int):
    """The one-pass plan of a cluster of ``k`` blocks, or None where it
    does not fit."""
    pixels = -(-hw // k)
    if -(-hw // pixels) != k:
        return None
    threads, smem = k_gn._one_pass(backward, pixels, c, size)
    if smem > k_gn.SMEM_MAX:
        return None
    return k_gn.GNPlan(k, pixels, k_gn.chunk_pixels(pixels, c, size), threads, smem, False)


def plans(k_gn, dtype, backward: bool, h: int, w: int, c: int) -> dict:
    """{name: GNPlan}: every cluster size that fits, and two passes."""
    hw, size = h * w, dtype.itemsize
    out = {}
    for k in CLUSTER_SIZES:
        plan = one_pass(k_gn, k, backward, hw, c, size)
        if plan is not None:
            out[f"cluster{k}"] = plan
    tp = max(1, k_gn.TWO_PASS_BYTES // (size * c * (2 if backward else 1)))
    out["two_pass"] = k_gn.GNPlan(-(-hw // tp), tp, tp, k_gn.THREADS, 0, True)
    return out


def check(torch, name: str, shape, pname: str, got, want) -> None:
    """Raise unless every output is within the dtype's tolerance of the
    plain version's."""
    for g, wv in zip(got, want):
        atol = RTOL[name] * float(wv.float().abs().max())
        if not torch.allclose(g.float(), wv.float(), rtol=RTOL[name], atol=atol):
            raise RuntimeError(f"{name} {shape} {pname} disagrees with the plain version")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtypes", default="f32,fp16,bf16")
    ap.add_argument("--cluster16", action="store_true",
                    help="also time clusters of 16 blocks, from a patched scratch build")
    ap.add_argument("--out", default=None, help="also write the result here (JSON)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the port on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from dmme_tpu_torch.ops import build
    from dmme_tpu_torch.ops import group_norm as k_gn

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=False).stdout.strip().splitlines()[0]
    print(card, flush=True)
    build.build_all(("group_norm", "simt"))
    wide = cluster16_fns(build, k_gn) if args.cluster16 else {}
    dev = torch.device("cuda")
    dtypes = {"f32": torch.float32, "fp16": torch.float16, "bf16": torch.bfloat16}
    chosen_plan = k_gn.gn_plan
    gen = torch.Generator().manual_seed(SEED)
    rows = []
    for name in args.dtypes.split(","):
        dtype = dtypes[name]
        for h, w, c in SITES:
            x = torch.randn((BATCH, h, w, c), generator=gen).to(dev, dtype)
            dz = torch.randn((BATCH, h, w, c), generator=gen).to(dev, dtype)
            gamma = (1 + 0.1 * torch.randn((c,), generator=gen)).to(dev)
            beta = (0.1 * torch.randn((c,), generator=gen)).to(dev)
            bias = (0.5 * torch.randn((BATCH, c), generator=gen)).to(dev)
            _, mean, inv = k_gn.gn_silu_plain(x, gamma, beta, bias, GROUPS)
            for backward in (False, True):
                if backward:
                    args_ = (x, dz, gamma, beta, bias, mean, inv, GROUPS)
                    run = lambda: k_gn.group_norm_silu_bwd(*args_)  # noqa: E731
                    simt = lambda: k_gn._launch_bwd_simt(*args_)  # noqa: E731
                    want = k_gn.gn_silu_bwd_plain(*args_)
                else:
                    run = lambda: k_gn.group_norm_silu_fwd(  # noqa: E731
                        x, gamma, beta, GROUPS, pre_bias=bias)
                    simt = lambda: k_gn._launch_simt(  # noqa: E731
                        x, gamma, beta, bias, GROUPS, k_gn.GN_EPS)
                    want = k_gn.gn_silu_plain(x, gamma, beta, bias, GROUPS)
                chosen = chosen_plan(BATCH, h, w, c, GROUPS, build.sm_count(dev), backward,
                                     dtype.itemsize)
                todo = [(pname, plan, {}) for pname, plan in
                        plans(k_gn, dtype, backward, h, w, c).items()]
                plan16 = one_pass(k_gn, 16, backward, h * w, c, dtype.itemsize)
                if wide and plan16 is not None:
                    todo.append(("cluster16", plan16, wide))
                times = {}
                saved = dict(k_gn._FNS)
                try:
                    for pname, plan, fns in todo:
                        k_gn.gn_plan = lambda *_a, _p=plan, **_k: _p
                        k_gn._FNS.update(fns)
                        check(torch, name, (h, w, c), pname, run(), want)
                        times[pname + ("*" if plan == chosen else "")] = device_ms(torch, run)
                        k_gn._FNS.update(saved)
                finally:
                    k_gn.gn_plan = chosen_plan
                    k_gn._FNS.update(saved)
                check(torch, name, (h, w, c), "simt", simt(), want)
                times["simt"] = device_ms(torch, simt)
                kname = "K2" if backward else "K1"
                rows.append({"dtype": name, "shape": [BATCH, h, w, c], "kernel": kname,
                             "ms": times})
                best = min((p for p in times if p != "simt"), key=times.get)
                print(f"{name:5s} {kname} {h}x{w}x{c}: " + ", ".join(
                    f"{p} {t:.4f}" for p, t in times.items()) + f"; fastest {best}", flush=True)
    result = {"card": card, "rows": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
