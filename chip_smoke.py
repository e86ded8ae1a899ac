#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold its kernels to account.

    python3 chip_smoke.py [--out FILE.json]

Run from the repository root on a machine with a CUDA device and ``nvcc``.
It exits non-zero, and prints no result line, if there is no CUDA device,
if the package is missing, or if any phase fails. Phases:

1. device  — the card's name and power limit (``nvidia-smi``), torch version;
2. build   — compiles the CUDA sources of ``dmme_tpu_torch/ops/csrc`` in parallel;
3. kernels — records the inputs each kernel receives at every call site of
   one full-width bf16 UNet forward at batch 8 (both switch settings), then
   holds each kernel against its plain PyTorch version on those inputs, with
   times (CUDA events, median of 25; K4's weights are packed once per weight
   state, before the timed runs) and the least time the card could take;
4. unet    — the full-width UNet forward on the card in bf16 under both switch
   settings against the same module and weights on the CPU in f32;
5. serve   — ``LitDDIM`` (T=1000, DDIM-50, quadratic τ) behind ``make_server``,
   with ``/healthz`` and ``/sample`` requests of n = 1, 8 and 16, and a repeat
   that must return identical bytes; counts each kernel's launches; then one
   request of n = 1 and of n = 8 under ``torch.profiler``: device time by
   kernel and the device's idle share;
6. the kernel table as one JSON line, then ``{"ok": true, "device": ...}``.

``--out`` also writes every measurement to a JSON file.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

# Peak rates of one H100 SXM (NVIDIA data sheet, dense): memory, bf16 tensor
# cores, and f32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

BATCH = 8
SEED = 0  # random weights (biases and GroupNorm affines included) and inputs
# bf16 outputs compared in f32 against the plain version of the same math
# (tests/test_ops.py::test_bf16_path's bound). The fused ResBlock rounds its
# normalised activations to bf16 before each conv; where the kernel's f32
# statistics differ from the plain version's in the last bits, single
# elements round the other way, and 9·C_in such products add into each
# output: a looser atol covers that.
TOL = {"group_norm_silu": (2e-2, 1e-2), "attention": (2e-2, 1e-2),
       "resblock": (2e-2, 5e-2)}
# full UNet, bf16 on the card against f32 on the CPU: relative L2 error
UNET_REL_L2 = 5e-2


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def phase(name: str) -> None:
    print(f"\n== {name} ==", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, reps: int = 25) -> float:
    """Median device time of ``fn()`` in ms. A sleep kernel queued before each
    run lets the host enqueue the whole call before the start event fires, so
    the interval holds device time, not launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def errors(got, want, rtol: float, atol: float):
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / w.abs().clamp_min(1e-6)).max())
    ok = bool((diff <= atol + rtol * w.abs()).all()) and bool(g.isfinite().all())
    return max_abs, max_rel, ok


def randomize_affines(torch, blocks, module, generator) -> None:
    """Every Conv and Dense bias 0.1·N(0, 1), every GroupNorm weight
    1 + 0.1·N(0, 1) and bias 0.1·N(0, 1), drawn from ``generator``. The flax
    init leaves them 0 and 1, where a kernel that dropped or misplaced one
    would still agree with its plain version."""
    def draw(p, mean):
        p.copy_(mean + 0.1 * torch.randn(p.shape, generator=generator))

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (blocks.Dense, blocks.Conv)):
                draw(m.bias, 0.0)
            elif isinstance(m, blocks.GroupNorm):
                draw(m.weight, 1.0)
                draw(m.bias, 0.0)


def reset_counts(ops) -> None:
    for m in ops.values():
        m.launches = 0


def counts(ops) -> dict:
    return {k: m.launches for k, m in ops.items()}


def record_calls(blocks, fn):
    """Run ``fn()`` with the three kernel entry points of the UNet blocks
    wrapped so that the first call of each distinct signature keeps its
    inputs. Returns {kernel: [(signature, count, args, kwargs)]}."""
    seen = {"group_norm_silu": {}, "attention": {}, "resblock": {}}

    def sig_gn(x, gamma, beta, groups, eps=None, pre_bias=None):
        return (tuple(x.shape), gamma.dim() == 2, pre_bias is not None)

    def sig_attn(q, k, v, scale):
        return (tuple(q.shape), tuple(q.stride()))

    def sig_res(x, *a, wr=None, **k):
        return (tuple(x.shape), int(a[5].shape[0]), wr is not None)

    originals = {}

    def wrap(attr, kind, sig):
        orig = getattr(blocks, attr)
        originals[attr] = orig

        def wrapped(*a, **k):
            key = sig(*a, **k)
            entry = seen[kind].setdefault(key, [0, a, k])
            entry[0] += 1
            return orig(*a, **k)

        setattr(blocks, attr, wrapped)

    wrap("group_norm_silu", "group_norm_silu", sig_gn)
    wrap("attention_heads", "attention", sig_attn)
    wrap("resblock_forward", "resblock", sig_res)
    try:
        fn()
    finally:
        for attr, orig in originals.items():
            setattr(blocks, attr, orig)
    return {kind: [(key, e[0], e[1], e[2]) for key, e in d.items()]
            for kind, d in seen.items()}


def _kernel_group(name: str) -> str:
    for needle, label in (("conv3x3_kernel", "K4 conv3x3 (resblock.cu)"),
                          ("gn_stats_kernel", "K4 gn_stats (resblock.cu)"),
                          ("attn_fwd_kernel", "K3 attention (attention.cu)"),
                          ("gn_silu_fwd", "K1 group_norm_silu (triton)")):
        if needle in name:
            return label
    return name[:90]


def profile_request(torch, sampler, n: int) -> dict:
    """Device time by kernel over one ``/sample``-sized request, read from a
    torch.profiler trace: busy time is the sum of kernel, copy and memset
    durations on the device; idle share is 1 − busy / wall."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sampler.sample(n, seed=5)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    groups = {}
    for ev in events:
        if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in ev:
            g = groups.setdefault(_kernel_group(ev.get("name", "?")), [0.0, 0])
            g[0] += ev["dur"] / 1e3
            g[1] += 1
    busy = sum(v[0] for v in groups.values())
    if busy <= 0:
        fail("the profiler trace holds no device time")
    top = sorted(((k, v[0], v[1]) for k, v in groups.items()), key=lambda r: -r[1])[:12]
    return {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            "top": top}


def _vector_bytes(v) -> int:
    """f32 bytes of an (N, C) or (C,) vector, one row when the batch shares it."""
    if v is None:
        return 0
    return 4 * (v.shape[-1] if v.dim() == 1 or v.stride(0) == 0 else v.numel())


def bound_ms(kind: str, args, kwargs) -> tuple:
    """(least ms, what bounds it) for the work of one call: each input read
    once, each output written once, and the operations at the card's peak."""
    if kind == "group_norm_silu":
        x, gamma, beta, groups = args[:4]
        n, h, w, c = x.shape
        nbytes = (2 * x.numel() * x.element_size() + _vector_bytes(gamma)
                  + _vector_bytes(beta) + _vector_bytes(kwargs.get("pre_bias"))
                  + 2 * n * groups * 4)
        ops = 10 * x.numel()  # sums, affine, sigmoid: ~10 f32 operations per element
        rate = F32_FLOPS
    elif kind == "attention":
        q = args[0]
        n, t, h, d = q.shape
        nbytes = 4 * q.numel() * q.element_size()
        ops = 4 * n * h * t * t * d
        rate = BF16_FLOPS
    else:
        x, w1, w2 = args[0], args[6], args[8]
        wr = kwargs.get("wr")
        n, h, w, cin = x.shape
        cout = w1.shape[0]
        m = n * h * w
        # x and out in bf16; the conv weights as the kernel reads them, bf16;
        # b1 and b2 (+ br) f32; the five affine vectors f32
        weights = w1.numel() + w2.numel() + (wr.numel() if wr is not None else 0)
        nbytes = (2 * x.numel() + 2 * m * cout + 2 * weights + 2 * 4 * cout
                  + sum(_vector_bytes(v) for v in args[1:6]))
        k = 9 * cin + 9 * cout + (cin if wr is not None else 0)
        ops = 2 * m * cout * k
        rate = BF16_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write all measurements here (JSON)")
    args = ap.parse_args()

    import torch

    phase("device")
    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the port on a GPU", file=sys.stderr)
        return 1
    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}", flush=True)

    import numpy as np

    import dmme_tpu_torch.models.blocks as blocks
    from dmme_tpu_torch.models import ddpm as ddpm_models
    from dmme_tpu_torch.models import init_weights
    from dmme_tpu_torch.ops import attention as k_attn
    from dmme_tpu_torch.ops import build
    from dmme_tpu_torch.ops import group_norm as k_gn
    from dmme_tpu_torch.ops import resblock as k_res
    from dmme_tpu_torch.serving import Sampler, make_server
    from dmme_tpu_torch.training import LitDDIM, ParamsState

    ops = {"group_norm_silu": k_gn, "attention": k_attn, "resblock": k_res}
    report = {"card": card, "torch": torch.__version__, "device": kind}

    phase("build")
    t0 = time.time()
    build.build_all(verbose=True)
    report["build_s"] = time.time() - t0
    print(f"built {', '.join(build.SOURCES)} in {report['build_s']:.1f} s", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn {torch.backends.cudnn.allow_tf32}; cudnn deterministic", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    x_in = torch.randn((BATCH, 32, 32, 3), generator=gen)
    t_in = torch.randint(1, 1000, (BATCH,), generator=gen)
    settings = {"both": dict(fused_norm=True, fused_block=True),
                "fused_norm": dict(fused_norm=True, fused_block=False)}
    models = {}
    for name, sw in settings.items():
        m = ddpm_models.UNet(dtype=torch.bfloat16, **sw)
        init_weights(m, torch.Generator().manual_seed(SEED))
        randomize_affines(torch, blocks, m, torch.Generator().manual_seed(SEED + 1))
        models[name] = m.to(dev).eval()

    phase("kernels against their plain versions")
    recorded = {"group_norm_silu": {}, "attention": {}, "resblock": {}}
    site_counts = {}
    for name, m in models.items():
        with torch.no_grad():
            calls = record_calls(blocks, lambda: m(x_in.to(dev), t_in.to(dev)))
        site_counts[name] = {k: sum(c for _, c, _, _ in v) for k, v in calls.items()}
        for kind_, lst in calls.items():
            for key, count, a, k in lst:
                entry = recorded[kind_].setdefault(key, {"a": a, "k": k, "sites": {}})
                entry["sites"][name] = count
    print(f"call sites per UNet forward: {json.dumps(site_counts)}", flush=True)

    plain = {
        "group_norm_silu": lambda x, g, b, groups, eps=k_gn.GN_EPS, pre_bias=None:
            k_gn.gn_silu_plain(x, g, b, pre_bias, groups, eps)[0],
        "attention": k_attn.attention_heads_plain,
        "resblock": k_res.resblock_plain,
    }
    kernel = {"group_norm_silu": k_gn.group_norm_silu, "attention": k_attn.attention_heads,
              "resblock": k_res.resblock_forward}
    shapes = []
    failures = []
    with torch.no_grad():
        for kind_, entries in recorded.items():
            rtol, atol = TOL[kind_]
            for key, e in entries.items():
                a, k = e["a"], e["k"]
                if kind_ == "resblock":
                    pa = list(a) + [k.get("wr"), k.get("br"), k.get("num_groups", 32),
                                    k.get("eps", k_gn.GN_EPS)]
                    plain_fn = lambda pa=pa: plain["resblock"](*pa)  # noqa: E731
                else:
                    plain_fn = lambda a=a, k=k, kind_=kind_: plain[kind_](*a, **k)  # noqa: E731
                kern_fn = lambda a=a, k=k, kind_=kind_: kernel[kind_](*a, **k)  # noqa: E731
                got = kern_fn()
                torch.cuda.synchronize()
                want = plain_fn()
                max_abs, max_rel, ok = errors(got, want, rtol, atol)
                rec = {
                    "kernel": kind_, "key": repr(key), "sites": e["sites"],
                    "max_abs_err": max_abs, "max_rel_err": max_rel,
                    "rtol": rtol, "atol": atol, "ok": ok,
                    "ms": device_ms(torch, kern_fn), "plain_ms": device_ms(torch, plain_fn),
                }
                rec["bound_ms"], rec["bound_by"] = bound_ms(kind_, a, k)
                rec["library_ms"] = None
                if kind_ == "attention":
                    q, kk, v, scale = a
                    sdpa = lambda q=q, kk=kk, v=v, scale=scale: (  # noqa: E731
                        torch.nn.functional.scaled_dot_product_attention(
                            q.transpose(1, 2), kk.transpose(1, 2), v.transpose(1, 2),
                            scale=scale))
                    rec["library_ms"] = device_ms(torch, sdpa)
                shapes.append(rec)
                print(f"{kind_:16s} {str(key):58s} sites {e['sites']} "
                      f"max_abs {max_abs:.3e} max_rel {max_rel:.3e} (rtol {rtol}, atol {atol}) "
                      f"ms {rec['ms']:.4f} plain {rec['plain_ms']:.4f} bound {rec['bound_ms']:.4f} "
                      f"({rec['bound_by']})"
                      + (f" sdpa {rec['library_ms']:.4f}" if rec["library_ms"] else "")
                      + ("" if ok else "  FAIL"), flush=True)
                if not ok:
                    failures.append(f"{kind_} {key}")
    report["shapes"] = shapes
    if failures:
        fail(f"kernels disagree with their plain versions: {failures}")
    del recorded

    phase("unet forward, full width, bf16 on the card vs f32 on the CPU")
    torch.set_num_threads(max(1, os.cpu_count() or 1))
    unet = {}
    expect = {"both": {"group_norm_silu": 1, "attention": 6, "resblock": 22},
              "fused_norm": {"group_norm_silu": 45, "attention": 6, "resblock": 0}}
    for name, m in models.items():
        ref_model = ddpm_models.UNet(dtype=torch.float32, **settings[name])
        ref_model.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()}, strict=True)
        with torch.no_grad():
            want = ref_model(x_in, t_in)
            reset_counts(ops)
            got = m(x_in.to(dev), t_in.to(dev))
            torch.cuda.synchronize()
            per_call = counts(ops)
            ms = device_ms(torch, lambda m=m: m(x_in.to(dev), t_in.to(dev)), reps=10)
        got = got.float().cpu()
        rel = float((got - want).norm() / want.norm())
        max_abs = float((got - want).abs().max())
        ok = bool(got.isfinite().all()) and got.shape == want.shape and rel <= UNET_REL_L2
        unet[name] = {"rel_l2": rel, "max_abs_err": max_abs, "ms": ms, "launches": per_call,
                      "ok": ok}
        print(f"{name:10s} shape {tuple(got.shape)} rel_l2 {rel:.3e} (<= {UNET_REL_L2}) "
              f"max_abs {max_abs:.3e} forward {ms:.3f} ms launches {per_call}"
              + ("" if ok else "  FAIL"), flush=True)
        if not ok:
            fail(f"UNet forward ({name}) disagrees with the f32 CPU reference")
        if per_call != expect[name]:
            fail(f"UNet forward ({name}) launched {per_call}, expected {expect[name]}")
    report["unet"] = unet
    del models

    phase("serve: LitDDIM DDIM-50 over HTTP")
    lit = LitDDIM(dtype="bf16", timesteps=1000, sample_steps=50, tau_schedule="quadratic")
    lit.init_state(SEED)
    randomize_affines(torch, blocks, lit.model, torch.Generator().manual_seed(SEED + 1))
    state = ParamsState.create({k: v.detach().clone() for k, v in lit.model.state_dict().items()})
    sampler = Sampler(lit, state, img_size=32, device="cuda")
    server = make_server(sampler, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = "http://%s:%d" % server.server_address[:2]
    serve = {"requests": []}
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        print(f"healthz {health}", flush=True)
        if health.get("status") != "ok":
            fail(f"healthz: {health}")

        def post(n, seed):
            body = json.dumps({"n": n, "seed": seed, "format": "npy"}).encode()
            req = urllib.request.Request(url + "/sample", data=body,
                                         headers={"Content-Type": "application/json"})
            t = time.time()
            with urllib.request.urlopen(req, timeout=600) as r:
                data = r.read()
            return data, time.time() - t

        post(1, 99)  # first request: Triton compiles, cuDNN plans
        reset_counts(ops)
        bodies = {}
        for n, seed in ((1, 1), (8, 2), (16, 3), (8, 2)):
            data, secs = post(n, seed)
            imgs = np.load(io.BytesIO(data))
            ok = bool(imgs.shape == (n, 32, 32, 3) and np.isfinite(imgs).all()
                      and imgs.min() >= 0.0 and imgs.max() <= 1.0)
            serve["requests"].append({"n": n, "seed": seed, "s": secs, "ok": ok,
                                      "mean": float(imgs.mean()), "std": float(imgs.std())})
            print(f"POST /sample n={n:2d} seed={seed}: {secs:.3f} s, shape {imgs.shape}, "
                  f"range [{imgs.min():.3f}, {imgs.max():.3f}], std {imgs.std():.4f}"
                  + ("" if ok else "  FAIL"), flush=True)
            if not ok:
                fail(f"/sample n={n} returned bad images")
            if (n, seed) in bodies and bodies[(n, seed)] != data:
                fail("a repeated request with the same seed returned other bytes")
            bodies[(n, seed)] = data
        launches = counts(ops)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    print("repeat of n=8 seed=2: identical bytes", flush=True)
    print(f"kernel launches during the four requests: {launches}", flush=True)
    per_request = {k: expect["both"][k] * lit.diffusion_model.sub_timesteps * 4
                   for k in launches}
    if launches != per_request:
        fail(f"serve launched {launches}, expected {per_request}")
    serve["launches"] = launches
    report["serve"] = serve

    phase("where the device time goes: one request under torch.profiler")
    report["profile"] = {}
    for n in (1, 8):
        prof = profile_request(torch, sampler, n)
        report["profile"][n] = prof
        print(f"n={n}: wall {prof['wall_ms']:.2f} ms (profiled), device busy "
              f"{prof['busy_ms']:.2f} ms, idle share {prof['idle_share']:.3f}", flush=True)
        for name, ms, count in prof["top"]:
            print(f"    {ms:9.3f} ms {count:6d}x  {name}", flush=True)

    phase("kernels")
    sources = {
        "group_norm_silu": ("triton", "dmme_tpu_torch/ops/group_norm.py",
                            "dmme_tpu/ops/group_norm.py:72"),
        "attention": ("cuda", "dmme_tpu_torch/ops/csrc/attention.cu",
                      "dmme_tpu/ops/attention.py:47"),
        "resblock": ("cuda", "dmme_tpu_torch/ops/csrc/resblock.cu",
                     "dmme_tpu/ops/resblock.py:88"),
    }
    table = []
    for kname, (route, src, replaces) in sources.items():
        recs = [r for r in shapes if r["kernel"] == kname and "both" in r["sites"]]
        if not recs:
            fail(f"{kname} has no call site on the serving path")

        def per_forward(field, recs=recs):
            vals = [r[field] * r["sites"]["both"] for r in recs]
            return None if any(v is None for v in vals) else sum(vals)

        table.append({
            "name": kname, "route": route, "source": src, "replaces": replaces,
            "launches": launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in shapes if r["kernel"] == kname),
            "ms": per_forward("ms"), "plain_ms": per_forward("plain_ms"),
            "bound_ms": per_forward("bound_ms"),
            "bound_by": max(recs, key=lambda r: r["bound_ms"] * r["sites"]["both"])["bound_by"],
            "library_ms": per_forward("library_ms") if kname == "attention" else None,
        })
    report["kernels"] = table
    print("kernels launched on the serving path and held against their plain versions: "
          + "; ".join(f"{k['name']} ({k['route']}, {k['source']}, replaces {k['replaces']}, "
                      f"{k['launches']} launches, "
                      f"{len([r for r in shapes if r['kernel'] == k['name']])} shapes)"
                      for k in table), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print("(ms, plain_ms, bound_ms and library_ms: per UNet forward at batch 8, "
          "summed over the serving path's call sites)", flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
