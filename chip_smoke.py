#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold its kernels to account.

    python3 chip_smoke.py [--out FILE.json] [--kernels-only]

Run from the repository root on a machine with a CUDA device and ``nvcc``.
It exits non-zero, and prints no result line, if there is no CUDA device,
if the package is missing, or if any phase fails. Phases:

1. device  — the card's name and power limit (``nvidia-smi``), torch version;
2. build   — compiles the CUDA sources of ``dmme_tpu_torch/ops/csrc`` in
   parallel (K1 and K2 in ``group_norm.cu``, K3, K4, and their f32/fp16
   versions in ``simt.cu``) and prints each
   kernel's registers and spill bytes (``-Xptxas -v``);
3. kernels — records the inputs each kernel receives at every call site of
   one full-width bf16 UNet forward at each serving batch, 1, 8 and 16 (both
   switches on; at batch 8 also ``fused_norm`` only), then holds each kernel
   against its plain PyTorch version on those inputs, with times (CUDA
   events, median of 25; K4's weights are packed once per weight state,
   before the timed runs) and the least time the card could take; beside
   K3, SDPA; beside K4, the same ResBlock as a cuDNN sequence
   (``cudnn_seq_ms``), which the port never calls;
4. unet    — the full-width UNet forward on the card in bf16 under both switch
   settings against the same module and weights on the CPU in f32; then one
   forward at the LSUN widths (``configs/ddpm/lsun_*.yaml``: channels
   128/128/256/256/512/512, attention at depth 5, 256×256) at batch 1, both
   switches on, the same way, with every K1, K3 and K4 call of it (head dim
   512, 256×256 ResBlocks, a two-pass GroupNorm) held against its plain
   version;
5. serve   — ``LitDDIM`` (T=1000, DDIM-50, quadratic τ) behind ``make_server``,
   with ``/healthz`` and ``/sample`` requests of n = 1, 8 and 16, and a repeat
   that must return identical bytes; counts each kernel's launches; then one
   request of n = 1 and of n = 8 under ``torch.profiler``: device time by
   kernel and the device's idle share;
6. train kernels — records the inputs of K1, K2, K3 and the attention
   backward at every call site of one full-width bf16 training step at batch
   128 (dropout on, random biases and affines) and holds each against its
   plain version there, with times and bounds, and calls K1 and K2 twice
   for identical bytes; SDPA's forward and backward are timed beside K3 and
   the attention backward, ``F.group_norm`` + ``F.silu`` (and its autograd
   backward) beside K1 and K2, as yardsticks;
6b. off-path kernels — K1, K2, K3 and K4 at shapes off the main path (head
   dims 16, 48, 96, 160 and 512, a key split at a padded head dim; C_in 32
   and 96; C_out 32, 64 and 192; H×W that 64-pixel tiles of whole rows do
   not cover; C/G = 3; GroupNorms that take two passes, forward and
   backward), each held against its plain version;
7. train gradient — one ``loss_given`` + backward at batch 8, dropout 0, on
   the same weights and numpy t, ε: bf16 on the card against f32 on the CPU
   (relative L2 of the loss and of the gradient, overall and per top-level
   module), every parameter's gradient finite and non-zero on the card, and
   the launches of that step: K1 45, K2 45, K3 6, K4 0;
8. fit     — ``fit(LitDDPM(dtype="bf16"), CIFAR10(synthetic=True,
   batch_size=128))`` at the recipe's settings: warm steps, one step whose
   parameter and EMA updates are checked, 20 logged steps (loss and
   grad_norm finite, launches per step), 25 steps timed with CUDA events
   (median step ms, imgs/s), and three steps under ``torch.profiler``
   (device idle share; device time by kernel for one step);
9. sample after training — a DDIM-50 n = 8 request from the trained raw
   weights through K4, equal byte for byte to the same request after K4's
   weight cache is cleared;
9b. cli — ``dmme_tpu_torch.trainer.main`` in this process (deterministic
   cuDNN): ``fit`` of ``configs/ddim/cifar10.yaml`` (synthetic data, full
   width, batch 128, bf16) for 20 steps with checkpoints at 10 and 20, JSONL,
   TensorBoard and GenerateImage grids (DDIM-50, n = 8) at 10 and 20, the
   launches 45/45/6/0 a step and 1/0/6/22 a sampling forward; a resume to 30
   against an uninterrupted 30-step run, bit for bit (parameters, EMA, Adam
   moments); ``sample`` and ``predict`` from the resumed checkpoint, predict's
   bytes equal to ``generate`` on a state restored in place after sampling
   with other weights (K4's weight cache); ``configs/ddpm/shapes_demo.yaml``
   for 20 steps in chunks of 10; ``configs/ddpm/shapes256_demo.yaml`` (LSUN
   widths, 256 px, batch 16) for 2 steps with and without ``remat``, the
   peak memory lower with it;
10. f32 and fp16 — fault C.5: ``LitDDPM()`` (f32) and ``LitDDPM(dtype="fp16")``
   each train one full-width step at batch 128 and take one DDIM step at
   n = 8, launching the ``simt.cu`` kernels (K1/K2/K3 45/45/6 a step,
   K1/K3/K4 1/6/22 a forward) and no bf16 kernel; every call site held
   against its plain version and timed (the table's ``*_simt`` rows); the
   loss, gradient (dropout off), a UNet forward and the DDIM step against
   f32 on the CPU, f32 within ``F32_REL_L2`` (1e-4), fp16's forward and DDIM
   step within ``UNET_REL_L2``; the bf16 harness on the same inputs is the control that
   must miss ``F32_REL_L2``. Every bf16 path above launches no ``simt.cu``
   kernel;
11. the kernel table as one JSON line, the card's name and power limit, then
   ``{"ok": true, "device": ...}``.

``--out`` also writes every measurement to a JSON file. ``--kernels-only``
runs phases 1–3, 6, 6b and the LSUN forward of phase 4, then stops and
prints no result line: a short first check of new kernels.
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

# Peak rates of one H100 SXM (NVIDIA data sheet, dense): memory, bf16 (and
# fp16) tensor cores, and f32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

BATCH = 8
SERVE_BATCHES = (1, 8, 16)  # the request sizes of the serve phase
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
# the f32 harness on the card against f32 on the CPU, relative L2: the same
# math summed in another order reads ~1e-6; the bf16 harness reads ~5e-3,
# and fails this limit (the phase checks that it does)
F32_REL_L2 = 1e-4
# the f32/fp16 kernels of simt.cu against their plain versions on the same
# inputs: (rtol, atol as a share of the largest reference value, least
# atol). f32: the same arithmetic in another order, f32 rounding grown by
# sums of up to ~1e5 terms. fp16: outputs rounded to fp16 (2^-11 relative,
# and 2^-24 apart in its subnormal range, where a training step's small
# gradients fall) from f32 values that differ in their last bits, and K3's
# plain version rounds P to fp16 where the kernel keeps it in f32
TOL_SIMT = {"torch.float32": (1e-4, 1e-5, 0.0), "torch.float16": (4e-3, 2e-3, 2.0 ** -24)}
# the LSUN widths of configs/ddpm/lsun_*.yaml, run at batch 1 and 256x256
LSUN_WIDTHS = dict(channels_per_depth=(128, 128, 256, 256, 512, 512), attention_depths=(5,))
LSUN_IMG = 256
# K2 on the training path: gradients have no fixed scale, so atol is a share
# of the largest reference value. dx is bf16, one rounding of an f32 value
# (a bf16 ulp is 2^-8 of it), from group means summed in another order than
# the plain version's; dγ, dβ and dbias are f32 sums over H·W in another order.
TOL_BWD = {"dx": (2e-2, 1e-2), "vec": (1e-3, 1e-3)}
# attention backward against autograd of the plain forward, relative L2: the
# port rounds the scores to bf16 before the softmax, as the JAX backward does
# (``_fused_bwd``), where the plain forward keeps them in f32
ATTN_BWD_REL_L2 = 2e-2
# one training step at batch 8, bf16 on the card against f32 on the CPU:
# relative L2 of the flattened gradient
GRAD_REL_L2 = 5e-2
TRAIN_BATCH = 128
FIT_WARM, FIT_STEPS, TIMED_STEPS = 3, 20, 25
# launches of one training step of the full-width UNet
PER_TRAIN_STEP = {"group_norm_silu": 45, "group_norm_silu_bwd": 45, "attention": 6,
                  "resblock": 0}
# bench.py:60-63: 3.53 TFLOP per batch-128 train step (forward, backward and
# optimizer), a work count traced from the JAX package's XLA program, not a
# time; over the card's bf16 peak it bounds a step from below
TRAIN_STEP_TFLOP = 3.53


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


#: the launch counters of the f32/fp16 kernels of ``csrc/simt.cu``,
#: {kernel: (module, attribute)}; set by main()
SIMT = {}


def reset_counts(ops) -> None:
    """``ops``: {kernel: (module, counter attribute)}; the simt counters too."""
    for m, attr in list(ops.values()) + list(SIMT.values()):
        setattr(m, attr, 0)


def simt_counts() -> dict:
    return {k: getattr(m, attr) for k, (m, attr) in SIMT.items()}


def expect_no_simt(where: str) -> dict:
    """Fail if a bf16 path launched an f32/fp16 kernel."""
    got = simt_counts()
    print(f"{where}: f32/fp16 (simt.cu) launches {got}", flush=True)
    if any(got.values()):
        fail(f"{where}: a bf16 path launched the f32/fp16 kernels: {got}")
    return got


def counts(ops) -> dict:
    return {k: getattr(m, attr) for k, (m, attr) in ops.items()}


def _sig_gn(x, gamma, beta, groups, eps=None, pre_bias=None):
    return (tuple(x.shape), gamma.dim() == 2, pre_bias is not None)


def _sig_gn_bwd(x, dz, gamma, beta, pre_bias, mean, inv, groups):
    return (tuple(x.shape), gamma.dim() == 2, pre_bias is not None)


def _sig_attn(q, k, v, scale, *rest):
    return (tuple(q.shape), tuple(q.stride()))


def _sig_res(x, *a, wr=None, **k):
    return (tuple(x.shape), int(a[5].shape[0]), wr is not None)


def serve_targets(blocks):
    """The three kernel entry points of the UNet blocks' forward."""
    return [(blocks, "group_norm_silu", "group_norm_silu", _sig_gn),
            (blocks, "attention_heads", "attention", _sig_attn),
            (blocks, "resblock_forward", "resblock", _sig_res)]


def train_targets(blocks, k_gn, k_attn):
    """The forward entry points and the two backward ones of a training step."""
    return [(blocks, "group_norm_silu", "group_norm_silu", _sig_gn),
            (k_gn, "group_norm_silu_bwd", "group_norm_silu_bwd", _sig_gn_bwd),
            (blocks, "attention_heads", "attention", _sig_attn),
            (k_attn, "attention_bwd", "attention_bwd", _sig_attn)]


def record_calls(targets, fn):
    """Run ``fn()`` with each ``(module, attribute, kind, signature)`` entry
    point wrapped so that the first call of each distinct signature keeps
    its inputs. Returns {kind: [(signature, count, args, kwargs)]}."""
    seen = {kind: {} for _, _, kind, _ in targets}
    originals = []

    for module, attr, kind, sig in targets:
        orig = getattr(module, attr)
        originals.append((module, attr, orig))

        def wrapped(*a, _orig=orig, _kind=kind, _sig=sig, **k):
            entry = seen[_kind].setdefault(_sig(*a, **k), [0, a, k])
            entry[0] += 1
            return _orig(*a, **k)

        setattr(module, attr, wrapped)
    try:
        fn()
    finally:
        for module, attr, orig in originals:
            setattr(module, attr, orig)
    return {kind: [(key, e[0], e[1], e[2]) for key, e in d.items()]
            for kind, d in seen.items()}


def _kernel_group(name: str) -> str:
    for needle, label in (("conv_wgmma_kernel", "K4 conv (resblock.cu)"),
                          ("gn_silu_kernel", "K4 gn_silu (resblock.cu)"),
                          ("splitk_reduce_kernel", "K4 split-K sum (resblock.cu)"),
                          ("attn_fwd_kernel", "K3 attention (attention.cu)"),
                          ("attn_combine_kernel", "K3 split merge (attention.cu)"),
                          ("gn_fwd_cluster_kernel", "K1 group_norm_silu (group_norm.cu)"),
                          ("gn_apply_kernel", "K1 two-pass apply (group_norm.cu)"),
                          ("gn_bwd_cluster_kernel", "K2 group_norm_silu backward (group_norm.cu)"),
                          ("gn_dx_kernel", "K2 two-pass dx (group_norm.cu)"),
                          ("gn_partial_kernel", "K1/K2 two-pass partials (group_norm.cu)"),
                          ("gn_finalize_kernel", "K1/K2 two-pass sums (group_norm.cu)")):
        if needle in name:
            return label
    return name[:90]


def ptxas_report(build) -> dict:
    """{source: {kernel: registers and spill bytes}} of every CUDA source built
    in this run, read from its ``-Xptxas -v`` log; names demangled where
    ``c++filt`` is found, without the parameter list."""
    out = {}
    for src, log in build.LOGS.items():
        usage = build.ptxas_usage(log)
        names = list(usage)
        try:
            r = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True, timeout=60, check=True)
            plain = r.stdout.splitlines()
        except (OSError, subprocess.SubprocessError):
            plain = names
        for mangled, name in zip(names, plain):
            name = name.replace("(anonymous namespace)::", "").split("(")[0]
            out.setdefault(src, {})[name.removeprefix("void ")] = usage[mangled]
    return out


def gn_sequence(torch, a, k, dz=None):
    """One K1 call's function as a library sequence on the same bf16 NHWC
    tensor: the pre-bias add, ``F.group_norm`` and ``F.silu``; with ``dz``,
    K2's: autograd through that sequence to x, γ, β and the pre-bias. A
    yardstick the port never calls; the affine is the batch's (C,) row."""
    F = torch.nn.functional
    x, gamma, beta, groups = a[:4]
    eps, bias = k.get("eps", 1e-5), k.get("pre_bias")
    g, b = (v if v.dim() == 1 else v[0] for v in (gamma, beta))

    def fwd(xx, gg, bb, pp):
        u = xx if pp is None else xx + pp.to(xx.dtype)[:, None, None, :]
        return F.silu(F.group_norm(u.permute(0, 3, 1, 2), groups, gg, bb, eps))

    g, b = g.to(x.dtype), b.to(x.dtype)
    if dz is None:
        return lambda: fwd(x, g, b, bias)
    leaves = [t.detach().requires_grad_(True) for t in (x, g, b)]
    if bias is not None:
        leaves.append(bias.detach().requires_grad_(True))
    with torch.enable_grad():
        out = fwd(*leaves[:3], leaves[3] if bias is not None else None)
    dz = dz.permute(0, 3, 1, 2)
    return lambda: torch.autograd.grad(out, leaves, dz, retain_graph=True)


def attention_plan(k_attn, q) -> dict:
    """K3's plan for the recorded query tensor, as a dict."""
    n, t, h, d = q.shape
    return k_attn.attention_plan(n, h, t, d, k_attn.build.sm_count(q.device))._asdict()


def cudnn_sequence(torch, pa):
    """The ResBlock of one K4 call (``resblock_plain``'s arguments) as a
    library sequence on bf16 channels-last tensors: F.group_norm, F.silu and
    two F.conv2d (cuDNN), plus the skip. A yardstick the port never calls;
    the weights are cast once, outside the returned function."""
    F = torch.nn.functional
    x, g1, b1v, pre2, g2, b2v, w1, b1, w2, b2, wr, br, groups, eps = pa
    bf16 = torch.bfloat16
    w1c, w2c = (w.to(dtype=bf16, memory_format=torch.channels_last) for w in (w1, w2))
    wrc = None if wr is None else wr.to(dtype=bf16, memory_format=torch.channels_last)
    b1c, b2c = b1.to(bf16), b2.to(bf16)
    brc = None if br is None else br.to(bf16)
    ga1, be1, ga2, be2 = (v[0].to(bf16) for v in (g1, b1v, g2, b2v))
    pre = pre2.to(bf16)[:, :, None, None]
    xc = x.permute(0, 3, 1, 2)  # NHWC storage: a channels-last NCHW view

    def run():
        h = F.silu(F.group_norm(xc, groups, ga1, be1, eps))
        h = F.conv2d(h, w1c, b1c, padding=1) + pre
        h = F.silu(F.group_norm(h, groups, ga2, be2, eps))
        h = F.conv2d(h, w2c, b2c, padding=1)
        return h + (xc if wrc is None else F.conv2d(xc, wrc, brc))

    return run


def profile_request(torch, sampler, n: int) -> dict:
    """Device time by kernel over one ``/sample``-sized request."""
    return profile_fn(torch, lambda: sampler.sample(n, seed=5))


def profile_fn(torch, fn, top_n: int = 12) -> dict:
    """Device time by kernel over ``fn()``, read from a torch.profiler trace:
    busy time is the sum of kernel, copy and memset durations on the device;
    idle share is 1 − busy / wall."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    ops = sum(v[1] for v in groups.values())
    top = sorted(((k, v[0], v[1]) for k, v in groups.items()), key=lambda r: -r[1])[:top_n]
    return {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            "device_ops": ops, "top": top}


def _vector_bytes(v) -> int:
    """f32 bytes of an (N, C) or (C,) vector, one row when the batch shares it."""
    if v is None:
        return 0
    return 4 * (v.shape[-1] if v.dim() == 1 or v.stride(0) == 0 else v.numel())


def bound_ms(kind: str, args, kwargs) -> tuple:
    """(least ms, what bounds it) for the work of one call: each input read
    once, each output written once, and the operations at the card's peak
    for the activations' type (bf16 and fp16 on the tensor cores, f32 off
    them; GroupNorm's arithmetic is f32 in every case)."""
    if kind == "group_norm_silu":
        x, gamma, beta, groups = args[:4]
        n, h, w, c = x.shape
        nbytes = (2 * x.numel() * x.element_size() + _vector_bytes(gamma)
                  + _vector_bytes(beta) + _vector_bytes(kwargs.get("pre_bias"))
                  + 2 * n * groups * 4)
        ops = 10 * x.numel()  # sums, affine, sigmoid: ~10 f32 operations per element
        rate = F32_FLOPS
    elif kind == "group_norm_silu_bwd":
        x, dz, gamma, beta, pre_bias, mean, inv, groups = args
        n, h, w, c = x.shape
        # x, dz read and dx written once; the affines and pre-bias read, the
        # (N, G) statistics read, the three (N, C) f32 sums written
        nbytes = (3 * x.numel() * x.element_size() + _vector_bytes(gamma)
                  + _vector_bytes(beta) + _vector_bytes(pre_bias) + 2 * n * groups * 4
                  + 3 * n * c * 4)
        ops = 25 * x.numel()  # x̂, y, σ, dy, four sums, dx: ~25 f32 operations per element
        rate = F32_FLOPS
    elif kind == "attention":
        q = args[0]
        n, t, h, d = q.shape
        nbytes = 4 * q.numel() * q.element_size()
        ops = 4 * n * h * t * t * d
        rate = F32_FLOPS if q.element_size() == 4 else BF16_FLOPS
    elif kind == "attention_bwd":
        q = args[0]
        n, t, h, d = q.shape
        nbytes = 7 * q.numel() * q.element_size()  # q, k, v, g in; dq, dk, dv out
        ops = 10 * n * h * t * t * d  # QKᵀ again, then dV, dP, dQ, dK
        rate = F32_FLOPS if q.element_size() == 4 else BF16_FLOPS
    else:
        x, w1, w2 = args[0], args[6], args[8]
        wr = kwargs.get("wr")
        n, h, w, cin = x.shape
        cout = w1.shape[0]
        m = n * h * w
        # x, out and the conv weights (as the kernel reads them) in x's
        # dtype; b1 and b2 (+ br) f32; the five affine vectors f32
        size = x.element_size()
        weights = w1.numel() + w2.numel() + (wr.numel() if wr is not None else 0)
        nbytes = (size * (x.numel() + m * cout + weights) + 2 * 4 * cout
                  + sum(_vector_bytes(v) for v in args[1:6]))
        k = 9 * cin + 9 * cout + (cin if wr is not None else 0)
        ops = 2 * m * cout * k
        rate = F32_FLOPS if size == 4 else BF16_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rel_l2(got, want) -> float:
    g, w = got.float().flatten(), want.float().flatten()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def scaled_errors(got, want, rtol: float, atol_share: float):
    """:func:`errors` with atol a share of the largest reference value."""
    return errors(got, want, rtol, atol_share * float(want.float().abs().max()))


def train_kernels(torch, blocks, k_gn, k_attn, ddpm_models, init_weights, lit_cls, dev,
                  card: str) -> dict:
    """Phase 6: K1, K2, K3 and the attention backward at every call site of one
    full-width bf16 training step at batch 128, each held against its plain
    version on the recorded inputs, with times and bounds."""
    from dmme_tpu_torch.data import CIFAR10

    lit = lit_cls(dtype="bf16")
    init_weights(lit.model, torch.Generator().manual_seed(SEED))
    randomize_affines(torch, blocks, lit.model, torch.Generator().manual_seed(SEED + 1))
    params = {k: v.detach().to(dev).requires_grad_(True)
              for k, v in lit.model.state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batch = torch.randint(0, 256, (TRAIN_BATCH, 32, 32, 3), generator=gen, device=dev,
                          dtype=torch.uint8)
    loss_fn = lit.make_loss_fn(CIFAR10(batch_size=TRAIN_BATCH))  # flip, process, loss

    def step():
        loss = loss_fn(params, gen, batch)
        torch.autograd.grad(loss, list(params.values()))

    calls = record_calls(train_targets(blocks, k_gn, k_attn), step)
    sites = {k: sum(c for _, c, _, _ in v) for k, v in calls.items()}
    print(f"call sites per training step: {json.dumps(sites)}", flush=True)
    want_sites = {"group_norm_silu": 45, "group_norm_silu_bwd": 45, "attention": 6,
                  "attention_bwd": 6}
    if sites != want_sites:
        fail(f"training step call sites {sites}, expected {want_sites}")

    rows, failures = [], []
    with torch.no_grad():
        for key, count, a, k in calls["group_norm_silu"]:
            rtol, atol = TOL["group_norm_silu"]
            kern = lambda a=a, k=k: k_gn.group_norm_silu(*a, **k)  # noqa: E731
            plain = lambda a=a, k=k: k_gn.gn_silu_plain(  # noqa: E731
                a[0], a[1], a[2], k.get("pre_bias"), a[3], k.get("eps", k_gn.GN_EPS))[0]
            got = kern()
            torch.cuda.synchronize()
            max_abs, _, ok = errors(got, plain(), rtol, atol)
            same = bool(torch.equal(got, kern()))
            row = _train_row("group_norm_silu", key, count, max_abs, ok and same,
                             device_ms(torch, kern), device_ms(torch, plain), a, k)
            row["repeat_identical"], row["plan"] = same, gn_plan(k_gn, a[0], a[3], False)
            row["torch_seq_ms"] = device_ms(torch, gn_sequence(torch, a, k))
            rows.append(row)
        for key, count, a, k in calls["group_norm_silu_bwd"]:
            kern = lambda a=a: k_gn.group_norm_silu_bwd(*a)  # noqa: E731
            plain = lambda a=a: k_gn.gn_silu_bwd_plain(*a)  # noqa: E731
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            max_abs, ok = 0.0, True
            for name, g_, w_ in zip(("dx", "dgamma", "dbeta", "dbias"), got, want):
                rtol, share = TOL_BWD["dx" if name == "dx" else "vec"]
                e_abs, _, e_ok = scaled_errors(g_, w_, rtol, share)
                max_abs, ok = max(max_abs, e_abs), ok and e_ok and g_.dtype == w_.dtype
            same = all(bool(torch.equal(g_, h_)) for g_, h_ in zip(got, kern()))
            row = _train_row("group_norm_silu_bwd", key, count, max_abs, ok and same,
                             device_ms(torch, kern), device_ms(torch, plain), a, k)
            row["repeat_identical"], row["plan"] = same, gn_plan(k_gn, a[0], a[7], True)
            row["torch_seq_ms"] = device_ms(
                torch, gn_sequence(torch, (a[0], a[2], a[3], a[7]), {"pre_bias": a[4]}, a[1]))
            rows.append(row)
        for key, count, a, k in calls["attention"]:
            rtol, atol = TOL["attention"]
            q, kk, v, scale = a
            kern = lambda a=a: k_attn.attention_heads(*a)  # noqa: E731
            plain = lambda a=a: k_attn.attention_heads_plain(*a)  # noqa: E731
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            max_abs, _, ok = errors(got, want, rtol, atol)
            row = _train_row("attention", key, count, max_abs, ok, device_ms(torch, kern),
                             device_ms(torch, plain), a, k)
            sdpa = lambda q=q, kk=kk, v=v, scale=scale: (  # noqa: E731
                torch.nn.functional.scaled_dot_product_attention(
                    q.transpose(1, 2), kk.transpose(1, 2), v.transpose(1, 2), scale=scale))
            row["library_ms"] = device_ms(torch, sdpa)
            row["plan"] = attention_plan(k_attn, q)
            rows.append(row)
    for key, count, a, k in calls["attention_bwd"]:
        q, kk, v, g, scale = a

        def kern(a=a):
            with torch.no_grad():
                return k_attn.attention_bwd(*a)

        got = kern()
        leaves = [t.detach().requires_grad_(True) for t in (q, kk, v)]
        out = k_attn.attention_heads_plain(*leaves, scale)
        want = torch.autograd.grad(out, leaves, g, retain_graph=True)
        rel = max(rel_l2(g_, w_) for g_, w_ in zip(got, want))
        max_abs = max(float((g_.float() - w_.float()).abs().max()) for g_, w_ in zip(got, want))
        ok = rel <= ATTN_BWD_REL_L2 and all(bool(g_.isfinite().all()) for g_ in got)
        plain = lambda out=out, leaves=leaves, g=g: torch.autograd.grad(  # noqa: E731
            out, leaves, g, retain_graph=True)
        sl = [t.detach().transpose(1, 2).requires_grad_(True) for t in (q, kk, v)]
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(*sl, scale=scale)
        g_t = g.transpose(1, 2)
        sdpa = lambda o=sdpa_out, sl=sl, g_t=g_t: torch.autograd.grad(  # noqa: E731
            o, sl, g_t, retain_graph=True)
        row = _train_row("attention_bwd", key, count, max_abs, ok, device_ms(torch, kern),
                         device_ms(torch, plain), a, k)
        row["rel_l2"], row["library_ms"] = rel, device_ms(torch, sdpa)
        rows.append(row)
    for r in rows:
        print(f"{r['kernel']:20s} {r['key']:52s} sites {r['sites']:2d} "
              f"max_abs {r['max_abs_err']:.3e}"
              + (f" rel_l2 {r['rel_l2']:.3e} (<= {ATTN_BWD_REL_L2})" if "rel_l2" in r else "")
              + f" ms {r['ms']:.4f} plain {r['plain_ms']:.4f} bound {r['bound_ms']:.4f} "
              f"({r['bound_by']})"
              + (f" sdpa {r['library_ms']:.4f}" if r["library_ms"] else "")
              + (f" torch_seq {r['torch_seq_ms']:.4f}" if r.get("torch_seq_ms") else "")
              + (f" repeat {'identical' if r['repeat_identical'] else 'DIFFERENT'}"
                 if "repeat_identical" in r else "")
              + (f" plan {r['plan']}" if r["kernel"].startswith("group_norm") else "")
              + ("" if r["ok"] else "  FAIL"), flush=True)
        if not r["ok"]:
            failures.append(f"{r['kernel']} {r['key']}")
    print(f"tolerances: K1 {TOL['group_norm_silu']}, K3 {TOL['attention']}, K2 dx "
          f"{TOL_BWD['dx']} and dγ/dβ/dbias "
          f"{TOL_BWD['vec']} (rtol, atol as a share of the largest reference value), "
          f"attention backward relative L2 <= {ATTN_BWD_REL_L2}", flush=True)
    if failures:
        fail(f"training kernels disagree with their plain versions: {failures}")
    per_step = {}
    for kname in ("group_norm_silu", "group_norm_silu_bwd", "attention", "attention_bwd"):
        rs = [r for r in rows if r["kernel"] == kname]
        per_step[kname] = {f: sum(r[f] * r["sites"] for r in rs)
                           for f in ("ms", "plain_ms", "bound_ms")}
        per_step[kname]["library_ms"] = (sum(r["library_ms"] * r["sites"] for r in rs)
                                         if kname.startswith("attention") else None)
        if kname.startswith("group_norm"):
            per_step[kname]["torch_seq_ms"] = sum(r["torch_seq_ms"] * r["sites"] for r in rs)
        per_step[kname]["max_abs_err"] = max(r["max_abs_err"] for r in rs)
        per_step[kname]["bound_by"] = max(rs, key=lambda r: r["bound_ms"] * r["sites"])[
            "bound_by"]
        print(f"per training step (batch {TRAIN_BATCH}), {kname}: "
              + ", ".join(f"{f} {v:.4f}" for f, v in per_step[kname].items()
                          if isinstance(v, float)) + f" [{card}]", flush=True)
    return {"shapes": rows, "per_step": per_step}


def gn_plan(k_gn, x, groups, backward: bool) -> dict:
    """K1's (or K2's) plan for the recorded input, as a dict."""
    n, h, w, c = x.shape
    return k_gn.gn_plan(n, h, w, c, groups, k_gn.build.sm_count(x.device), backward)._asdict()


def _train_row(kind, key, count, max_abs, ok, ms, plain_ms, a, k) -> dict:
    row = {"kernel": kind, "key": repr(key), "sites": count, "max_abs_err": max_abs, "ok": ok,
           "ms": ms, "plain_ms": plain_ms, "library_ms": None}
    row["bound_ms"], row["bound_by"] = bound_ms(kind, a, k)
    return row


def train_gradient(torch, np, blocks, ddpm_models, init_weights, DDPM, dev, ops) -> dict:
    """Phase 7: one loss_given + backward at batch 8, dropout 0, bf16 on the
    card against f32 on the CPU on the same weights and numpy t, ε."""
    from torch.func import functional_call

    card = ddpm_models.UNet(dtype=torch.bfloat16, dropout=0.0, fused_norm=True,
                            fused_block=True)
    init_weights(card, torch.Generator().manual_seed(SEED))
    randomize_affines(torch, blocks, card, torch.Generator().manual_seed(SEED + 1))
    ref = ddpm_models.UNet(dtype=torch.float32, dropout=0.0, fused_norm=True, fused_block=True)
    ref.load_state_dict(card.state_dict(), strict=True)
    card = card.to(dev)
    algo = DDPM.create(1000)
    r = np.random.default_rng(SEED + 2)
    x0 = torch.tensor(np.clip(r.standard_normal((BATCH, 32, 32, 3)), -1, 1).astype(np.float32))
    t = torch.tensor(r.integers(1, 1000, (BATCH,)), dtype=torch.int64)
    eps = torch.tensor(r.standard_normal((BATCH, 32, 32, 3)).astype(np.float32))

    def loss_and_grads(model, device):
        params = {k: v.detach().to(device).requires_grad_(True)
                  for k, v in model.state_dict().items()}

        def fn(p, x, tt, **kw):
            return functional_call(model, p, (x, tt), kw)

        loss = algo.loss_given(fn, params, x0.to(device), t.to(device), eps.to(device),
                               train=True)
        return loss.detach().cpu(), dict(zip(params, (
            g.cpu() for g in torch.autograd.grad(loss, list(params.values())))))

    reset_counts(ops)
    loss_c, grads_c = loss_and_grads(card, dev)
    torch.cuda.synchronize()
    launches = counts(ops)
    print(f"launches in one training step (loss + backward): {launches}", flush=True)
    expect_no_simt("training step")
    if launches != PER_TRAIN_STEP:
        fail(f"a training step launched {launches}, expected {PER_TRAIN_STEP}")
    bad = [k for k, g in grads_c.items()
           if not bool(g.isfinite().all()) or float(g.abs().max()) == 0.0]
    print(f"parameter tensors with a finite, non-zero gradient on the card: "
          f"{len(grads_c) - len(bad)} of {len(grads_c)}", flush=True)
    if bad:
        fail(f"gradients zero or not finite on the card: {bad[:10]}")
    loss_r, grads_r = loss_and_grads(ref, torch.device("cpu"))
    flat_c = torch.cat([g.float().flatten() for g in grads_c.values()])
    flat_r = torch.cat([grads_r[k].flatten() for k in grads_c])
    out = {"loss_card": float(loss_c), "loss_cpu": float(loss_r),
           "loss_rel_err": abs(float(loss_c) - float(loss_r)) / abs(float(loss_r)),
           "grad_rel_l2": rel_l2(flat_c, flat_r), "launches": launches, "per_module": {}}
    for top in dict.fromkeys(k.split(".")[0] for k in grads_c):
        keys = [k for k in grads_c if k.split(".")[0] == top]
        out["per_module"][top] = rel_l2(torch.cat([grads_c[k].float().flatten() for k in keys]),
                                        torch.cat([grads_r[k].flatten() for k in keys]))
    print(f"loss card {out['loss_card']:.6f} cpu {out['loss_cpu']:.6f} rel err "
          f"{out['loss_rel_err']:.3e}; flattened gradient rel L2 {out['grad_rel_l2']:.3e} "
          f"(<= {GRAD_REL_L2}); TF32 off for matmul and cuDNN", flush=True)
    print("per top-level module: " + ", ".join(f"{k} {v:.2e}"
                                               for k, v in out["per_module"].items()), flush=True)
    if not out["grad_rel_l2"] <= GRAD_REL_L2:
        fail(f"the card's gradient is {out['grad_rel_l2']:.3e} from the CPU's")
    return out


def run_fit(torch, np, blocks, dev, ops, report, card: str) -> tuple:
    """Phase 8: ``fit`` at the recipe's settings, then timed and profiled
    steps of the same train step. Returns (lit, state)."""
    import contextlib

    from dmme_tpu_torch.data import CIFAR10
    from dmme_tpu_torch.parallel import make_train_step
    from dmme_tpu_torch.training import LitDDPM, fit

    lit = LitDDPM(dtype="bf16")  # lr 2e-4, warmup 5000, clip 1.0, EMA 0.9999, flips on
    dm = CIFAR10(synthetic=True, batch_size=TRAIN_BATCH)
    log = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stderr(log):
        state = fit(lit, dm, max_steps=FIT_WARM, log_every=1)
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    print(f"fit: {FIT_WARM} warm steps (init, first launches) in {warm_s:.1f} s", flush=True)

    # one step of the same train step, its updates checked
    step = make_train_step(lit.make_loss_fn(dm))
    it = dm.train_iter(SEED + 7)

    def batch():
        return torch.from_numpy(next(it)).pin_memory().to(dev, non_blocking=True)

    p0 = {k: v.clone() for k, v in state.params.items()}
    e0 = {k: v.clone() for k, v in state.ema_params.items()}
    lr = lit.make_optimizer().schedule(state.opt_state.count)
    state, m = step(state, batch(), SEED)
    deltas = torch.cat([(state.params[k] - p0[k]).abs().flatten() for k in p0])
    unmoved = [k for k in p0 if torch.equal(state.params[k], p0[k])]
    ema_err = max(float(((state.ema_params[k] - (lit.decay * e0[k] + (1 - lit.decay)
                                                 * state.params[k])).abs()
                         / (e0[k].abs() + 1e-12)).max()) for k in e0)
    upd = {"lr": lr, "max_abs_dp": float(deltas.max()), "median_abs_dp": float(deltas.median()),
           "unmoved_tensors": len(unmoved), "ema_max_rel_err": ema_err}
    print(f"one step at lr {lr:.4e}: max |Δp| {upd['max_abs_dp']:.3e}, median |Δp| "
          f"{upd['median_abs_dp']:.3e}, tensors unmoved {len(unmoved)}; EMA = "
          f"decay·ema + (1−decay)·p to {ema_err:.2e} relative", flush=True)
    if unmoved or not (upd["max_abs_dp"] <= 10 * lr and 0.1 * lr <= upd["median_abs_dp"] <= 2 * lr
                       and ema_err <= 1e-5):
        fail(f"the step did not move parameters and EMA by the expected amounts: {upd}")
    del p0, e0

    reset_counts(ops)
    log = io.StringIO()
    with contextlib.redirect_stderr(log):
        state = fit(lit, dm, max_steps=state.step + FIT_STEPS, state=state, log_every=1)
    torch.cuda.synchronize()
    launches = counts(ops)
    expect_no_simt("fit")
    lines = [ln for ln in log.getvalue().splitlines() if ln.startswith("[step")]
    for ln in lines:
        print("  " + ln, flush=True)
    logged = [dict(kv.split("=") for kv in ln.split("] ", 1)[1].split()) for ln in lines]
    bad = [r for r in logged if not all(np.isfinite(float(r[f])) for f in ("loss", "grad_norm"))]
    expect = {k: v * FIT_STEPS for k, v in PER_TRAIN_STEP.items()}
    print(f"fit: {len(logged)} logged steps; launches {launches} (expected {expect})", flush=True)
    if len(logged) != FIT_STEPS or bad:
        fail(f"fit logged {len(logged)} steps, {len(bad)} with a loss or grad_norm not finite")
    if launches != expect:
        fail(f"fit launched {launches}, expected {expect}")

    # timed steps: CUDA events around each step, no host wait between steps
    torch.cuda.reset_peak_memory_stats()
    batches = [batch() for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    pairs, metrics = [], []
    t0 = time.perf_counter()
    for b in batches:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, b, SEED)
        end.record()
        pairs.append((start, end))
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = [s.elapsed_time(e) for s, e in pairs]
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    timing = {"step_ms_median": statistics.median(step_ms), "step_ms_min": min(step_ms),
              "step_ms_max": max(step_ms),
              "imgs_per_sec": TRAIN_BATCH * TIMED_STEPS / wall,
              "imgs_per_sec_from_median": TRAIN_BATCH / (statistics.median(step_ms) / 1e3),
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
              "bound_ms": 1e3 * TRAIN_STEP_TFLOP * 1e12 / BF16_FLOPS,
              "losses": losses, "grad_norms": norms}
    print(f"{TIMED_STEPS} timed steps at batch {TRAIN_BATCH}: step {timing['step_ms_median']:.2f} ms "
          f"median (min {timing['step_ms_min']:.2f}, max {timing['step_ms_max']:.2f}; CUDA "
          f"events), {timing['imgs_per_sec']:.1f} imgs/s (host clock over the run), peak "
          f"memory {timing['peak_mem_gib']:.2f} GiB; step bound {timing['bound_ms']:.2f} ms "
          f"({TRAIN_STEP_TFLOP} TFLOP, bench.py:60-63, at {BF16_FLOPS / 1e12:.0f} TFLOP/s) "
          f"[{card}]", flush=True)
    print("losses " + " ".join(f"{v:.4f}" for v in losses), flush=True)
    print("grad_norms " + " ".join(f"{v:.4f}" for v in norms), flush=True)
    if not all(np.isfinite(losses + norms)):
        fail("a timed step gave a loss or grad_norm that is not finite")
    del batches

    # the device's idle share over three steps, and one step by kernel
    three = [batch() for _ in range(3)]
    one = [batch()]
    holder = {"state": state}

    def run(bs):
        for b in bs:
            holder["state"], _ = step(holder["state"], b, SEED)

    prof3 = profile_fn(torch, lambda: run(three))
    prof1 = profile_fn(torch, lambda: run(one), top_n=16)
    state = holder["state"]
    print(f"3 steps under torch.profiler: wall {prof3['wall_ms']:.2f} ms, device busy "
          f"{prof3['busy_ms']:.2f} ms, idle share {prof3['idle_share']:.3f}", flush=True)
    print(f"1 step by kernel: wall {prof1['wall_ms']:.2f} ms, device busy "
          f"{prof1['busy_ms']:.2f} ms in {prof1['device_ops']} kernels, copies and memsets, "
          f"idle share {prof1['idle_share']:.3f}; against the unprofiled median step "
          f"{1.0 - prof3['busy_ms'] / 3 / timing['step_ms_median']:.3f} [{card}]", flush=True)
    for name, ms, count in prof1["top"]:
        print(f"    {ms:9.3f} ms {count:6d}x  {name}", flush=True)
    report["fit"] = {"warm_s": warm_s, "update": upd, "logged": logged, "launches": launches,
                     "timing": timing, "profile_3_steps": prof3, "profile_1_step": prof1}
    return lit, state


def sample_after_training(torch, k_res, lit, state, dev, ops) -> dict:
    """Phase 9: DDIM-50 n = 8 from the trained raw weights through K4, equal
    byte for byte after K4's weight cache is cleared."""
    from dmme_tpu_torch.training import LitDDIM

    ddim = LitDDIM(model=lit.model)  # T=1000, DDIM-50, quadratic τ

    def draw():
        gen = torch.Generator(device=dev).manual_seed(11)
        return ddim.generate(state, gen, (8, 32, 32, 3), use_ema=False)

    reset_counts(ops)
    a = draw()
    torch.cuda.synchronize()
    launches = counts(ops)
    expect_no_simt("sampling after training")
    k_res._PACKED.clear()
    b = draw()
    torch.cuda.synchronize()
    same = bool(torch.equal(a, b))
    ok = same and tuple(a.shape) == (8, 32, 32, 3) and bool(a.isfinite().all())
    print(f"DDIM-50 n=8 from the trained raw weights: shape {tuple(a.shape)}, std "
          f"{float(a.std()):.4f}, launches {launches}; after clearing K4's weight cache: "
          f"{'identical bytes' if same else 'DIFFERENT'}", flush=True)
    if launches["resblock"] != 22 * ddim.diffusion_model.sub_timesteps:
        fail(f"sampling launched {launches}, expected 22 K4 calls per step")
    if not ok:
        fail("sampling after training is not repeatable through K4's weight cache")
    return {"launches": launches, "identical": same}


def _rows_report(rows, title: str) -> None:
    """Print one line a checked call; fail if any disagreed."""
    for r in rows:
        print(f"{r['kernel']:20s} {r['key']:60s} max_abs {r['max_abs_err']:.3e}"
              + ("" if r["ok"] else "  FAIL"), flush=True)
    failures = [f"{r['kernel']} {r['key']}" for r in rows if not r["ok"]]
    if failures:
        fail(f"{title}: kernels disagree with their plain versions: {failures}")


def offpath_kernels(torch, k_gn, k_attn, k_res, dev) -> list:
    """Phase 6b: K1, K2, K3 and K4 at shapes off the main path, random
    inputs from a seed, each held against its plain version on the card
    (K1 and K2 also called twice for identical bytes)."""
    gen = torch.Generator().manual_seed(SEED + 20)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(shape, generator=gen)).to(device=dev, dtype=dtype)

    rows = []
    with torch.no_grad():
        # K1 and K2: C/G = 3, a 12x12 image, C = 1024, and samples that no
        # cluster holds (two passes); per-sample affines and pre-biases
        for n, h, w, c, per_sample, with_bias in ((4, 8, 8, 96, True, True),
                                                  (2, 12, 12, 64, False, True),
                                                  (2, 16, 16, 1024, True, False),
                                                  (3, 32, 32, 512, True, True),
                                                  (2, 64, 64, 256, False, True),
                                                  (1, 256, 256, 128, True, True)):
            aff = (n, c) if per_sample else (c,)
            x = rnd(n, h, w, c, dtype=torch.bfloat16)
            gamma, beta = 1.0 + rnd(*aff, scale=0.1), rnd(*aff, scale=0.1)
            bias = rnd(n, c, scale=0.5) if with_bias else None
            key = repr(((n, h, w, c), per_sample, with_bias))
            y, mean, inv = k_gn.group_norm_silu_fwd(x, gamma, beta, 32, pre_bias=bias)
            again = k_gn.group_norm_silu_fwd(x, gamma, beta, 32, pre_bias=bias)
            y_p, mean_p, inv_p = k_gn.gn_silu_plain(x, gamma, beta, bias, 32)
            max_abs, _, ok = errors(y, y_p, *TOL["group_norm_silu"])
            for got, want in ((mean, mean_p), (inv, inv_p)):
                ok = ok and scaled_errors(got, want, *TOL_BWD["vec"])[2]
            same = all(bool(torch.equal(u, v)) for u, v in zip((y, mean, inv), again))
            rows.append({"kernel": "group_norm_silu", "key": key, "max_abs_err": max_abs,
                         "ok": ok and same, "repeat_identical": same,
                         "plan": k_gn.gn_plan(n, h, w, c, 32, k_gn.build.sm_count(dev))._asdict()})
            dz = rnd(n, h, w, c, dtype=torch.bfloat16)
            args = (x, dz, gamma, beta, bias, mean, inv, 32)
            got, again = k_gn.group_norm_silu_bwd(*args), k_gn.group_norm_silu_bwd(*args)
            max_abs, ok = 0.0, True
            for name, g_, w_ in zip(("dx", "dgamma", "dbeta", "dbias"), got,
                                    k_gn.gn_silu_bwd_plain(*args)):
                e_abs, _, e_ok = scaled_errors(g_, w_, *TOL_BWD["dx" if name == "dx" else "vec"])
                max_abs, ok = max(max_abs, e_abs), ok and e_ok
            same = all(bool(torch.equal(u, v)) for u, v in zip(got, again))
            rows.append({"kernel": "group_norm_silu_bwd", "key": key, "max_abs_err": max_abs,
                         "ok": ok and same, "repeat_identical": same,
                         "plan": k_gn.gn_plan(n, h, w, c, 32, k_gn.build.sm_count(dev),
                                              True)._asdict()})
        # K3: head dims off the 64-wide panels, 512, ragged T, a key split at a
        # padded head dim; q, k, v strided views of a packed projection
        for n, t, hh, d in ((2, 100, 4, 16), (2, 100, 4, 48), (2, 100, 2, 96),
                            (1, 1024, 1, 96), (2, 100, 2, 160), (2, 77, 1, 512),
                            (1, 64, 1, 512), (1, 256, 1, 512)):
            qkv = rnd(n, t, 3, hh, d, dtype=torch.bfloat16)
            q, kk, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            scale = (hh * d) ** -0.5
            got = k_attn.attention_heads(q, kk, v, scale)
            max_abs, _, ok = errors(got, k_attn.attention_heads_plain(q, kk, v, scale),
                                    *TOL["attention"])
            rows.append({"kernel": "attention", "key": repr((n, t, hh, d)), "max_abs_err": max_abs,
                         "ok": ok, "plan": attention_plan(k_attn, q)})
        # K4: C_in 32 and 96, C_out 32, 64 and 192, H x W that whole 64-pixel
        # rows do not tile (6x6, 12x20), identity and projection skips
        for n, h, w, cin, cout in ((2, 8, 8, 32, 64), (2, 8, 8, 96, 192), (2, 6, 6, 64, 64),
                                   (1, 12, 20, 128, 128), (2, 8, 8, 32, 32),
                                   (1, 16, 16, 96, 64)):
            x = rnd(n, h, w, cin, dtype=torch.bfloat16)
            g1, b1v = 1.0 + rnd(n, cin, scale=0.1), rnd(n, cin, scale=0.1)
            pre2, g2, b2v = rnd(n, cout, scale=0.5), 1.0 + rnd(n, cout, scale=0.1), rnd(
                n, cout, scale=0.1)
            w1, w2 = rnd(cout, cin, 3, 3, scale=(9 * cin) ** -0.5), rnd(
                cout, cout, 3, 3, scale=(9 * cout) ** -0.5)
            b1, b2 = rnd(cout, scale=0.1), rnd(cout, scale=0.1)
            wr, br = ((rnd(cout, cin, 1, 1, scale=cin ** -0.5), rnd(cout, scale=0.1))
                      if cin != cout else (None, None))
            pa = (x, g1, b1v, pre2, g2, b2v, w1, b1, w2, b2, wr, br, 32, k_gn.GN_EPS)
            got = k_res.resblock_forward(*pa[:10], wr=wr, br=br, num_groups=32)
            max_abs, _, ok = errors(got, k_res.resblock_plain(*pa), *TOL["resblock"])
            p1 = k_res.conv_plan(n, h, w, cin, cout, 0, k_res.build.sm_count(dev))
            rows.append({"kernel": "resblock", "key": repr(((n, h, w, cin), cout, wr is not None)),
                         "max_abs_err": max_abs, "ok": ok, "plan": p1._asdict()})
    torch.cuda.synchronize()
    _rows_report(rows, "off-path shapes")
    print(f"off-path shapes: {len(rows)} calls within TOL {TOL} and K2 {TOL_BWD} (K1's mean "
          f"and inverse std within {TOL_BWD['vec']}); K1 and K2 repeat byte for byte", flush=True)
    return rows


def lsun_forward(torch, blocks, ddpm_models, init_weights, k_gn, k_attn, k_res, ops,
                 dev) -> dict:
    """Phase 4b: one UNet forward at the LSUN widths at batch 1, both switches
    on: every K1, K3 and K4 call held against its plain version on its
    recorded inputs, then the bf16 output against the same module and
    weights in f32 on the CPU."""
    m = ddpm_models.UNet(dtype=torch.bfloat16, fused_norm=True, fused_block=True, **LSUN_WIDTHS)
    init_weights(m, torch.Generator().manual_seed(SEED))
    randomize_affines(torch, blocks, m, torch.Generator().manual_seed(SEED + 1))
    ref = ddpm_models.UNet(dtype=torch.float32, fused_norm=True, fused_block=True, **LSUN_WIDTHS)
    ref.load_state_dict(m.state_dict(), strict=True)
    m = m.to(dev).eval()
    gen = torch.Generator().manual_seed(SEED + 30)
    x = torch.randn((1, LSUN_IMG, LSUN_IMG, 3), generator=gen)
    t = torch.randint(1, 1000, (1,), generator=gen)
    with torch.no_grad():
        reset_counts(ops)
        out = {}
        calls = record_calls(serve_targets(blocks),
                             lambda: out.setdefault("y", m(x.to(dev), t.to(dev))))
        torch.cuda.synchronize()
        launches = counts(ops)
        expect_no_simt("LSUN-width forward")
        rows = []
        plain = {"group_norm_silu": lambda a, k: k_gn.gn_silu_plain(
                     a[0], a[1], a[2], k.get("pre_bias"), a[3], k.get("eps", k_gn.GN_EPS))[0],
                 "attention": lambda a, k: k_attn.attention_heads_plain(*a, **k),
                 "resblock": lambda a, k: k_res.resblock_plain(
                     *a, k.get("wr"), k.get("br"), k.get("num_groups", 32),
                     k.get("eps", k_gn.GN_EPS))}
        kernel = {"group_norm_silu": k_gn.group_norm_silu, "attention": k_attn.attention_heads,
                  "resblock": k_res.resblock_forward}
        for kind_, lst in calls.items():
            for key, count, a, k in lst:
                max_abs, _, ok = errors(kernel[kind_](*a, **k), plain[kind_](a, k), *TOL[kind_])
                rows.append({"kernel": kind_, "key": repr(key), "sites": count,
                             "max_abs_err": max_abs, "ok": ok})
        _rows_report(rows, "LSUN widths")
        want = ref(x, t)
    got = out["y"].float().cpu()
    rel = rel_l2(got, want)
    ok = bool(got.isfinite().all()) and got.shape == want.shape and rel <= UNET_REL_L2
    sites = {k: sum(c for _, c, _, _ in v) for k, v in calls.items()}
    print(f"LSUN widths, batch 1, {LSUN_IMG}x{LSUN_IMG}: shape {tuple(got.shape)} rel_l2 "
          f"{rel:.3e} (<= {UNET_REL_L2}) launches {launches} call sites {sites}"
          + ("" if ok else "  FAIL"), flush=True)
    if not ok:
        fail("UNet forward at the LSUN widths disagrees with the f32 CPU reference")
    if {k: launches[k] for k in sites} != sites:
        fail(f"the LSUN forward launched {launches} for call sites {sites}")
    return {"rel_l2": rel, "launches": launches, "sites": sites, "shapes": rows}


def simt_rows(torch, k_gn, k_attn, k_res, calls, dtype) -> list:
    """The f32/fp16 kernels of ``simt.cu`` at every recorded call site, each
    held against its plain version on the same inputs (``TOL_SIMT``, atol a
    share of the largest reference value), timed, bounded, and called twice
    for identical bytes. K3 is timed beside SDPA on the same inputs."""
    rtol, share, least = TOL_SIMT[str(dtype)]
    rows = []
    with torch.no_grad():
        for kind, lst in calls.items():
            for key, count, a, k in lst:
                if kind == "group_norm_silu":
                    kern = lambda a=a, k=k: k_gn.group_norm_silu(*a, **k)  # noqa: E731
                    plain = lambda a=a, k=k: k_gn.gn_silu_plain(  # noqa: E731
                        a[0], a[1], a[2], k.get("pre_bias"), a[3], k.get("eps", k_gn.GN_EPS))[0]
                elif kind == "group_norm_silu_bwd":
                    kern = lambda a=a: k_gn.group_norm_silu_bwd(*a)  # noqa: E731
                    plain = lambda a=a: k_gn.gn_silu_bwd_plain(*a)  # noqa: E731
                elif kind == "attention":
                    kern = lambda a=a: k_attn.attention_heads(*a)  # noqa: E731
                    plain = lambda a=a: k_attn.attention_heads_plain(*a)  # noqa: E731
                elif kind == "resblock":
                    pa = list(a) + [k.get("wr"), k.get("br"), k.get("num_groups", 32),
                                    k.get("eps", k_gn.GN_EPS)]
                    kern = lambda a=a, k=k: k_res.resblock_forward(*a, **k)  # noqa: E731
                    plain = lambda pa=pa: k_res.resblock_plain(*pa)  # noqa: E731
                else:  # the attention backward is torch ops in every dtype
                    continue
                got = kern()
                torch.cuda.synchronize()
                want = plain()
                got, want = ((got, want) if isinstance(got, tuple) else ((got,), (want,)))
                max_abs, ok = 0.0, True
                for g_, w_ in zip(got, want):
                    atol = max(share * float(w_.float().abs().max()), least)
                    e_abs, _, e_ok = errors(g_, w_, rtol, atol)
                    max_abs, ok = max(max_abs, e_abs), ok and e_ok and g_.dtype == w_.dtype
                again = kern()
                same = all(bool(torch.equal(g_, h_)) for g_, h_ in
                           zip(got, again if isinstance(again, tuple) else (again,)))
                row = _train_row(kind, key, count, max_abs, ok and same, device_ms(torch, kern),
                                 device_ms(torch, plain), a, k)
                row["repeat_identical"] = same
                if kind == "attention":
                    q, kk, v, scale = a
                    row["library_ms"] = device_ms(
                        torch, lambda q=q, kk=kk, v=v, scale=scale:
                        torch.nn.functional.scaled_dot_product_attention(
                            q.transpose(1, 2), kk.transpose(1, 2), v.transpose(1, 2),
                            scale=scale))
                rows.append(row)
    for r in rows:
        print(f"{str(dtype)[6:]:8s} {r['kernel']:20s} {r['key']:52s} sites {r['sites']:2d} "
              f"max_abs {r['max_abs_err']:.3e} ms {r['ms']:.4f} plain {r['plain_ms']:.4f} "
              f"bound {r['bound_ms']:.4f} ({r['bound_by']})"
              + (f" sdpa {r['library_ms']:.4f}" if r["library_ms"] else "")
              + f" repeat {'identical' if r['repeat_identical'] else 'DIFFERENT'}"
              + ("" if r["ok"] else "  FAIL"), flush=True)
    bad = [f"{r['kernel']} {r['key']}" for r in rows if not r["ok"]]
    if bad:
        fail(f"the {dtype} kernels disagree with their plain versions (rtol {rtol}, atol "
             f"{share} of the largest reference value, at least {least}): {bad}")
    return rows


def per_site_sum(rows, kind: str) -> dict:
    """Times and bounds of ``kind``'s rows summed over their call sites."""
    rs = [r for r in rows if r["kernel"] == kind]
    out = {f: sum(r[f] * r["sites"] for r in rs) for f in ("ms", "plain_ms", "bound_ms")}
    out["library_ms"] = (sum(r["library_ms"] * r["sites"] for r in rs)
                         if kind == "attention" else None)
    out["max_abs_err"] = max(r["max_abs_err"] for r in rs)
    out["bound_by"] = max(rs, key=lambda r: r["bound_ms"] * r["sites"])["bound_by"]
    return out


def f32_phase(torch, np, blocks, init_weights, k_gn, k_attn, k_res, dev, ops,
              card: str) -> dict:
    """Phase 10: the default harness in f32 (fault C.5), then fp16. For each
    dtype, one full-width ``LitDDPM`` training step at batch 128 and one
    ``LitDDIM`` DDIM step at n = 8 on the card, launching K1/K2/K3 (45/45/6)
    and K1/K3/K4 (1/6/22) of ``simt.cu`` and no bf16 kernel, every call site
    held against its plain version (:func:`simt_rows`). Then, dropout off, the
    loss and gradient of one step and one UNet forward (the DDIM step's ε
    prediction) on the same weights and inputs against f32 on the CPU: f32
    within ``F32_REL_L2``, fp16's forward within ``UNET_REL_L2``; the bf16 harness on
    the same weights and inputs is the control that must miss ``F32_REL_L2``.
    The DDIM step's output is held to the same limits."""
    from dmme_tpu_torch.data import CIFAR10
    from dmme_tpu_torch.parallel import make_train_step
    from dmme_tpu_torch.training import LitDDIM, LitDDPM

    want_train = {"group_norm_silu": 45, "group_norm_silu_bwd": 45, "attention": 6,
                  "resblock": 0}
    want_ddim = {"group_norm_silu": 1, "group_norm_silu_bwd": 0, "attention": 6, "resblock": 22}
    none = {k: 0 for k in ops}
    r = np.random.default_rng(SEED + 40)
    x0 = torch.tensor(np.clip(r.standard_normal((TRAIN_BATCH, 32, 32, 3)), -1, 1),
                      dtype=torch.float32)
    t = torch.tensor(r.integers(1, 1000, (TRAIN_BATCH,)), dtype=torch.int64)
    eps = torch.tensor(r.standard_normal((TRAIN_BATCH, 32, 32, 3)), dtype=torch.float32)
    xs = torch.tensor(r.standard_normal((BATCH, 32, 32, 3)), dtype=torch.float32)
    ts = torch.full((BATCH,), 980, dtype=torch.int64)
    dm = CIFAR10(synthetic=True, synthetic_size=2 * TRAIN_BATCH, batch_size=TRAIN_BATCH)
    dm.setup("fit")
    batch = torch.from_numpy(next(dm.train_iter(SEED))).to(dev)
    weights = None
    out = {}

    def measure(lit, device):
        """Loss and flat gradient of one step (dropout off), the UNet's ε
        prediction at (xs, ts) and one DDIM step from xs, on ``device``."""
        params = {k: v.to(device).requires_grad_(True) for k, v in weights.items()}
        loss = lit.diffusion_model.loss_given(lit.model_fn, params, x0.to(device), t.to(device),
                                              eps.to(device), train=True)
        grads = torch.autograd.grad(loss, list(params.values()))
        ddim = LitDDIM(model=lit.model)  # the same module, T=1000, DDIM-50
        with torch.no_grad():
            p = {k: v.detach() for k, v in params.items()}
            pred = lit.model_fn(p, xs.to(device), ts.to(device))
            step = ddim.diffusion_model.sampling_step(ddim.model_fn, p, xs.to(device), 50)
        return {"loss": loss.detach().cpu(),
                "grad": torch.cat([g.detach().float().flatten().cpu() for g in grads]),
                "pred": pred.float().cpu(), "step": step.float().cpu()}

    def readings(got, ref) -> dict:
        return {"loss_rel_err": float(abs(got["loss"] - ref["loss"]) / abs(ref["loss"])),
                "grad_rel_l2": rel_l2(got["grad"], ref["grad"]),
                "pred_rel_l2": rel_l2(got["pred"], ref["pred"]),
                "step_rel_l2": rel_l2(got["step"], ref["step"])}

    ref = None
    for name in ("f32", "fp16"):
        lit = LitDDPM() if name == "f32" else LitDDPM(dtype="fp16")  # dropout 0.1
        dtype = lit.model.dtype
        if weights is None:
            init_weights(lit.model, torch.Generator().manual_seed(SEED))
            randomize_affines(torch, blocks, lit.model, torch.Generator().manual_seed(SEED + 1))
            weights = {k: v.detach().clone() for k, v in lit.model.state_dict().items()}
        state = lit.init_state(SEED, device=dev)
        with torch.no_grad():
            for k, v in state.params.items():
                v.copy_(weights[k])
        step_fn = make_train_step(lit.make_loss_fn(dm))
        metrics = {}

        def train(state=state, step_fn=step_fn):
            metrics.update(step_fn(state, batch, SEED)[1])
            torch.cuda.synchronize()

        reset_counts(ops)
        calls = record_calls(train_targets(blocks, k_gn, k_attn), train)
        loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
        rec = {"dtype": str(dtype), "train": {"loss": loss, "grad_norm": grad_norm,
                                              "launches": counts(ops), "simt": simt_counts()}}
        print(f"LitDDPM({'' if name == 'f32' else 'dtype=' + repr(name)}) one training step at "
              f"batch {TRAIN_BATCH} on the card ({dtype}): loss {loss:.6f} grad_norm "
              f"{grad_norm:.4f}; bf16 kernel launches {rec['train']['launches']}; simt.cu "
              f"launches {rec['train']['simt']}", flush=True)
        if not (np.isfinite(loss) and np.isfinite(grad_norm)):
            fail(f"the {name} training step gave a loss or grad_norm that is not finite")
        if rec["train"]["launches"] != none or rec["train"]["simt"] != want_train:
            fail(f"the {name} step launched {rec['train']['launches']} bf16 and "
                 f"{rec['train']['simt']} simt.cu kernels, expected none and {want_train}")

        for mod in lit.model.modules():  # dropout off: the card and the CPU draw other masks
            if isinstance(mod, blocks.ResBlock):
                mod.dropout = 0.0
        lit.model.to(dev)
        ddim = LitDDIM(model=lit.model)
        p_dev = {k: v.to(dev) for k, v in weights.items()}
        reset_counts(ops)
        with torch.no_grad():
            sample_calls = record_calls(
                serve_targets(blocks),
                lambda: ddim.diffusion_model.sampling_step(ddim.model_fn, p_dev, xs.to(dev), 50))
        torch.cuda.synchronize()
        rec["ddim_step"] = {"launches": counts(ops), "simt": simt_counts()}
        print(f"LitDDIM() one DDIM step at n={BATCH} ({dtype}): bf16 kernel launches "
              f"{rec['ddim_step']['launches']}; simt.cu launches {rec['ddim_step']['simt']}",
              flush=True)
        if rec["ddim_step"]["launches"] != none or rec["ddim_step"]["simt"] != want_ddim:
            fail(f"the {name} DDIM step launched {rec['ddim_step']['launches']} bf16 and "
                 f"{rec['ddim_step']['simt']} simt.cu kernels, expected none and {want_ddim}")
        rows = simt_rows(torch, k_gn, k_attn, k_res, calls, dtype)
        rows_ddim = simt_rows(torch, k_gn, k_attn, k_res, sample_calls, dtype)
        del calls, sample_calls
        rec["rows"], rec["rows_ddim"] = rows, rows_ddim
        # K1, K2 and K3 summed over a training step's call sites; K4 over a
        # DDIM forward's at n = 8
        rec["per_path"] = {kind: per_site_sum(rows, kind)
                           for kind in ("group_norm_silu", "group_norm_silu_bwd", "attention")}
        rec["per_path"]["resblock"] = per_site_sum(rows_ddim, "resblock")
        for kind, v in rec["per_path"].items():
            print(f"{name} {kind} summed over its call sites: ms {v['ms']:.4f} plain "
                  f"{v['plain_ms']:.4f} bound {v['bound_ms']:.4f} ({v['bound_by']})"
                  + (f" sdpa {v['library_ms']:.4f}" if v["library_ms"] else "")
                  + f" [{card}]", flush=True)

        reset_counts(ops)
        got = measure(lit, dev)
        torch.cuda.synchronize()
        if not all(bool(v.isfinite().all()) for v in got.values()):
            fail(f"the {name} step, forward or DDIM step on the card is not finite")
        if ref is None:
            cpu = LitDDPM()
            cpu.model.load_state_dict(weights)
            for mod in cpu.model.modules():
                if isinstance(mod, blocks.ResBlock):
                    mod.dropout = 0.0
            ref = measure(cpu, torch.device("cpu"))
        rec["vs_cpu"] = readings(got, ref)
        # fp16 without loss scaling: gradients of order 1/numel fall below
        # fp16's normal range, so its loss and gradient are reported, not held
        held = (("loss_rel_err", "grad_rel_l2", "pred_rel_l2", "step_rel_l2") if name == "f32"
                else ("pred_rel_l2", "step_rel_l2"))
        limit = F32_REL_L2 if name == "f32" else UNET_REL_L2
        print(f"{name} card vs f32 CPU: " + ", ".join(f"{k} {v:.3e}"
                                                     for k, v in rec["vs_cpu"].items())
              + f" ({', '.join(held)} <= {limit})", flush=True)
        if not all(rec["vs_cpu"][k] <= limit for k in held):
            fail(f"the {name} harness on the card disagrees with the f32 CPU reference")
        out[name] = rec
        del lit, state, p_dev
        torch.cuda.empty_cache()

    # the control: the bf16 harness on the same weights and inputs, through the
    # same comparison, must miss F32_REL_L2 (the f32 check would see bf16 compute)
    lit = LitDDPM(dtype="bf16")
    lit.model.load_state_dict(weights)
    for mod in lit.model.modules():
        if isinstance(mod, blocks.ResBlock):
            mod.dropout = 0.0
    lit.model.to(dev)
    out["bf16_control"] = readings(measure(lit, dev), ref)
    print("bf16 control, card vs f32 CPU: " + ", ".join(
        f"{k} {v:.3e}" for k, v in out["bf16_control"].items())
        + f" (the f32 limit {F32_REL_L2} must reject the gradient and the forward)", flush=True)
    if not (out["bf16_control"]["grad_rel_l2"] > F32_REL_L2
            and out["bf16_control"]["pred_rel_l2"] > F32_REL_L2):
        fail("the f32 comparison does not tell bf16 compute from f32")
    return out


CLI_ROOT = os.path.join("build", "cli_run")


def _cli_callback(root: str) -> str:
    """GenerateImage every 10 steps into ``<root>/samples``, as a YAML value
    that replaces the config's callback list."""
    return ("[{class_path: dmme_tpu.callbacks.GenerateImage, init_args: {imgsize: [3, 32, 32], "
            f"every_n_steps: 10, out_dir: {root}/samples}}}}]")


def _jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def cli_phase(torch, np, ops, dev, card: str) -> dict:
    """Phase 9b: the command line in this process (so the counters read its
    launches), ``dmme_tpu_torch.trainer.main``, on the repo's configs: fit at
    full width with checkpoints, JSONL, TensorBoard and GenerateImage grids;
    a resume to step 30 against an uninterrupted 30-step run, bit for bit;
    sample and predict from the resumed checkpoint, predict against
    ``generate`` on a state restored in place; the Shapes recipe in chunks
    of 10 steps; the LSUN widths at 256 px with and without remat."""
    import shutil

    from dmme_tpu_torch import config as tcfg
    from dmme_tpu_torch.callbacks import GenerateImage
    from dmme_tpu_torch.parallel.train_step import step_generator
    from dmme_tpu_torch.trainer import main as cli
    from dmme_tpu_torch.training import CheckpointManager
    from dmme_tpu_torch.utils.norm import denorm

    torch.backends.cudnn.deterministic = True
    print("cudnn deterministic on for the CLI phase", flush=True)
    roots = {k: os.path.join("build", k) for k in ("cli_run", "cli_run_whole", "cli_shapes",
                                                      "cli_remat", "cli_noremat")}
    for root in roots.values():
        shutil.rmtree(root, ignore_errors=True)
    ddim_cfg = ["--config", "configs/ddim/cifar10.yaml", "--data.init_args.synthetic", "true"]
    fit_args = ddim_cfg + ["--trainer.ckpt_every_n_steps", "10", "--trainer.log_every_n_steps",
                           "10", "--trainer.tensorboard", "true"]
    out = {}
    sample_steps, gens = 50, {20: 3, 30: 4}

    def run(name, argv, want=None):
        reset_counts(ops)
        torch.cuda.synchronize()
        t0 = time.time()
        cli(argv)
        torch.cuda.synchronize()
        rec = {"wall_s": time.time() - t0, "launches": counts(ops), "simt": simt_counts()}
        print(f"{name}: {rec['wall_s']:.2f} s wall, launches {rec['launches']}, f32/fp16 "
              f"launches {rec['simt']} [{card}]", flush=True)
        if any(rec["simt"].values()):
            fail(f"{name}: a bf16 path launched the f32/fp16 kernels")
        if want is not None and rec["launches"] != want:
            fail(f"{name} launched {rec['launches']}, expected {want}")
        out[name] = rec
        return rec

    def fit_launches(steps, generations):
        """K1/K2/K3 per training step and K1/K3/K4 per DDIM-50 forward of the grids."""
        fwd = sample_steps * generations
        return {"group_norm_silu": 45 * steps + fwd, "group_norm_silu_bwd": 45 * steps,
                "attention": 6 * steps + 6 * fwd, "resblock": 22 * fwd}

    root = roots["cli_run"]
    rec = run("fit 20", ["fit", *fit_args, "--trainer.max_steps", "20",
                         "--trainer.default_root_dir", root,
                         "--trainer.callbacks", _cli_callback(root)], fit_launches(20, 3))
    logged = _jsonl(os.path.join(root, "metrics.jsonl"))
    step_ms = [1e3 * TRAIN_BATCH / r["imgs_per_sec"] for r in logged]
    rec["logged_steps"], rec["step_ms_from_jsonl"] = [r["step"] for r in logged], step_ms
    grids = sorted(os.listdir(os.path.join(root, "samples")))
    tb = [f for f in os.listdir(os.path.join(root, "tb")) if f.startswith("events.out")]
    rec.update(checkpoints=CheckpointManager(root).steps(), grids=grids, tb_files=tb)
    print(f"fit 20: checkpoints {rec['checkpoints']}, JSONL steps {rec['logged_steps']} (losses "
          f"{[round(r['loss'], 5) for r in logged]}), TensorBoard {tb}, grids {grids}; step ms "
          f"from the JSONL imgs_per_sec {[round(v, 2) for v in step_ms]} (median "
          f"{statistics.median(step_ms):.2f}; a window holds the checkpoint and grid of its "
          f"first step) [{card}]", flush=True)
    if (rec["checkpoints"] != [10, 20] or rec["logged_steps"] != [10, 20] or len(tb) != 1
            or grids != ["step_00000010.png", "step_00000020.png"]
            or not all(np.isfinite(r["loss"]) for r in logged)):
        fail(f"fit through the CLI left {rec}")

    run("resume 20 -> 30", ["fit", *fit_args, "--trainer.max_steps", "30", "--trainer.resume",
                            "true", "--trainer.default_root_dir", root,
                            "--trainer.callbacks", _cli_callback(root)], fit_launches(10, 2))
    whole = roots["cli_run_whole"]
    run("uninterrupted 30", ["fit", *fit_args, "--trainer.max_steps", "30",
                             "--trainer.default_root_dir", whole,
                             "--trainer.callbacks", _cli_callback(whole)], fit_launches(30, 4))
    a, b = CheckpointManager(root).load(30), CheckpointManager(whole).load(30)
    differ = [f"{part}.{k}" for part, x, y in (
        ("params", a["params"], b["params"]), ("ema_params", a["ema_params"], b["ema_params"]),
        ("mu", a["opt_state"]["mu"], b["opt_state"]["mu"]),
        ("nu", a["opt_state"]["nu"], b["opt_state"]["nu"])) for k in x if not torch.equal(x[k], y[k])]
    same_counts = (a["step"], a["opt_state"]["count"]) == (b["step"], b["opt_state"]["count"])
    out["resume_bitwise"] = {"differing_tensors": len(differ), "first": differ[:8],
                             "step_and_count_equal": same_counts}
    print(f"resumed vs uninterrupted at step 30: {len(differ)} of "
          f"{4 * len(a['params'])} tensors differ {differ[:8]}; step and Adam count equal: "
          f"{same_counts}", flush=True)
    if differ or not same_counts:
        fail(f"the resumed run is not bitwise the uninterrupted one: {differ[:8]}")

    run("sample", ["sample", *ddim_cfg, "--trainer.default_root_dir", root])
    png = os.path.join(root, "samples", "step_00000030.png")
    run("predict", ["predict", *ddim_cfg, "--trainer.default_root_dir", root,
                    "--trainer.predict_batch", str(BATCH)])
    pred = np.load(os.path.join(root, "predictions", "pred_00000.npy"))
    # generate() on a state that sampled with other weights first (K4 packs
    # them), then had the checkpoint restored into its tensors in place
    config = tcfg.validate_config(tcfg.apply_overrides(tcfg.load_config(ddim_cfg[1]),
                                                       ddim_cfg[2:]))
    lit = tcfg.instantiate(config["model"])
    state = lit.init_state(0, device=dev)
    shape = (BATCH, 32, 32, 3)
    lit.generate(state, step_generator(1337, 0, dev), shape)
    CheckpointManager(root).restore(state)
    want = denorm(lit.generate(state, step_generator(1337, 0, dev), shape)).float().cpu()
    same = pred.tobytes() == want.numpy().tobytes()
    out["predict"] = {"png": os.path.exists(png), "shape": list(pred.shape),
                      "min": float(pred.min()), "max": float(pred.max()), "identical": same}
    print(f"sample: {png} written {out['predict']['png']}; predict: {pred.shape} in "
          f"[{pred.min():.4f}, {pred.max():.4f}], bytes equal to generate() on the restored "
          f"state: {same}", flush=True)
    if not (out["predict"]["png"] and pred.shape == shape and pred.min() >= 0.0
            and pred.max() <= 1.0 and same):
        fail(f"sample/predict from the resumed checkpoint: {out['predict']}")
    # what the loop's cadences cost at full width: one checkpoint, one grid
    timed = os.path.join(root, "timed")
    t0 = time.time()
    CheckpointManager(timed).save(30, state)
    save_s = time.time() - t0
    nbytes = os.path.getsize(os.path.join(timed, "30", "state.pt"))
    torch.cuda.synchronize()
    t0 = time.time()
    GenerateImage(imgsize=(3, 32, 32), out_dir=timed).generate_and_save(30, lit, state)
    torch.cuda.synchronize()
    out["cadence_cost"] = {"checkpoint_s": save_s, "checkpoint_bytes": nbytes,
                           "grid_s": time.time() - t0}
    print(f"one checkpoint save {save_s:.3f} s ({nbytes / 2**20:.1f} MiB); one GenerateImage "
          f"grid (DDIM-50, n = 8, 10 frames) {out['cadence_cost']['grid_s']:.3f} s [{card}]",
          flush=True)
    del state, lit
    torch.cuda.empty_cache()

    shapes = roots["cli_shapes"]
    rec = run("shapes_demo 20", ["fit", "--config", "configs/ddpm/shapes_demo.yaml",
                                 "--trainer.max_steps", "20", "--trainer.log_every_n_steps",
                                 "10", "--trainer.default_root_dir", shapes],
              fit_launches(20, 0))
    logged = _jsonl(os.path.join(shapes, "metrics.jsonl"))
    rec["losses"] = [r["loss"] for r in logged]
    rec["checkpoints"] = CheckpointManager(shapes).steps()
    print(f"shapes_demo (steps_per_call 10): checkpoints {rec['checkpoints']}, losses "
          f"{rec['losses']}", flush=True)
    if rec["checkpoints"] != [20] or len(logged) != 2 or not np.isfinite(rec["losses"]).all():
        fail(f"shapes_demo through the CLI left {rec}")

    peaks = {}
    for name, remat in (("cli_remat", "true"), ("cli_noremat", "false")):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rec = run(f"shapes256_demo remat {remat}", [
            "fit", "--config", "configs/ddpm/shapes256_demo.yaml", "--trainer.max_steps", "2",
            "--trainer.steps_per_call", "1", "--trainer.log_every_n_steps", "1",
            "--trainer.default_root_dir", roots[name],
            "--model.init_args.model.init_args.remat", remat])
        peaks[remat] = rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        rec["losses"] = [r["loss"] for r in _jsonl(os.path.join(roots[name], "metrics.jsonl"))]
        print(f"shapes256_demo (LSUN widths, 256 px, batch 16) remat {remat}: peak memory "
              f"{rec['peak_gib']:.3f} GiB, losses {rec['losses']} [{card}]", flush=True)
        if len(rec["losses"]) != 2 or not np.isfinite(rec["losses"]).all():
            fail(f"shapes256_demo remat {remat} left {rec}")
    if not peaks["true"] < peaks["false"]:
        fail(f"remat did not lower the peak memory: {peaks}")
    for root in roots.values():
        shutil.rmtree(root, ignore_errors=True)
    return out


def write_report(path: str, report: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)


def per_forward_summary(shapes, card: str) -> dict:
    """K3's and K4's times summed over the call sites of one batch-8 UNet
    forward (both switches on), beside their yardsticks."""
    out = {}
    for kname, extra in (("attention", ("library_ms",)), ("resblock", ("cudnn_seq_ms",))):
        recs = [r for r in shapes if r["kernel"] == kname and "both" in r["sites"]]
        row = {}
        for f in ("ms", "bound_ms") + extra:
            vals = [r.get(f) for r in recs]
            row[f] = (None if any(v is None for v in vals)
                      else sum(v * r["sites"]["both"] for v, r in zip(vals, recs)))
        out[kname] = row
        print(f"per batch-8 UNet forward, {kname}: "
              + ", ".join(f"{f} {v:.4f}" for f, v in row.items() if v is not None)
              + f" [{card}]", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write all measurements here (JSON)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel phases (build, serving and training shapes)")
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
    from dmme_tpu_torch.training import LitDDIM, TrainState

    ops = {"group_norm_silu": (k_gn, "launches"), "group_norm_silu_bwd": (k_gn, "bwd_launches"),
           "attention": (k_attn, "launches"), "resblock": (k_res, "launches")}
    SIMT.update({"group_norm_silu": (k_gn, "simt_launches"),
                 "group_norm_silu_bwd": (k_gn, "simt_bwd_launches"),
                 "attention": (k_attn, "simt_launches"), "resblock": (k_res, "simt_launches")})
    report = {"card": card, "torch": torch.__version__, "device": kind}

    phase("build")
    t0 = time.time()
    build.build_all(verbose=True)
    report["build_s"] = time.time() - t0
    print(f"built {', '.join(build.SOURCES)} in {report['build_s']:.1f} s", flush=True)
    report["ptxas"] = ptxas_report(build)
    for src, kernels in report["ptxas"].items():
        for name, u in kernels.items():
            print(f"  {src}.cu {name}: {u['registers']} registers, spill stores "
                  f"{u['spill_stores']} B, spill loads {u['spill_loads']} B", flush=True)

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
    # kernel launches (and call sites) of one UNet forward
    expect = {"both": {"group_norm_silu": 1, "group_norm_silu_bwd": 0, "attention": 6,
                       "resblock": 22},
              "fused_norm": {"group_norm_silu": 45, "group_norm_silu_bwd": 0, "attention": 6,
                             "resblock": 0}}
    models = {}
    for name, sw in settings.items():
        m = ddpm_models.UNet(dtype=torch.bfloat16, **sw)
        init_weights(m, torch.Generator().manual_seed(SEED))
        randomize_affines(torch, blocks, m, torch.Generator().manual_seed(SEED + 1))
        models[name] = m.to(dev).eval()

    phase("kernels against their plain versions")
    recorded = {"group_norm_silu": {}, "attention": {}, "resblock": {}}
    site_counts = {}
    # the serving path's forwards: batch 8 under both switch settings, and
    # the other request sizes the serve phase sends, 1 and 16, whose shapes
    # take other plans (a key split, 4x4 tiles that reach past the batch)
    forwards = {name: (name, BATCH) for name in models}
    forwards.update({f"both_n{n}": ("both", n) for n in SERVE_BATCHES if n != BATCH})
    for name, (setting, n) in forwards.items():
        g = torch.Generator().manual_seed(SEED + n)
        xs, ts = ((x_in, t_in) if n == BATCH else
                  (torch.randn((n, 32, 32, 3), generator=g),
                   torch.randint(1, 1000, (n,), generator=g)))
        with torch.no_grad():
            calls = record_calls(serve_targets(blocks),
                                 lambda m=models[setting], xs=xs, ts=ts: m(xs.to(dev), ts.to(dev)))
        site_counts[name] = {k: sum(c for _, c, _, _ in v) for k, v in calls.items()}
        if site_counts[name] != {k: expect[setting][k] for k in site_counts[name]}:
            fail(f"UNet forward ({name}) has call sites {site_counts[name]}, "
                 f"expected {expect[setting]}")
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
                    rec["plan"] = attention_plan(k_attn, q)
                elif kind_ == "group_norm_silu":
                    rec["plan"] = gn_plan(k_gn, a[0], a[3], False)
                    rec["torch_seq_ms"] = device_ms(torch, gn_sequence(torch, a, k))
                elif kind_ == "resblock":
                    try:
                        rec["cudnn_seq_ms"] = device_ms(torch, cudnn_sequence(torch, pa))
                    except RuntimeError as err:  # a yardstick only: note it and go on
                        rec["cudnn_seq_ms"] = None
                        print(f"cudnn sequence at {key}: {err}", flush=True)
                    x_ = a[0]
                    cin_, cout_ = x_.shape[3], a[6].shape[0]
                    p1 = k_res.conv_plan(*x_.shape[:3], cin_, cout_, 0, build.sm_count(dev))
                    p2 = k_res.conv_plan(*x_.shape[:3], cout_, cout_,
                                         cin_ if k.get("wr") is not None else 0,
                                         build.sm_count(dev))
                    rec["plan"] = {"conv1": p1._asdict(), "conv2": p2._asdict()}
                shapes.append(rec)
                print(f"{kind_:16s} {str(key):58s} sites {e['sites']} "
                      f"max_abs {max_abs:.3e} max_rel {max_rel:.3e} (rtol {rtol}, atol {atol}) "
                      f"ms {rec['ms']:.4f} plain {rec['plain_ms']:.4f} bound {rec['bound_ms']:.4f} "
                      f"({rec['bound_by']})"
                      + (f" sdpa {rec['library_ms']:.4f}" if rec["library_ms"] else "")
                      + (f" cudnn_seq {rec['cudnn_seq_ms']:.4f}" if rec.get("cudnn_seq_ms") else "")
                      + (f" torch_seq {rec['torch_seq_ms']:.4f} plan {rec['plan']}"
                         if kind_ == "group_norm_silu" else "")
                      + ("" if ok else "  FAIL"), flush=True)
                if not ok:
                    failures.append(f"{kind_} {key}")
    report["shapes"] = shapes
    if failures:
        fail(f"kernels disagree with their plain versions: {failures}")
    del recorded
    report["per_forward"] = per_forward_summary(shapes, card)
    if args.kernels_only:
        phase("train kernels: one full-width bf16 training step at batch 128")
        from dmme_tpu_torch.training import LitDDPM

        del models
        torch.cuda.empty_cache()
        report["train_kernels"] = train_kernels(torch, blocks, k_gn, k_attn, ddpm_models,
                                                init_weights, LitDDPM, dev, card)
        phase("off-path kernels: shapes outside the main path against their plain versions")
        report["offpath"] = offpath_kernels(torch, k_gn, k_attn, k_res, dev)
        phase("LSUN widths: one UNet forward at batch 1, bf16 on the card vs f32 on the CPU")
        torch.set_num_threads(max(1, os.cpu_count() or 1))
        report["lsun"] = lsun_forward(torch, blocks, ddpm_models, init_weights, k_gn, k_attn,
                                      k_res, ops, dev)
        if args.out:
            write_report(args.out, report)
        print("--kernels-only: stopped after the kernel phases; no result line", flush=True)
        return 0

    phase("unet forward, full width, bf16 on the card vs f32 on the CPU")
    torch.set_num_threads(max(1, os.cpu_count() or 1))
    unet = {}
    for name, m in models.items():
        ref_model = ddpm_models.UNet(dtype=torch.float32, **settings[name])
        ref_model.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()}, strict=True)
        with torch.no_grad():
            want = ref_model(x_in, t_in)
            reset_counts(ops)
            got = m(x_in.to(dev), t_in.to(dev))
            torch.cuda.synchronize()
            per_call = counts(ops)
            expect_no_simt(f"UNet forward ({name})")
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

    phase("LSUN widths: one UNet forward at batch 1, bf16 on the card vs f32 on the CPU")
    report["lsun"] = lsun_forward(torch, blocks, ddpm_models, init_weights, k_gn, k_attn, k_res,
                                  ops, dev)
    torch.cuda.empty_cache()

    phase("serve: LitDDIM DDIM-50 over HTTP")
    lit = LitDDIM(dtype="bf16", timesteps=1000, sample_steps=50, tau_schedule="quadratic")
    lit.init_state(SEED)
    randomize_affines(torch, blocks, lit.model, torch.Generator().manual_seed(SEED + 1))
    state = TrainState.create({k: v.detach().clone() for k, v in lit.model.state_dict().items()},
                              lit.make_optimizer())
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

        post(1, 99)  # first request: cuDNN plans, the sampler's first buffers
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
        expect_no_simt("serve")
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

    from dmme_tpu_torch.diffusion import DDPM
    from dmme_tpu_torch.training import LitDDPM

    del sampler, state
    torch.cuda.empty_cache()
    phase("train kernels: one full-width bf16 training step at batch 128")
    train = train_kernels(torch, blocks, k_gn, k_attn, ddpm_models, init_weights, LitDDPM, dev,
                          card)
    report["train_kernels"] = train
    torch.cuda.empty_cache()

    phase("off-path kernels: shapes outside the main path against their plain versions")
    report["offpath"] = offpath_kernels(torch, k_gn, k_attn, k_res, dev)
    torch.cuda.empty_cache()

    phase("train gradient: loss_given + backward at batch 8, bf16 on the card vs f32 on the CPU")
    report["train_gradient"] = train_gradient(torch, np, blocks, ddpm_models, init_weights,
                                              DDPM, dev, ops)
    torch.cuda.empty_cache()

    # a user's defaults for the timed training: cuDNN may pick any algorithm
    torch.backends.cudnn.deterministic = False
    print("cudnn deterministic off for fit (the library default)", flush=True)
    phase("fit: LitDDPM(dtype='bf16') on CIFAR10(synthetic=True, batch_size=128)")
    trained_lit, trained = run_fit(torch, np, blocks, dev, ops, report, card)
    fit_launches = report["fit"]["launches"]

    phase("sample after training: DDIM-50 through K4 from the trained raw weights")
    report["sample_after_training"] = sample_after_training(torch, k_res, trained_lit, trained,
                                                            dev, ops)
    del trained_lit, trained
    k_res._PACKED.clear()
    torch.cuda.empty_cache()

    phase("cli: dmme_tpu_torch.trainer.main on the repo's configs, in this process")
    report["cli"] = cli_phase(torch, np, ops, dev, card)
    torch.cuda.empty_cache()

    phase("f32 and fp16: LitDDPM() and LitDDIM() through simt.cu on the card (fault C.5)")
    report["f32"] = f32_phase(torch, np, blocks, init_weights, k_gn, k_attn, k_res, dev, ops,
                              card)

    phase("kernels")
    sources = {
        "group_norm_silu": ("cuda", "dmme_tpu_torch/ops/csrc/group_norm.cu",
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
    k2 = train["per_step"]["group_norm_silu_bwd"]
    table.insert(1, {
        "name": "group_norm_silu_bwd", "route": "cuda",
        "source": "dmme_tpu_torch/ops/csrc/group_norm.cu",
        "replaces": "dmme_tpu/ops/group_norm.py:110",
        "launches": fit_launches["group_norm_silu_bwd"],
        "max_abs_err": k2["max_abs_err"], "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"], "library_ms": None,
    })
    f32 = report["f32"]["f32"]
    for kname, replaces in (("group_norm_silu", "dmme_tpu/ops/group_norm.py:72"),
                            ("group_norm_silu_bwd", "dmme_tpu/ops/group_norm.py:110"),
                            ("attention", "dmme_tpu/ops/attention.py:47"),
                            ("resblock", "dmme_tpu/ops/resblock.py:88")):
        v = f32["per_path"][kname]
        table.append({
            "name": f"{kname}_simt", "route": "cuda", "source": "dmme_tpu_torch/ops/csrc/simt.cu",
            "replaces": replaces,
            "launches": f32["train"]["simt"][kname] + f32["ddim_step"]["simt"][kname],
            "max_abs_err": max(r["max_abs_err"] for r in f32["rows"] + f32["rows_ddim"]
                               if r["kernel"] == kname),
            "ms": v["ms"], "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
            "bound_by": v["bound_by"], "library_ms": v["library_ms"],
        })
    report["kernels"] = table
    print("kernels launched on their paths and held against their plain versions: "
          + "; ".join(f"{k['name']} ({k['route']}, {k['source']}, replaces {k['replaces']}, "
                      f"{k['launches']} launches)" for k in table), flush=True)
    if args.out:
        write_report(args.out, report)
    print("(K1, K3, K4: launches in the four serve requests; ms, plain_ms, bound_ms and "
          "library_ms per UNet forward at batch 8, summed over the serving path's call sites. "
          f"K2: launches in the {FIT_STEPS} logged fit steps; times per training step at "
          f"batch {TRAIN_BATCH}, summed over its 45 call sites. *_simt: the f32 kernels of "
          f"simt.cu; launches in the f32 phase's training step and DDIM step; times per f32 "
          f"training step at batch {TRAIN_BATCH} (K1, K2, K3) and per f32 UNet forward at "
          f"n = {BATCH} (K4), summed over their call sites)", flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
