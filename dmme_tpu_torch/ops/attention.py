"""Softmax attention: a CUDA C++ forward kernel for Hopper (``csrc/attention.cu``)
and the autograd Function around it.

Replaces the TPU kernel ``dmme_tpu/ops/attention.py:_attn_kernel`` (reached
through ``_attention_pallas`` and ``attention``/``attention_heads``), which
keeps one whole (T×T) score tile per batch·head in VMEM. That tile does not
fit an SM, so a block of one or two warpgroups takes 64 queries a
warpgroup of one batch·head and walks the keys in tiles with an online
softmax: QKᵀ on ``wgmma`` from shared memory, PV on ``wgmma`` with P from
registers, scores, probabilities, the output accumulator and the running max
and sum in registers, Q, K and V brought in by TMA (K and V double-buffered)
and the output written by TMA stores. Where the blocks are few and the key
loop long, the key tiles are split over more blocks and merged by a second,
fixed-order launch (:func:`attention_plan`). Head dims: any multiple of 16
up to 256 (a head dim that is not a multiple of 64 runs the kernel of the
next multiple, its last panel padded by TMA's zero fill and clipped on the
store), and 512 (the output columns split over two blocks, each
contracting QKᵀ over all 512).

Bound on the card: bytes. At T ≤ 256 and D ≤ 256 it does far fewer
operations per byte than the tensor cores need, so the least time is one
read of q, k, v and one write of o. q, k and v are read in place through
their strides (the UNet hands it strided views of the packed qkv
projection), so no copy precedes the launch. Launches per call: 1, plus the
merge where the keys are split (``launches`` counts calls).

The backward, :func:`attention_bwd`, is not a kernel in the JAX package
either: ``dmme_tpu/ops/attention.py:_fused_bwd`` recomputes the
probabilities from the saved q, k, v and differentiates with XLA einsums.
It is ported line by line as ``torch.matmul`` and elementwise ops.

f32 and fp16 activations take K3's version in ``csrc/simt.cu``
(:func:`_launch_simt`, ``simt_launches``): 16 queries a block, key tiles of
32 in shared memory, an online softmax, products on the CUDA cores in f32;
one launch a call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from dmme_tpu_torch.ops import build, route, simt_code

#: kernel launches since the last reset (incremented only by the launcher)
launches = 0
#: launches of the f32/fp16 kernel of ``csrc/simt.cu`` (incremented only by its launcher)
simt_launches = 0

_FN = None
_SIMT = None


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel on (BH, T, D): f32 scores,
    softmax in f32, P cast to V's dtype before PV, f32 accumulation, output
    in q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = torch.softmax(s * scale, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


# the kernel's instantiations: queries a block (64 a warpgroup) by the
# kernel's head dim, the true one padded to a multiple of 64
BLOCK_QUERIES = {64: (64,), 128: (64, 128), 192: (64,), 256: (64,), 512: (64,)}
# key splits pay for their merge launch only where the blocks are few (batch
# 1, not 8) and a block's key loop is at least this many (key, head dim)
# products: measured on an H100 at T = 256 (PERF.md)
SPLIT_MIN_WORK = 256 * 256


class AttentionPlan(NamedTuple):
    """Launch geometry of one K3 call."""

    bq: int            # queries a block
    bkv: int           # keys per tile
    q_tiles: int       # blocks along the queries
    kv_tiles: int      # key tiles along T
    splits: int        # key splits (blockIdx.z); > 1 adds the merge launch
    kv_per_split: int  # key tiles per split; the last split may take fewer
    dp: int = 0        # the kernel's head dim: D padded to a multiple of 64
    halves: int = 1    # blocks along the output columns: 2 at D = 512

    def split_tiles(self):
        """The key tiles of each split, in order."""
        return [range(z * self.kv_per_split, min(self.kv_tiles, (z + 1) * self.kv_per_split))
                for z in range(self.splits)]


@functools.lru_cache(maxsize=None)
def attention_plan(n: int, h: int, t: int, d: int, sms: int) -> AttentionPlan:
    """K3's grid for (N, T, H, D) inputs on a card with ``sms`` SMs, made
    once per shape. The kernel's head dim is D padded to a multiple of 64
    (D = 512 runs as two blocks of 256 output columns). Blocks of 128
    queries where that head dim allows them and they alone fill the SMs (two
    warpgroups sharing each K and V tile), else of 64. Where the blocks fill
    at most an eighth of the SMs and a block's key loop holds
    ``SPLIT_MIN_WORK``, its key tiles are split, two at least a split, over
    up to one block per SM; no split is empty. D = 512 is not split."""
    if d % 16 or not (16 <= d <= 256 or d == 512):
        raise ValueError(f"attention kernel takes head dims that are multiples of 16 up to "
                         f"256, or 512, got {d}")
    dp = -(-d // 64) * 64
    halves = 2 if dp == 512 else 1
    bq = max(b for b in BLOCK_QUERIES[dp] if b == 64 or -(-t // b) * n * h >= sms)
    bkv = 32 if dp > 128 else 64
    q_tiles, kv_tiles = -(-t // bq), -(-t // bkv)
    blocks = q_tiles * n * h * halves
    few = halves == 1 and 8 * blocks <= sms and t * dp >= SPLIT_MIN_WORK
    splits = min(-(-sms // blocks), kv_tiles // 2) if few else 1
    per = -(-kv_tiles // max(1, splits))
    return AttentionPlan(bq, bkv, q_tiles, kv_tiles, -(-kv_tiles // per), per, dp, halves)


def _fn():
    global _FN
    if _FN is None:
        fn = build.library("attention").dmme_attention_fwd
        ll, vp = ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = [vp] * 6 + [ctypes.c_int] * 8 + [ll] * 12 + [ctypes.c_float, vp]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _aligned(x: torch.Tensor) -> bool:
    """TMA reads (N, T, H, D) in place through its strides: unit stride
    along D, 16-byte aligned, the other strides multiples of 16 bytes."""
    return (x.stride(3) == 1 and x.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in x.stride()[:3]))


def _launch(q, k, v, scale: float) -> torch.Tensor:
    """(N, T, H, D) bf16 views with unit stride along D → (N, T, H, D)."""
    global launches
    n, t, h, d = q.shape
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention kernel takes bf16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    plan = attention_plan(n, h, t, d, build.sm_count(q.device))
    # TMA needs 16-byte aligned rows and strides; other layouts are copied first
    q, k, v = (x if _aligned(x) else x.contiguous() for x in (q, k, v))
    out = torch.empty((n, t, h, d), device=q.device, dtype=q.dtype)
    o_part = ml_part = None  # the splits' partial outputs, only where the keys are split
    if plan.splits > 1:
        rows = plan.splits * n * h * t
        o_part = torch.empty((rows * plan.dp,), device=q.device, dtype=torch.float32)
        ml_part = torch.empty((rows * 2,), device=q.device, dtype=torch.float32)
    strides = [s for x in (q, k, v, out) for s in (x.stride(0), x.stride(1), x.stride(2))]
    status = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   None if o_part is None else o_part.data_ptr(),
                   None if ml_part is None else ml_part.data_ptr(), n, h, t, d, plan.dp, plan.bq,
                   plan.splits, plan.kv_per_split, *strides, float(scale),
                   torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, "attention kernel launch")
    launches += 1
    return out


def _simt_fn():
    global _SIMT
    if _SIMT is None:
        fn = build.library("simt").dmme_simt_attention
        ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [vp] * 4 + [i] * 4 + [ll] * 12 + [ctypes.c_float, vp]
        fn.restype = i
        _SIMT = fn
    return _SIMT


def _launch_simt(q, k, v, scale: float) -> torch.Tensor:
    """K3 for f32 or fp16 (N, T, H, D) views (``csrc/simt.cu``): 16 queries
    a block, head dims up to 512, read in place where D has unit stride."""
    global simt_launches
    n, t, h, d = q.shape
    code = simt_code(q, "attention")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention simt kernel: q/k/v dtypes differ: {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if not 1 <= d <= 512:
        raise ValueError(f"attention simt kernel takes head dims up to 512, got {d}")
    q, k, v = (x if x.stride(3) == 1 else x.contiguous() for x in (q, k, v))
    out = torch.empty((n, t, h, d), device=q.device, dtype=q.dtype)
    strides = [s for x in (q, k, v, out) for s in (x.stride(0), x.stride(1), x.stride(2))]
    status = _simt_fn()(code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), n, h, t,
                        d, *strides, float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, "attention simt kernel launch")
    simt_launches += 1
    return out


def attention_heads_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """:func:`attention_plain` on (N, T, H, D) tensors, heads folded into the batch."""
    n, t, h, d = q.shape

    def flat(x):
        return x.transpose(1, 2).reshape(n * h, t, d)

    out = attention_plain(flat(q), flat(k), flat(v), scale)
    return out.reshape(n, h, t, d).transpose(1, 2)


def attention_bwd(q, k, v, g, scale: float):
    """(dq, dk, dv) of softmax(QKᵀ·scale)·V on (N, T, H, D) tensors, the
    arithmetic of ``_fused_bwd`` line by line: scores in the inputs' dtype,
    softmax in f32, P cast to g's dtype for dv, dS cast to q's dtype."""
    qh, kh, vh, gh = (x.transpose(1, 2) for x in (q, k, v, g))  # (N, H, T, D)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    p = torch.softmax(s.to(torch.float32), dim=-1)
    dv = torch.matmul(p.to(g.dtype).transpose(-1, -2), gh)
    dp = torch.matmul(gh, vh.transpose(-1, -2)).to(torch.float32)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    ds = (ds * scale).to(q.dtype)
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


class Attention(torch.autograd.Function):
    """Multi-head softmax attention on (N, T, H, D) tensors: K3 forward on
    a CUDA tensor (its ``simt.cu`` version for f32 and fp16),
    :func:`attention_heads_plain` on a CPU one; the
    :func:`attention_bwd` recompute as backward on both. Saves q, k and v
    as given (strided views of a packed projection stay views)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        where = route(q.device, q.dtype, "attention")
        if where == "kernel":
            return _launch(q, k, v, scale)
        if where == "simt":
            return _launch_simt(q, k, v, scale)
        return attention_heads_plain(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*attention_bwd(q, k, v, g, ctx.scale), None)


def attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Multi-head attention on (N, T, H, D) tensors → (N, T, H, D), through
    :class:`Attention` (differentiable in q, k and v)."""
    return Attention.apply(q, k, v, scale)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """Batched attention: inputs (BH, T, D) → (BH, T, D)."""
    return attention_heads(q[:, :, None], k[:, :, None], v[:, :, None], scale)[:, :, 0]
