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

fp16 activations take the same kernel with fp16 operands (P rounded to
fp16, V's dtype). f32 activations take the f32 kernel in the same file:
3xTF32 on the tensor cores (each operand split into two tf32 halves,
:func:`~dmme_tpu_torch.ops.tf32_split`, and each product the sum of three
tf32 products, accumulated in f32), ``mma.sync`` from f32 tiles in shared
memory, 64 queries a block, the same online softmax and key split. It reads
q, k and v in place when they are row-major (unit stride along D) or
token-major (unit stride along T: the channel-major output an f32
convolution may give the qkv projection), the latter into transposed tiles
(:func:`f32_layout`).
Launches are counted per dtype: ``launches`` (bf16), ``fp16_launches``,
``f32_launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from dmme_tpu_torch.ops import build, route
from dmme_tpu_torch.ops.group_norm import _ptr

#: calls that launched the kernel since the last reset, by activation dtype
#: (incremented only by the launcher): bf16, fp16, f32
launches = 0
fp16_launches = 0
f32_launches = 0

#: each dtype's C entry point in ``csrc/attention.cu``
ENTRY = {torch.bfloat16: "dmme_attention_fwd", torch.float16: "dmme_attention_fwd_f16",
         torch.float32: "dmme_attention_fwd_f32"}
#: the bound entry points, by dtype
_FNS: dict = {}


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel on (BH, T, D): f32 scores,
    softmax in f32, P cast to V's dtype before PV, f32 accumulation, output
    in q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = torch.softmax(s * scale, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


# the 16-bit kernel's instantiations: queries a block (64 a warpgroup) by the
# kernel's head dim, the true one padded to a multiple of 64; the f32 kernel
# takes 64 at every head dim
BLOCK_QUERIES = {64: (64,), 128: (64, 128), 192: (64,), 256: (64,), 512: (64,)}
# key splits pay for their merge launch only where the blocks are few (batch
# 1, not 8) and a block's key loop is at least this many (key, head dim)
# products: measured on an H100 at T = 256 (PERF.md)
SPLIT_MIN_WORK = 256 * 256
# ... and where the blocks fill at most this share of the SMs, by element
# size: an f32 key tile costs several times a 16-bit one (three tf32
# products on mma.sync), so the merge pays off at more blocks
SPLIT_FILL = {2: 8, 4: 2}


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
def attention_plan(n: int, h: int, t: int, d: int, sms: int, size: int = 2,
                   trans: bool = False) -> AttentionPlan:
    """K3's grid for (N, T, H, D) inputs of ``size``-byte elements (2: bf16
    or fp16, 4: f32; ``trans``: f32 read token-major) on a card with ``sms``
    SMs, made once per shape. The
    kernel's head dim is D padded to a multiple of 64 (D = 512 runs as two
    blocks of 256 output columns). 16-bit: blocks of 128 queries where that
    head dim allows them and they alone fill the SMs (two warpgroups sharing
    each K and V tile), else of 64; key tiles of 64, 32 above D = 128. f32:
    blocks of 64 queries, key tiles of 32; 16 token-major at D = 256 and 8 at
    D = 512 (shared memory). Where the blocks
    fill at most an eighth of the SMs (f32: half) and a block's key loop
    holds ``SPLIT_MIN_WORK``, its key tiles are split, two at least a split,
    over up to one block per SM; no split is empty. D = 512 is not split."""
    if d % 16 or not (16 <= d <= 256 or d == 512):
        raise ValueError(f"attention kernel takes head dims that are multiples of 16 up to "
                         f"256, or 512, got {d}")
    dp = -(-d // 64) * 64
    halves = 2 if dp == 512 else 1
    if size == 4:
        bq, bkv = 64, (8 if dp == 512 else 16 if trans and dp > 192 else 32)
    else:
        bq = max(b for b in BLOCK_QUERIES[dp] if b == 64 or -(-t // b) * n * h >= sms)
        bkv = 32 if dp > 128 else 64
    q_tiles, kv_tiles = -(-t // bq), -(-t // bkv)
    blocks = q_tiles * n * h * halves
    few = halves == 1 and SPLIT_FILL[size] * blocks <= sms and t * dp >= SPLIT_MIN_WORK
    splits = min(-(-sms // blocks), kv_tiles // 2) if few else 1
    per = -(-kv_tiles // max(1, splits))
    return AttentionPlan(bq, bkv, q_tiles, kv_tiles, -(-kv_tiles // per), per, dp, halves)


def attention_smem(plan: AttentionPlan, size: int = 2, trans: bool = False) -> int:
    """Dynamic shared memory of the kernel ``plan`` launches, in bytes
    (``csrc/attention.cu``: ``Tile::SMEM`` for 16-bit elements,
    ``TileF32::SMEM`` for f32)."""
    dv = plan.dp // plan.halves
    if size == 4 and trans:  # Q^T and two stages of K^T and V^T, rows padded by 8
        return 4 * (plan.dp * (plan.bq + 8) + 2 * (plan.dp + dv) * (plan.bkv + 8))
    if size == 4:  # Q and two stages of K and V, rows padded by 8 (Q, K) and 4 (V)
        return 4 * (plan.bq * (plan.dp + 8) + 2 * plan.bkv * (plan.dp + 8 + dv + 4))
    # 1 KB alignment, Q, two stages of 128-byte-swizzled K and V, barriers
    return 1024 + 2 * plan.bq * plan.dp + 2 * 2 * plan.bkv * (plan.dp + dv) + 3 * 8


def _fn(dtype: torch.dtype = torch.bfloat16):
    """The C entry point for ``dtype`` activations, bound once."""
    fn = _FNS.get(dtype)
    if fn is None:
        fn = getattr(build.library("attention"), ENTRY[dtype])
        ll, vp = ctypes.c_longlong, ctypes.c_void_p
        if dtype == torch.float32:  # the layout flag and q, k, v's strides along D
            fn.argtypes = [vp] * 6 + [ctypes.c_int] * 8 + [ll] * 15 + [ctypes.c_float, vp]
        else:
            fn.argtypes = [vp] * 6 + [ctypes.c_int] * 8 + [ll] * 12 + [ctypes.c_float, vp]
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return fn


def _aligned(x: torch.Tensor, unit: int = 3) -> bool:
    """The kernels read (N, T, H, D) in place through its strides (TMA, or
    16-byte ``cp.async`` copies in f32): unit stride along dim ``unit`` (D;
    T for the f32 kernel's token-major reads), 16-byte aligned, the other
    strides multiples of 16 bytes."""
    return (x.stride(unit) == 1 and x.data_ptr() % 16 == 0
            and all(s * x.element_size() % 16 == 0
                    for i, s in enumerate(x.stride()) if i != unit))


def f32_layout(q, k, v, plan_dp: int) -> bool:
    """Whether the f32 kernel reads q, k and v token-major (transposed
    tiles): where not all three are row-major in place but all three are
    token-major in place, T is a multiple of 4 and D at most 256. Else the
    row-major read, of copies where needed."""
    t = q.shape[1]
    return (not all(_aligned(x) for x in (q, k, v)) and t % 4 == 0 and plan_dp <= 256
            and all(_aligned(x, unit=1) for x in (q, k, v)))


def _launch(q, k, v, scale: float) -> torch.Tensor:
    """(N, T, H, D) bf16, fp16 or f32 views with unit stride along D → (N, T,
    H, D) in their dtype."""
    global launches, fp16_launches, f32_launches
    n, t, h, d = q.shape
    if q.dtype not in ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention kernel takes bf16, fp16 or f32, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    size = q.element_size()
    trans = size == 4 and f32_layout(q, k, v, -(-d // 64) * 64)
    plan = attention_plan(n, h, t, d, build.sm_count(q.device), size, trans)
    if not trans:  # 16-byte aligned rows and strides; other layouts are copied first
        q, k, v = (x if _aligned(x) else x.contiguous() for x in (q, k, v))
    out = torch.empty((n, t, h, d), device=q.device, dtype=q.dtype)
    o_part = ml_part = None  # the splits' partial outputs, only where the keys are split
    if plan.splits > 1:
        rows = plan.splits * n * h * t
        o_part = torch.empty((rows * plan.dp,), device=q.device, dtype=torch.float32)
        ml_part = torch.empty((rows * 2,), device=q.device, dtype=torch.float32)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(o_part), _ptr(ml_part))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out_strides = (out.stride(0), out.stride(1), out.stride(2))
    if size == 4:  # (batch, token, head, dim) strides of q, k, v
        strides = [s for x in (q, k, v) for s in (x.stride(0), x.stride(1), x.stride(2),
                                                   x.stride(3))]
        status = _fn(q.dtype)(*ptrs, n, h, t, d, plan.dp, plan.splits, plan.kv_per_split,
                              int(trans), *strides, *out_strides, float(scale), stream)
    else:
        strides = [s for x in (q, k, v) for s in (x.stride(0), x.stride(1), x.stride(2))]
        status = _fn(q.dtype)(*ptrs, n, h, t, d, plan.dp, plan.bq, plan.splits,
                              plan.kv_per_split, *strides, *out_strides, float(scale), stream)
    build.check(status, f"attention kernel launch ({q.dtype})")
    if q.dtype == torch.bfloat16:
        launches += 1
    elif q.dtype == torch.float16:
        fp16_launches += 1
    else:
        f32_launches += 1
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
    a CUDA tensor (bf16, fp16 or f32), :func:`attention_heads_plain` on a
    CPU one; the
    :func:`attention_bwd` recompute as backward on both. Saves q, k and v
    as given (strided views of a packed projection stay views)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        if route(q.device, q.dtype, "attention") == "kernel":
            return _launch(q, k, v, scale)
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
