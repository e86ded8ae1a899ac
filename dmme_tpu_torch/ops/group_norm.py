"""GroupNorm(+pre-bias, +per-sample affine)+SiLU, forward and backward: two
CUDA C++ kernels for Hopper (``csrc/group_norm.cu``), their launch plan and
the autograd Function that joins them.

K1, the forward, replaces the TPU kernel
``dmme_tpu/ops/group_norm.py:_fwd_kernel`` (reached through ``_fwd_pallas``
and ``group_norm_silu``), which holds whole samples in VMEM. It computes

    y = silu(GN(x + pre_bias)·γ + β)

over NHWC ``x`` with per-sample (N, C) γ, β and pre-bias, f32 statistics
taken as E[u²] − E[u]² with the pre-bias folded into the channel sums
analytically (Σ(x+b) = Σx + HW·b, Σ(x+b)² = Σx² + 2bΣx + HW·b²), and also
writes the (N, G) mean and inverse std that the backward reads.

K2, the backward, replaces ``dmme_tpu/ops/group_norm.py:_bwd_kernel``
(reached through ``_bwd_pallas`` and ``_fused_bwd``). From x, the incoming
gradient dz and K1's saved statistics it rebuilds x̂ = (x + bias − mean)·inv,
y = x̂·γ + β and dy = dz·σ(y)·(1 + y(1 − σ(y))), and writes dx in x's dtype
with the group-mean corrections, dx = inv·(dy·γ − m1 − x̂·m2), plus the
(N, C) f32 sums dγ = Σdy·x̂, dβ = Σdy and dbias = Σdx.

Bound on the card: bytes, for both. Each does a few tens of f32
operations per element, far below the H100's ~295 bf16 operations per
byte, so the least time is one read of every input and one write of every
output (x→y; x, dz→dx). Design (details in the source): a block owns a
contiguous slab of one sample's NHWC pixels, all channels, brought into
shared memory by TMA bulk copies and kept there between the statistics and
the apply, so each input byte crosses DRAM once; threads own 16-byte
vectors of 8 channels, and a group is summed from per-channel sums, so any
C % 8 == 0 with C % G == 0 works. A sample larger than one block's slab is
split over a thread-block cluster of up to 8 blocks that exchange their
channel partials through distributed shared memory; one that no cluster
holds takes two passes over global memory with per-chunk partials summed
in chunk order. No float atomics: repeated runs agree bit for bit. The
plan is :func:`gn_plan`, made once per shape. A γ or β shared by the batch
is read through a row stride of 0, not copied per sample. Launches per
call: 1 in one pass; 3 (K1) or 4 (K2) in two (``launches`` counts calls).

f32 and fp16 activations take K1's and K2's versions in ``csrc/simt.cu``
(:func:`_launch_simt`, :func:`_launch_bwd_simt`; ``simt_launches`` and
``simt_bwd_launches``): a block per (group, sample) sums per channel, then
per group, in a fixed order, and passes over the group's pixels again for
the output; one launch a call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from dmme_tpu_torch.ops import build, route, simt_code

GN_EPS = 1e-5

#: K1 (forward) launches since the last reset (incremented only by its launcher)
launches = 0
#: K2 (backward) launches since the last reset (incremented only by its launcher)
bwd_launches = 0
#: launches of the f32/fp16 forward and backward of ``csrc/simt.cu``
#: (:func:`dmme_tpu_torch.ops.route`), incremented only by their launchers
simt_launches = 0
simt_bwd_launches = 0

_FWD = None
_BWD = None
_SIMT_FWD = None
_SIMT_BWD = None

# the plan's constants (csrc/group_norm.cu)
VEC = 8                        # channels a 16-byte vector of bf16
THREADS = 256                  # threads a block of K2 (where two fit an SM) and of two passes
WIDE_THREADS = 512             # threads a one-pass K1 block, and a K2 block alone on its SM
HALF_SM = 113 * 1024           # shared memory a block may take for two to share an SM
MAX_CHUNKS = 16                # bulk copies a block
CHUNK_BYTES = 32 * 1024        # bytes a bulk copy of a tensor, where the slab allows
MAX_CLUSTER = 8                # blocks a cluster: the portable limit
# cluster sizes, smallest first: on an H100 a cluster of 4 was slower than one
# of 8 (or of 2 with twice the slab) at every training site (PERF.md)
CLUSTERS = (1, 2, 8)
SLAB_TARGET = 128 * 1024       # slab bytes a block that a cluster aims for
SLAB_MIN = 8 * 1024            # a cluster grows for the SMs down to slabs of this
SMEM_MAX = 232448              # dynamic shared memory a block may take (227 KB)
TWO_PASS_BYTES = 64 * 1024     # bytes a block reads in a two-pass chunk


def broadcast_rows(v: torch.Tensor, n: int, c: int) -> Tuple[torch.Tensor, int]:
    """An (N, C) or (C,) vector as f32 (N, C) rows and their stride: 0 where
    one row serves the whole batch, so a kernel reads it without a copy."""
    v = v.to(torch.float32).expand(n, c)
    if v.stride(0) == 0 and v.stride(1) == 1:
        return v, 0
    return v.contiguous(), c


def gn_silu_plain(x, gamma, beta, bias, num_groups: int, eps: float = GN_EPS
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the same folded one-pass math.
    ``gamma``/``beta``: (C,) or (N, C); ``bias``: None or (N, C).
    Returns (y, mean, inv)."""
    n, h, w, c = x.shape
    gamma, beta = broadcast_rows(gamma, n, c)[0], broadcast_rows(beta, n, c)[0]
    bias = (torch.zeros((n, c), device=x.device, dtype=torch.float32) if bias is None
            else broadcast_rows(bias, n, c)[0])
    hw, cg = h * w, c // num_groups
    xf = x.to(torch.float32)
    chan_sum = xf.sum(dim=(1, 2))
    chan_sq = torch.square(xf).sum(dim=(1, 2))
    usum = chan_sum + hw * bias
    usq = chan_sq + 2.0 * bias * chan_sum + hw * torch.square(bias)
    mean_g = usum.reshape(n, num_groups, cg).sum(-1) / (hw * cg)
    var_g = usq.reshape(n, num_groups, cg).sum(-1) / (hw * cg) - torch.square(mean_g)
    inv_g = torch.rsqrt(var_g + eps)
    mean_c = mean_g.repeat_interleave(cg, dim=1)
    inv_c = inv_g.repeat_interleave(cg, dim=1)
    a = (inv_c * gamma)[:, None, None, :]
    d = (beta + (bias - mean_c) * inv_c * gamma)[:, None, None, :]
    y = xf * a + d
    return (y * torch.sigmoid(y)).to(x.dtype), mean_g, inv_g


def gn_silu_bwd_plain(x, dz, gamma, beta, bias, mean, inv, num_groups: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2, ``_bwd_kernel``'s arithmetic in f32.
    ``mean``/``inv``: the (N, G) statistics of the forward. Returns dx in
    x's dtype and the (N, C) f32 dγ, dβ and dbias."""
    n, h, w, c = x.shape
    gamma, beta = broadcast_rows(gamma, n, c)[0], broadcast_rows(beta, n, c)[0]
    bias = (torch.zeros((n, c), device=x.device, dtype=torch.float32) if bias is None
            else broadcast_rows(bias, n, c)[0])
    cg = c // num_groups
    cnt = h * w * cg

    def per_channel(v):  # (N, G) -> (N, 1, 1, C)
        return v.repeat_interleave(cg, dim=1)[:, None, None, :]

    def bc(v):  # (N, C) -> (N, 1, 1, C)
        return v[:, None, None, :]

    xf, dzf = x.to(torch.float32), dz.to(torch.float32)
    xhat = (xf + bc(bias) - per_channel(mean)) * per_channel(inv)
    y = xhat * bc(gamma) + bc(beta)
    s = torch.sigmoid(y)
    dy = dzf * (s * (1.0 + y * (1.0 - s)))
    dbeta = dy.sum(dim=(1, 2))
    dgamma = (dy * xhat).sum(dim=(1, 2))
    dxhat = dy * bc(gamma)
    m1 = dxhat.sum(dim=(1, 2)).reshape(n, num_groups, cg).sum(-1) / cnt
    m2 = (dxhat * xhat).sum(dim=(1, 2)).reshape(n, num_groups, cg).sum(-1) / cnt
    du = per_channel(inv) * (dxhat - per_channel(m1) - xhat * per_channel(m2))
    return du.to(x.dtype), dgamma, dbeta, du.sum(dim=(1, 2))


def _smem_bytes(backward: bool, pixels: int, c: int, threads: int) -> int:
    """Dynamic shared memory of a one-pass block: the slab (x, and dz for
    the backward), the row sums of two quantities, the channel partials,
    totals, coefficients and the sample's rows, the mbarriers and alignment
    slack. The arithmetic of ``Layout`` in csrc/group_norm.cu."""
    slab = -(-pixels * c * 2 // 128) * 128
    return (2 if backward else 1) * slab + 2 * threads * VEC * 4 + 12 * c * 4 + MAX_CHUNKS * 8 + 128


class GNPlan(NamedTuple):
    """Launch geometry of one K1 or K2 call."""

    blocks: int     # blocks along a sample's pixels: its cluster, or its two-pass chunks
    pixels: int     # pixels a block; the last block may take fewer
    chunk: int      # pixels a bulk copy (one pass)
    threads: int
    smem: int       # dynamic shared memory bytes a block (one pass; 0 in two)
    two_pass: bool

    def ranges(self, hw: int) -> List[range]:
        """The pixels of each block of a sample, in order."""
        return [range(b * self.pixels, min(hw, (b + 1) * self.pixels))
                for b in range(self.blocks)]


@functools.lru_cache(maxsize=None)
def gn_plan(n: int, h: int, w: int, c: int, groups: int, sms: int,
            backward: bool = False) -> GNPlan:
    """K1's (or, with ``backward``, K2's) grid for (N, H, W, C) bf16 inputs
    on a card with ``sms`` SMs, made once per shape. One pass where a
    cluster of at most 8 blocks holds a sample in shared memory: the
    smallest cluster of ``CLUSTERS`` whose blocks' slabs are at most
    ``SLAB_TARGET`` bytes, then a larger one while the batch fills at most
    half the SMs and the slabs stay above ``SLAB_MIN``. One-pass K1 blocks
    take ``WIDE_THREADS``. A K2 thread holds about twice K1's registers, so
    512 of them fill an SM's register file: K2 blocks take ``THREADS`` where
    two such blocks share an SM's shared memory, else ``WIDE_THREADS``; any
    block takes ``THREADS`` where ``WIDE_THREADS`` would not fit.
    Where 8 blocks cannot hold a sample, two passes over chunks of
    ``TWO_PASS_BYTES``."""
    if c % groups:
        raise ValueError(f"group_norm_silu kernel: {c} channels in {groups} groups")
    if c % VEC or c > VEC * THREADS:
        raise ValueError(f"group_norm_silu kernel takes C % {VEC} == 0 and C <= "
                         f"{VEC * THREADS}, got {c}")
    hw = h * w
    bpp = 2 * c * (2 if backward else 1)  # slab bytes a pixel
    i = next((i for i, k in enumerate(CLUSTERS) if -(-hw // k) * bpp <= SLAB_TARGET),
             len(CLUSTERS) - 1)
    while (i + 1 < len(CLUSTERS) and 2 * n * CLUSTERS[i] <= sms
           and -(-hw // CLUSTERS[i + 1]) * bpp >= SLAB_MIN):
        i += 1
    pixels = -(-hw // CLUSTERS[i])
    narrow = _smem_bytes(backward, pixels, c, THREADS)
    wide = _smem_bytes(backward, pixels, c, WIDE_THREADS)
    threads = THREADS if (backward and narrow <= HALF_SM) or wide > SMEM_MAX else WIDE_THREADS
    smem = narrow if threads == THREADS else wide
    if smem <= SMEM_MAX:
        chunk = max(1, min(pixels, CHUNK_BYTES // (2 * c)), -(-pixels // MAX_CHUNKS))
        return GNPlan(-(-hw // pixels), pixels, chunk, threads, smem, False)
    pixels = max(1, TWO_PASS_BYTES // bpp)
    return GNPlan(-(-hw // pixels), pixels, pixels, THREADS, 0, True)


def _fwd_fn():
    global _FWD
    if _FWD is None:
        fn = build.library("group_norm").dmme_gn_silu_fwd
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([vp] * 4 + [vp, i, vp, i, vp, i] + [i] * 4 + [ctypes.c_float]
                       + [i] * 5 + [vp] * 3)
        fn.restype = i
        _FWD = fn
    return _FWD


def _bwd_fn():
    global _BWD
    if _BWD is None:
        fn = build.library("group_norm").dmme_gn_silu_bwd
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 8 + [vp, i, vp, i, vp, i] + [i] * 4 + [i] * 5 + [vp] * 4
        fn.restype = i
        _BWD = fn
    return _BWD


def _check(x, num_groups: int, what: str) -> None:
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by {num_groups} groups")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what} kernel takes bf16 activations, got {x.dtype}")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous with a 16-byte aligned start, as the bulk copies read it."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(x, gamma, beta, bias, num_groups: int, eps: float):
    global launches
    n, h, w, c = x.shape
    _check(x, num_groups, "group_norm_silu")
    plan = gn_plan(n, h, w, c, num_groups, build.sm_count(x.device))
    x = _aligned(x)
    (gamma, sg), (beta, sb) = broadcast_rows(gamma, n, c), broadcast_rows(beta, n, c)
    bias, sp = broadcast_rows(bias, n, c) if bias is not None else (None, 0)
    y = torch.empty_like(x)
    mean = torch.empty((n, num_groups), device=x.device, dtype=torch.float32)
    inv = torch.empty_like(mean)
    part = coef = None  # two-pass scratch
    if plan.two_pass:
        part = torch.empty((n * plan.blocks * 2 * c,), device=x.device, dtype=torch.float32)
        coef = torch.empty((n * 2 * c,), device=x.device, dtype=torch.float32)
    status = _fwd_fn()(
        x.data_ptr(), y.data_ptr(), mean.data_ptr(), inv.data_ptr(), gamma.data_ptr(), sg,
        beta.data_ptr(), sb, _ptr(bias), sp, n, h * w, c, num_groups, float(eps),
        plan.blocks, plan.pixels, plan.chunk, plan.threads, int(plan.two_pass),
        _ptr(part), _ptr(coef), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "group_norm_silu kernel launch")
    launches += 1
    return y, mean, inv


def _launch_bwd(x, dz, gamma, beta, bias, mean, inv, num_groups: int):
    global bwd_launches
    n, h, w, c = x.shape
    _check(x, num_groups, "group_norm_silu backward")
    if dz.dtype != x.dtype:
        raise TypeError(f"group_norm_silu backward kernel takes bf16 dz, got {dz.dtype}")
    if dz.shape != x.shape:
        raise ValueError(f"dz shape {tuple(dz.shape)} differs from x's {tuple(x.shape)}")
    if mean.shape != (n, num_groups) or inv.shape != (n, num_groups):
        raise ValueError(f"statistics must be ({n}, {num_groups}), got {tuple(mean.shape)}")
    plan = gn_plan(n, h, w, c, num_groups, build.sm_count(x.device), backward=True)
    x, dz = _aligned(x), _aligned(dz)
    mean, inv = mean.to(torch.float32).contiguous(), inv.to(torch.float32).contiguous()
    (gamma, sg), (beta, sb) = broadcast_rows(gamma, n, c), broadcast_rows(beta, n, c)
    bias, sp = broadcast_rows(bias, n, c) if bias is not None else (None, 0)
    dx = torch.empty_like(x)
    dgamma, dbeta, dbias = (torch.empty((n, c), device=x.device, dtype=torch.float32)
                            for _ in range(3))
    part = part2 = coef = None  # two-pass scratch
    if plan.two_pass:
        f32 = dict(device=x.device, dtype=torch.float32)
        part = torch.empty((n * plan.blocks * 2 * c,), **f32)
        part2 = torch.empty((n * plan.blocks * c,), **f32)
        coef = torch.empty((n * 2 * c,), **f32)
    status = _bwd_fn()(
        x.data_ptr(), dz.data_ptr(), dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
        dbias.data_ptr(), mean.data_ptr(), inv.data_ptr(), gamma.data_ptr(), sg,
        beta.data_ptr(), sb, _ptr(bias), sp, n, h * w, c, num_groups,
        plan.blocks, plan.pixels, plan.chunk, plan.threads, int(plan.two_pass),
        _ptr(part), _ptr(part2), _ptr(coef), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "group_norm_silu backward kernel launch")
    bwd_launches += 1
    return dx, dgamma, dbeta, dbias


def _simt_fwd_fn():
    global _SIMT_FWD
    if _SIMT_FWD is None:
        fn = build.library("simt").dmme_simt_gn_fwd
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i] + [vp] * 5 + [i, vp, i, vp, i] + [i] * 4 + [ctypes.c_float, vp]
        fn.restype = i
        _SIMT_FWD = fn
    return _SIMT_FWD


def _simt_bwd_fn():
    global _SIMT_BWD
    if _SIMT_BWD is None:
        fn = build.library("simt").dmme_simt_gn_bwd
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [vp] * 9 + [i, vp, i, vp, i] + [i] * 4 + [vp]
        fn.restype = i
        _SIMT_BWD = fn
    return _SIMT_BWD


def _launch_simt(x, gamma, beta, bias, num_groups: int, eps: float):
    """K1 for f32 or fp16 ``x`` (``csrc/simt.cu``): a block per (group,
    sample), the same outputs as :func:`_launch`."""
    global simt_launches
    n, h, w, c = x.shape
    code = simt_code(x, "group_norm_silu")
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by {num_groups} groups")
    x = x.contiguous()
    (gamma, sg), (beta, sb) = broadcast_rows(gamma, n, c), broadcast_rows(beta, n, c)
    bias, sp = broadcast_rows(bias, n, c) if bias is not None else (None, 0)
    y = torch.empty_like(x)
    mean = torch.empty((n, num_groups), device=x.device, dtype=torch.float32)
    inv = torch.empty_like(mean)
    status = _simt_fwd_fn()(
        code, code, x.data_ptr(), y.data_ptr(), mean.data_ptr(), inv.data_ptr(),
        gamma.data_ptr(), sg, beta.data_ptr(), sb, _ptr(bias), sp, n, h * w, c, num_groups,
        float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "group_norm_silu simt kernel launch")
    simt_launches += 1
    return y, mean, inv


def _launch_bwd_simt(x, dz, gamma, beta, bias, mean, inv, num_groups: int):
    """K2 for f32 or fp16 ``x`` (``csrc/simt.cu``): the outputs of
    :func:`_launch_bwd`."""
    global simt_bwd_launches
    n, h, w, c = x.shape
    code = simt_code(x, "group_norm_silu backward")
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by {num_groups} groups")
    if dz.shape != x.shape:
        raise ValueError(f"dz shape {tuple(dz.shape)} differs from x's {tuple(x.shape)}")
    if mean.shape != (n, num_groups) or inv.shape != (n, num_groups):
        raise ValueError(f"statistics must be ({n}, {num_groups}), got {tuple(mean.shape)}")
    x, dz = x.contiguous(), dz.to(x.dtype).contiguous()
    mean, inv = mean.to(torch.float32).contiguous(), inv.to(torch.float32).contiguous()
    (gamma, sg), (beta, sb) = broadcast_rows(gamma, n, c), broadcast_rows(beta, n, c)
    bias, sp = broadcast_rows(bias, n, c) if bias is not None else (None, 0)
    dx = torch.empty_like(x)
    dgamma, dbeta, dbias = (torch.empty((n, c), device=x.device, dtype=torch.float32)
                            for _ in range(3))
    status = _simt_bwd_fn()(
        code, x.data_ptr(), dz.data_ptr(), dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
        dbias.data_ptr(), mean.data_ptr(), inv.data_ptr(), gamma.data_ptr(), sg,
        beta.data_ptr(), sb, _ptr(bias), sp, n, h * w, c, num_groups,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "group_norm_silu backward simt kernel launch")
    simt_bwd_launches += 1
    return dx, dgamma, dbeta, dbias


def group_norm_silu_fwd(x, gamma, beta, num_groups: int, eps: float = GN_EPS,
                        pre_bias: Optional[torch.Tensor] = None):
    """(y, mean, inv): y = silu(GN(x + pre_bias)·γ + β) and the (N, G) f32
    statistics. CPU tensors take :func:`gn_silu_plain`; bf16 CUDA tensors
    K1, f32 and fp16 ones its ``simt.cu`` version
    (:func:`~dmme_tpu_torch.ops.route`)."""
    where = route(x.device, x.dtype, "group_norm_silu")
    if where == "kernel":
        return _launch(x, gamma, beta, pre_bias, num_groups, eps)
    if where == "simt":
        return _launch_simt(x, gamma, beta, pre_bias, num_groups, eps)
    return gn_silu_plain(x, gamma, beta, pre_bias, num_groups, eps)


def group_norm_silu_bwd(x, dz, gamma, beta, pre_bias, mean, inv, num_groups: int):
    """(dx, dγ, dβ, dbias) of :func:`group_norm_silu_fwd` from its saved
    statistics; the three vectors (N, C) f32. CPU tensors take
    :func:`gn_silu_bwd_plain`; bf16 CUDA tensors K2, f32 and fp16 ones its
    ``simt.cu`` version."""
    where = route(x.device, x.dtype, "group_norm_silu backward")
    if where == "kernel":
        return _launch_bwd(x, dz, gamma, beta, pre_bias, mean, inv, num_groups)
    if where == "simt":
        return _launch_bwd_simt(x, dz, gamma, beta, pre_bias, mean, inv, num_groups)
    return gn_silu_bwd_plain(x, dz, gamma, beta, pre_bias, mean, inv, num_groups)


def _grad_like(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """An (N, C) f32 gradient in the shape and dtype of its input: a (C,)
    vector shared by the batch gets the sum over N."""
    return (g.sum(dim=0) if like.dim() == 1 else g).to(like.dtype)


class GroupNormSiLU(torch.autograd.Function):
    """y = silu(GN(x + pre_bias)·γ + β), differentiable in x, γ, β and
    pre_bias: K1 forward and K2 backward on a CUDA tensor, their plain
    versions on a CPU one. Saves x, the affines and the (N, G) statistics."""

    @staticmethod
    def forward(ctx, x, gamma, beta, pre_bias, num_groups: int, eps: float):
        y, mean, inv = group_norm_silu_fwd(x, gamma, beta, num_groups, eps, pre_bias)
        ctx.save_for_backward(x, gamma, beta, pre_bias, mean, inv)
        ctx.num_groups = num_groups
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, pre_bias, mean, inv = ctx.saved_tensors
        dx, dgamma, dbeta, dbias = group_norm_silu_bwd(
            x, dy, gamma, beta, pre_bias, mean, inv, ctx.num_groups)
        return (dx, _grad_like(dgamma, gamma), _grad_like(dbeta, beta),
                None if pre_bias is None else _grad_like(dbias, pre_bias), None, None)


def group_norm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    num_groups: int, eps: float = GN_EPS,
                    pre_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """silu(GN(x + pre_bias)·gamma + beta) with per-sample affine, through
    :class:`GroupNormSiLU` (differentiable in all four tensors).

    ``x``: (N, H, W, C); ``gamma``/``beta``: (C,) or (N, C); ``pre_bias``:
    optional (N, C) channel bias added before normalisation (the DDPM
    ResBlock's additive conditioning). Output in x's dtype.
    """
    return GroupNormSiLU.apply(x, gamma, beta, pre_bias, num_groups, eps)
