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

Both take bf16, fp16 and f32 activations (the element type a template
parameter of the kernels) with f32 statistics and sums. Bound on the card:
bytes, for both. Each does a few tens of f32 operations per element, far
below the H100's ~295 bf16 operations per byte, so the least time is one
read of every input and one write of every output (x→y; x, dz→dx). Design
(details in the source): a block owns a contiguous slab of one sample's
NHWC pixels, all channels, brought into shared memory by TMA bulk copies
and kept there between the statistics and the apply, so each input byte
crosses DRAM once; threads own 8 channels (one 16-byte vector of bf16 or
fp16, two of f32), and a group is summed from per-channel sums, so any
C % 8 == 0 with C % G == 0 works, and the three dtypes sum in one order. A
sample larger than one block's slab is split over a thread-block cluster
of up to 8 blocks that exchange their channel partials through distributed
shared memory; one that no cluster of 8 holds takes two passes over global
memory with per-chunk partials summed in chunk order (the kernels take
clusters of up to 16, but at the one training site where 8 cannot hold a
sample, f32 K2 at 32×32×256, 16 measured slower than two passes on an
H100: PERF.md). No float atomics: repeated runs agree bit for bit. The
plan is :func:`gn_plan`, made once per shape and element size. A γ or β
shared by the batch is read through a row stride of 0, not copied per
sample. Launches per call: 1 in one pass; 3 (K1) or 4 (K2) in two. Calls
are counted per dtype: ``launches`` and ``bwd_launches`` (bf16),
``fp16_launches``, ``fp16_bwd_launches``, ``f32_launches``,
``f32_bwd_launches``.

A width outside those kernels' domain (C % 8 != 0, or C > 2048) takes
K1's and K2's versions in ``csrc/simt.cu`` in every dtype
(:func:`_launch_simt`, :func:`_launch_bwd_simt`; ``simt_launches`` and
``simt_bwd_launches``): a block per (group, sample) sums per channel, then
per group, in a fixed order, and passes over the group's pixels again for
the output; one launch a call. The choice is made from the shape and dtype
before any build or launch (:func:`kernel_takes`), never after a failure.

On an H-shard of the ``spatial`` mesh axis (``parallel/spatial.py``) a
rank holds H/S rows of each sample, so K1 and K2 split in two around an
all-reduce of (N, 2C) f32 channel sums over the spatial group
(:class:`GroupNormSiLURows`): ``sums`` (Σx, Σx² over the rows), then
``apply`` (the statistics over the whole sample's pixels, the pre-bias
folded in as K1 folds it, then y on the rows); backward ``bwd_sums`` (K2's
Σdy and Σdy·x̂ over the rows, which are also the rows' dβ and dγ), then
``bwd_dx`` (the group means from the totals, dx and the rows' dbias).
Four C entry points of ``group_norm.cu`` on its two-pass kernels, each
counted per dtype (``sums_launches`` … ``f32_bwd_dx_launches``); their
plain versions (:func:`gn_silu_sums_plain` and its siblings) do the same
arithmetic. A width outside ``group_norm.cu``'s domain raises there: no
``simt.cu`` or plain fallback on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from dmme_tpu_torch.ops import DTYPE_CODES, build, route, simt_code

GN_EPS = 1e-5

#: K1 (forward) and K2 (backward) launches since the last reset, per
#: activation dtype (incremented only by their launchers): bf16, fp16, f32
launches = 0
bwd_launches = 0
fp16_launches = 0
fp16_bwd_launches = 0
f32_launches = 0
f32_bwd_launches = 0
#: launches of the forward and backward of ``csrc/simt.cu``, which take the
#: widths outside ``group_norm.cu``'s domain (:func:`kernel_takes`), in every
#: dtype; incremented only by their launchers
simt_launches = 0
simt_bwd_launches = 0
# the counters of each dtype's launches: forward, backward
_COUNTERS = {torch.bfloat16: ("launches", "bwd_launches"),
             torch.float16: ("fp16_launches", "fp16_bwd_launches"),
             torch.float32: ("f32_launches", "f32_bwd_launches")}
#: launches of the four split entries (an H-shard of the ``spatial`` mesh
#: axis: :func:`group_norm_silu_rows`) since the last reset, per dtype
#: (bf16; ``fp16_``/``f32_`` prefixed), incremented only by their launchers
sums_launches = apply_launches = bwd_sums_launches = bwd_dx_launches = 0
fp16_sums_launches = fp16_apply_launches = fp16_bwd_sums_launches = fp16_bwd_dx_launches = 0
f32_sums_launches = f32_apply_launches = f32_bwd_sums_launches = f32_bwd_dx_launches = 0
#: the split entries, in the order a forward and its backward launch them
SPLIT_ENTRIES = ("sums", "apply", "bwd_sums", "bwd_dx")
_PREFIX = {torch.bfloat16: "", torch.float16: "fp16_", torch.float32: "f32_"}

#: the bound C entry points, by name
_FNS: dict = {}

# the plan's constants (csrc/group_norm.cu)
VEC = 8                        # channels a thread: a 16-byte vector of bf16 or fp16
THREADS = 256                  # threads a block of K2 (where two fit an SM) and of two passes
WIDE_THREADS = 512             # threads a one-pass K1 block, and a K2 block alone on its SM
HALF_SM = 113 * 1024           # shared memory a block may take for two to share an SM
MAX_CHUNKS = 16                # bulk copies a block
CHUNK_BYTES = 32 * 1024        # bytes a bulk copy of a tensor, where the slab allows
MAX_CLUSTER = 8                # blocks a cluster: the portable limit
# cluster sizes, smallest first: on an H100 a cluster of 4 was slower than one
# of 8 (or of 2 with twice the slab) at every bf16 and fp16 training site and
# at f32 K2's; f32 K1 takes 4 too, which at 16x16x512 ran 0.0928 ms against
# 0.1212 in clusters of 8 (PERF.md, scripts/torch_gn_plans.py)
CLUSTERS = (1, 2, 8)
F32_FWD_CLUSTERS = (1, 2, 4, 8)
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
    return gn_silu_apply_plain(x, gn_silu_sums_plain(x), gamma, beta, bias, num_groups,
                               x.shape[1] * x.shape[2], eps)


def gn_silu_sums_plain(x) -> torch.Tensor:
    """Plain version of the split forward's first half: Σx and Σx² per
    (sample, channel) over x's rows, in f32: (N, 2C)."""
    xf = x.to(torch.float32)
    return torch.cat([xf.sum(dim=(1, 2)), torch.square(xf).sum(dim=(1, 2))], dim=-1)


def gn_silu_apply_plain(x, sums, gamma, beta, bias, num_groups: int, pixels: int,
                        eps: float = GN_EPS) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the split forward's second half: the statistics of
    a sample of ``pixels`` pixels from its (N, 2C) channel sums ``sums``
    (:func:`gn_silu_sums_plain`, summed over its row shards), the pre-bias
    folded in, then y on x's rows. Returns (y, mean, inv)."""
    n, _, _, c = x.shape
    gamma, beta = broadcast_rows(gamma, n, c)[0], broadcast_rows(beta, n, c)[0]
    bias = (torch.zeros((n, c), device=x.device, dtype=torch.float32) if bias is None
            else broadcast_rows(bias, n, c)[0])
    hw, cg = pixels, c // num_groups
    xf = x.to(torch.float32)
    chan_sum, chan_sq = sums[:, :c], sums[:, c:]
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


def gn_silu_bwd_sums_plain(x, dz, gamma, beta, bias, mean, inv, num_groups: int) -> torch.Tensor:
    """Plain version of the split backward's first half: K2's channel sums
    Σdy and Σdy·x̂ over x's rows, in f32: (N, 2C), the rows' dβ and dγ."""
    xhat, dy, _ = _xhat_dy(x, dz, gamma, beta, bias, mean, inv, num_groups)
    return torch.cat([dy.sum(dim=(1, 2)), (dy * xhat).sum(dim=(1, 2))], dim=-1)


def gn_silu_bwd_dx_plain(x, dz, gamma, beta, bias, mean, inv, sums, num_groups: int,
                         pixels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the split backward's second half: from a sample's
    (N, 2C) sums (:func:`gn_silu_bwd_sums_plain`, summed over its row
    shards) of ``pixels`` pixels, the group means m1 = Σ_c γ·Σdy and m2 =
    Σ_c γ·Σdy·x̂ over the group's elements, then dx on x's rows and its
    (N, C) f32 sum (the rows' dbias). Returns (dx in x's dtype, dbias)."""
    n, _, _, c = x.shape
    xhat, dy, gamma = _xhat_dy(x, dz, gamma, beta, bias, mean, inv, num_groups)
    cg = c // num_groups
    cnt = pixels * cg
    m1 = (sums[:, :c] * gamma).reshape(n, num_groups, cg).sum(-1) / cnt
    m2 = (sums[:, c:] * gamma).reshape(n, num_groups, cg).sum(-1) / cnt

    def per_channel(v):  # (N, G) -> (N, 1, 1, C)
        return v.repeat_interleave(cg, dim=1)[:, None, None, :]

    du = per_channel(inv) * (dy * gamma[:, None, None, :] - per_channel(m1)
                             - xhat * per_channel(m2))
    return du.to(x.dtype), du.sum(dim=(1, 2))


def _xhat_dy(x, dz, gamma, beta, bias, mean, inv, num_groups: int):
    """K2's x̂ and dy on x's rows in f32, and γ as (N, C) f32 rows."""
    n, _, _, c = x.shape
    gamma, beta = broadcast_rows(gamma, n, c)[0], broadcast_rows(beta, n, c)[0]
    bias = (torch.zeros((n, c), device=x.device, dtype=torch.float32) if bias is None
            else broadcast_rows(bias, n, c)[0])
    cg = c // num_groups

    def per_channel(v):  # (N, G) -> (N, 1, 1, C)
        return v.to(torch.float32).repeat_interleave(cg, dim=1)[:, None, None, :]

    xhat = (x.to(torch.float32) + bias[:, None, None, :] - per_channel(mean)) * per_channel(inv)
    y = xhat * gamma[:, None, None, :] + beta[:, None, None, :]
    s = torch.sigmoid(y)
    return xhat, dz.to(torch.float32) * (s * (1.0 + y * (1.0 - s))), gamma


def _smem_bytes(backward: bool, pixels: int, c: int, threads: int, size: int = 2) -> int:
    """Dynamic shared memory of a one-pass block on ``size``-byte elements:
    the slab (x, and dz for the backward), the row sums of two quantities,
    the channel partials, totals, coefficients and the sample's rows, the
    mbarriers and alignment slack. The arithmetic of ``Layout`` in
    csrc/group_norm.cu."""
    slab = -(-pixels * c * size // 128) * 128
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


def kernel_takes(c: int) -> bool:
    """Whether ``group_norm.cu`` takes C channels (C % 8 == 0, C <= 2048);
    other widths go to ``simt.cu``."""
    return c % VEC == 0 and c <= VEC * THREADS


def chunk_pixels(pixels: int, c: int, size: int) -> int:
    """Pixels a bulk copy of a one-pass block: ``CHUNK_BYTES`` a tensor,
    unless that takes more than ``MAX_CHUNKS`` copies."""
    return max(1, min(pixels, CHUNK_BYTES // (size * c)), -(-pixels // MAX_CHUNKS))


def _one_pass(backward: bool, pixels: int, c: int, size: int) -> Tuple[int, int]:
    """(threads, shared memory) of a one-pass block of ``pixels`` pixels."""
    narrow = _smem_bytes(backward, pixels, c, THREADS, size)
    wide = _smem_bytes(backward, pixels, c, WIDE_THREADS, size)
    if (backward and narrow <= HALF_SM) or wide > SMEM_MAX:
        return THREADS, narrow
    return WIDE_THREADS, wide


@functools.lru_cache(maxsize=None)
def gn_plan(n: int, h: int, w: int, c: int, groups: int, sms: int,
            backward: bool = False, size: int = 2) -> GNPlan:
    """K1's (or, with ``backward``, K2's) grid for (N, H, W, C) inputs of
    ``size``-byte elements (2: bf16 and fp16, which share every plan; 4:
    f32) on a card with ``sms`` SMs, made once per shape. One pass where a
    cluster of at most 8 blocks holds a sample in shared memory: the
    smallest cluster of ``CLUSTERS`` (f32 K1: ``F32_FWD_CLUSTERS``) whose
    blocks' slabs are at most ``SLAB_TARGET`` bytes, then a larger one while
    the batch fills at most half the SMs and the slabs stay above
    ``SLAB_MIN``. One-pass K1 blocks
    take ``WIDE_THREADS``. A K2 thread holds about twice K1's registers, so
    512 of them fill an SM's register file: K2 blocks take ``THREADS`` where
    two such blocks share an SM's shared memory, else ``WIDE_THREADS``; any
    block takes ``THREADS`` where ``WIDE_THREADS`` would not fit. Where 8
    blocks cannot hold a sample, two passes over chunks of
    ``TWO_PASS_BYTES``."""
    if c % groups:
        raise ValueError(f"group_norm_silu kernel: {c} channels in {groups} groups")
    if not kernel_takes(c):
        raise ValueError(f"group_norm_silu kernel takes C % {VEC} == 0 and C <= "
                         f"{VEC * THREADS}, got {c}")
    hw = h * w
    bpp = size * c * (2 if backward else 1)  # slab bytes a pixel
    sizes = F32_FWD_CLUSTERS if size == 4 and not backward else CLUSTERS
    i = next((i for i, k in enumerate(sizes) if -(-hw // k) * bpp <= SLAB_TARGET),
             len(sizes) - 1)
    while (i + 1 < len(sizes) and 2 * n * sizes[i] <= sms
           and -(-hw // sizes[i + 1]) * bpp >= SLAB_MIN):
        i += 1
    pixels = -(-hw // sizes[i])
    threads, smem = _one_pass(backward, pixels, c, size)
    if smem <= SMEM_MAX:
        return GNPlan(-(-hw // pixels), pixels, chunk_pixels(pixels, c, size), threads, smem,
                      False)
    pixels = max(1, TWO_PASS_BYTES // bpp)
    return GNPlan(-(-hw // pixels), pixels, pixels, THREADS, 0, True)


def _bound(source: str, name: str, argtypes):
    """C function ``name`` of ``csrc/<source>.cu``, bound once."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.library(source), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _FNS[name] = fn
    return fn


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _fwd_fn():
    return _bound("group_norm", "dmme_gn_silu_fwd",
                  [_I] + [_VP] * 4 + [_VP, _I, _VP, _I, _VP, _I] + [_I] * 4 + [_F] + [_I] * 5
                  + [_VP] * 3)


def _bwd_fn():
    return _bound("group_norm", "dmme_gn_silu_bwd",
                  [_I] + [_VP] * 8 + [_VP, _I, _VP, _I, _VP, _I] + [_I] * 4 + [_I] * 5
                  + [_VP] * 4)


def _simt_fwd_fn():
    return _bound("simt", "dmme_simt_gn_fwd",
                  [_I, _I] + [_VP] * 5 + [_I, _VP, _I, _VP, _I] + [_I] * 4 + [_F, _VP])


def _simt_bwd_fn():
    return _bound("simt", "dmme_simt_gn_bwd",
                  [_I] + [_VP] * 9 + [_I, _VP, _I, _VP, _I] + [_I] * 4 + [_VP])


def _check(x, num_groups: int, what: str) -> int:
    """The dtype code of ``x`` (``csrc/group_norm.cu``); raises for a dtype
    or a width the kernel lacks."""
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by {num_groups} groups")
    if x.dtype not in _COUNTERS:
        raise TypeError(f"{what} kernel takes bf16, fp16 or f32 activations, got {x.dtype}")
    return DTYPE_CODES[x.dtype]


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous with a 16-byte aligned start, as the bulk copies read it."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _count(x: torch.Tensor, backward: bool) -> None:
    name = _COUNTERS[x.dtype][backward]
    globals()[name] += 1


def _launch(x, gamma, beta, bias, num_groups: int, eps: float):
    n, h, w, c = x.shape
    code = _check(x, num_groups, "group_norm_silu")
    plan = gn_plan(n, h, w, c, num_groups, build.sm_count(x.device), False, x.element_size())
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
        code, x.data_ptr(), y.data_ptr(), mean.data_ptr(), inv.data_ptr(), gamma.data_ptr(), sg,
        beta.data_ptr(), sb, _ptr(bias), sp, n, h * w, c, num_groups, float(eps),
        plan.blocks, plan.pixels, plan.chunk, plan.threads, int(plan.two_pass),
        _ptr(part), _ptr(coef), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "group_norm_silu kernel launch")
    _count(x, False)
    return y, mean, inv


def _launch_bwd(x, dz, gamma, beta, bias, mean, inv, num_groups: int):
    n, h, w, c = x.shape
    code = _check(x, num_groups, "group_norm_silu backward")
    if dz.shape != x.shape:
        raise ValueError(f"dz shape {tuple(dz.shape)} differs from x's {tuple(x.shape)}")
    if mean.shape != (n, num_groups) or inv.shape != (n, num_groups):
        raise ValueError(f"statistics must be ({n}, {num_groups}), got {tuple(mean.shape)}")
    plan = gn_plan(n, h, w, c, num_groups, build.sm_count(x.device), True, x.element_size())
    x, dz = _aligned(x), _aligned(dz.to(x.dtype))
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
        code, x.data_ptr(), dz.data_ptr(), dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
        dbias.data_ptr(), mean.data_ptr(), inv.data_ptr(), gamma.data_ptr(), sg,
        beta.data_ptr(), sb, _ptr(bias), sp, n, h * w, c, num_groups,
        plan.blocks, plan.pixels, plan.chunk, plan.threads, int(plan.two_pass),
        _ptr(part), _ptr(part2), _ptr(coef), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "group_norm_silu backward kernel launch")
    _count(x, True)
    return dx, dgamma, dbeta, dbias


def _launch_simt(x, gamma, beta, bias, num_groups: int, eps: float):
    """K1 on ``csrc/simt.cu``, for a width :func:`kernel_takes` refuses (any
    C % G == 0; bf16, fp16 or f32): a block per (group, sample), the same
    outputs as :func:`_launch`."""
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
    """K2 on ``csrc/simt.cu``, for the widths of :func:`_launch_simt`: the
    outputs of :func:`_launch_bwd`."""
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


def split_plan(h: int, w: int, c: int, size: int, backward: bool) -> Tuple[int, int]:
    """(blocks, pixels) of a split entry's passes over an (N, h, w, C) shard
    of ``size``-byte elements: the two-pass kernels' chunks of
    ``TWO_PASS_BYTES`` (x, and dz for the backward)."""
    pixels = max(1, TWO_PASS_BYTES // (size * c * (2 if backward else 1)))
    return -(-(h * w) // pixels), pixels


def _split_fn(name: str, argtypes):
    return _bound("group_norm", f"dmme_gn_silu_{name}", argtypes)


def _count_split(x: torch.Tensor, entry: str) -> None:
    name = f"{_PREFIX[x.dtype]}{entry}_launches"
    globals()[name] += 1


def _launch_sums(x):
    n, h, w, c = x.shape
    code = _check(x, 1, "group_norm_silu split sums")
    blocks, pixels = split_plan(h, w, c, x.element_size(), False)
    x = _aligned(x)
    f32 = dict(device=x.device, dtype=torch.float32)
    sums = torch.empty((n, 2 * c), **f32)
    part = torch.empty((n * blocks * 2 * c,), **f32)
    status = _split_fn("fwd_sums", [_I, _VP, _VP, _VP] + [_I] * 5 + [_VP])(
        code, x.data_ptr(), sums.data_ptr(), part.data_ptr(), n, h * w, c, blocks, pixels,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "group_norm_silu split sums kernel launch")
    _count_split(x, "sums")
    return sums


def _launch_apply(x, sums, gamma, beta, bias, num_groups: int, pixels_total: int, eps: float):
    n, h, w, c = x.shape
    code = _check(x, num_groups, "group_norm_silu split apply")
    blocks, pixels = split_plan(h, w, c, x.element_size(), False)
    x, sums = _aligned(x), sums.to(torch.float32).contiguous()
    (gamma, sg), (beta, sb) = broadcast_rows(gamma, n, c), broadcast_rows(beta, n, c)
    bias, sp = broadcast_rows(bias, n, c) if bias is not None else (None, 0)
    y = torch.empty_like(x)
    mean = torch.empty((n, num_groups), device=x.device, dtype=torch.float32)
    inv = torch.empty_like(mean)
    coef = torch.empty((n * 2 * c,), device=x.device, dtype=torch.float32)
    status = _split_fn("fwd_apply", [_I] + [_VP] * 5 + [_VP, _I, _VP, _I, _VP, _I] + [_I] * 5
                       + [_F, _I, _I, _VP, _VP])(
        code, x.data_ptr(), y.data_ptr(), mean.data_ptr(), inv.data_ptr(), sums.data_ptr(),
        gamma.data_ptr(), sg, beta.data_ptr(), sb, _ptr(bias), sp, n, h * w, pixels_total, c,
        num_groups, float(eps), blocks, pixels, coef.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "group_norm_silu split apply kernel launch")
    _count_split(x, "apply")
    return y, mean, inv


def _launch_bwd_sums(x, dz, gamma, beta, bias, mean, inv, num_groups: int):
    n, h, w, c = x.shape
    code = _check(x, num_groups, "group_norm_silu split backward sums")
    blocks, pixels = split_plan(h, w, c, x.element_size(), True)
    x, dz = _aligned(x), _aligned(dz.to(x.dtype))
    mean, inv = mean.to(torch.float32).contiguous(), inv.to(torch.float32).contiguous()
    (gamma, sg), (beta, sb) = broadcast_rows(gamma, n, c), broadcast_rows(beta, n, c)
    bias, sp = broadcast_rows(bias, n, c) if bias is not None else (None, 0)
    f32 = dict(device=x.device, dtype=torch.float32)
    sums = torch.empty((n, 2 * c), **f32)
    part = torch.empty((n * blocks * 2 * c,), **f32)
    status = _split_fn("bwd_sums", [_I] + [_VP] * 4 + [_VP, _I, _VP, _I, _VP, _I] + [_VP, _VP]
                       + [_I] * 6 + [_VP])(
        code, x.data_ptr(), dz.data_ptr(), mean.data_ptr(), inv.data_ptr(), gamma.data_ptr(),
        sg, beta.data_ptr(), sb, _ptr(bias), sp, sums.data_ptr(), part.data_ptr(), n, h * w, c,
        num_groups, blocks, pixels, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "group_norm_silu split backward sums kernel launch")
    _count_split(x, "bwd_sums")
    return sums


def _launch_bwd_dx(x, dz, gamma, beta, bias, mean, inv, sums, num_groups: int,
                   pixels_total: int):
    n, h, w, c = x.shape
    code = _check(x, num_groups, "group_norm_silu split backward dx")
    blocks, pixels = split_plan(h, w, c, x.element_size(), True)
    x, dz = _aligned(x), _aligned(dz.to(x.dtype))
    mean, inv = mean.to(torch.float32).contiguous(), inv.to(torch.float32).contiguous()
    sums = sums.to(torch.float32).contiguous()
    (gamma, sg), (beta, sb) = broadcast_rows(gamma, n, c), broadcast_rows(beta, n, c)
    bias, sp = broadcast_rows(bias, n, c) if bias is not None else (None, 0)
    dx = torch.empty_like(x)
    f32 = dict(device=x.device, dtype=torch.float32)
    dbias = torch.empty((n, c), **f32)
    part2 = torch.empty((n * blocks * c,), **f32)
    coef = torch.empty((n * 2 * c,), **f32)
    status = _split_fn("bwd_dx", [_I] + [_VP] * 7 + [_VP, _I, _VP, _I, _VP, _I] + [_I] * 7
                       + [_VP] * 3)(
        code, x.data_ptr(), dz.data_ptr(), dx.data_ptr(), dbias.data_ptr(), mean.data_ptr(),
        inv.data_ptr(), sums.data_ptr(), gamma.data_ptr(), sg, beta.data_ptr(), sb, _ptr(bias),
        sp, n, h * w, pixels_total, c, num_groups, blocks, pixels, part2.data_ptr(),
        coef.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "group_norm_silu split backward dx kernel launch")
    _count_split(x, "bwd_dx")
    return dx, dbias


def _split_where(x: torch.Tensor) -> str:
    """"cpu" or "kernel" for an H-shard ``x``: a width outside
    ``group_norm.cu``'s domain raises (no ``simt.cu`` split path)."""
    where = route(x.device, x.dtype, "group_norm_silu")
    if where == "kernel" and not kernel_takes(x.shape[-1]):
        raise NotImplementedError(
            f"group_norm_silu on an H-shard of the spatial mesh axis takes C % {VEC} == 0 and "
            f"C <= {VEC * THREADS} (group_norm.cu's split entries), got C = {x.shape[-1]}; "
            "simt.cu has no split statistics (ROADMAP A.11)")
    return where


def group_norm_silu_sums(x) -> torch.Tensor:
    """(N, 2C) f32 Σx, Σx² of an H-shard ``x`` per (sample, channel): the
    split entry ``fwd_sums`` on a CUDA tensor, :func:`gn_silu_sums_plain`
    on a CPU one."""
    if _split_where(x) == "kernel":
        return _launch_sums(x)
    return gn_silu_sums_plain(x)


def group_norm_silu_apply(x, sums, gamma, beta, num_groups: int, pixels: int,
                          eps: float = GN_EPS, pre_bias: Optional[torch.Tensor] = None):
    """(y, mean, inv) of an H-shard ``x`` from the whole sample's (N, 2C)
    sums over its ``pixels`` pixels: ``fwd_apply`` on a CUDA tensor,
    :func:`gn_silu_apply_plain` on a CPU one."""
    if _split_where(x) == "kernel":
        return _launch_apply(x, sums, gamma, beta, pre_bias, num_groups, pixels, eps)
    return gn_silu_apply_plain(x, sums, gamma, beta, pre_bias, num_groups, pixels, eps)


def group_norm_silu_bwd_sums(x, dz, gamma, beta, pre_bias, mean, inv,
                             num_groups: int) -> torch.Tensor:
    """(N, 2C) f32 Σdy, Σdy·x̂ of an H-shard: ``bwd_sums`` on a CUDA
    tensor, :func:`gn_silu_bwd_sums_plain` on a CPU one."""
    if _split_where(x) == "kernel":
        return _launch_bwd_sums(x, dz, gamma, beta, pre_bias, mean, inv, num_groups)
    return gn_silu_bwd_sums_plain(x, dz, gamma, beta, pre_bias, mean, inv, num_groups)


def group_norm_silu_bwd_dx(x, dz, gamma, beta, pre_bias, mean, inv, sums, num_groups: int,
                           pixels: int):
    """(dx, dbias) of an H-shard from the whole sample's (N, 2C) backward
    sums: ``bwd_dx`` on a CUDA tensor, :func:`gn_silu_bwd_dx_plain` on a
    CPU one."""
    if _split_where(x) == "kernel":
        return _launch_bwd_dx(x, dz, gamma, beta, pre_bias, mean, inv, sums, num_groups, pixels)
    return gn_silu_bwd_dx_plain(x, dz, gamma, beta, pre_bias, mean, inv, sums, num_groups,
                                pixels)


def _where(x: torch.Tensor) -> str:
    """"cpu", "kernel" or "simt" for ``x``, from its device, dtype and width."""
    where = route(x.device, x.dtype, "group_norm_silu")
    if where == "kernel" and not kernel_takes(x.shape[-1]):
        return "simt"
    return where


def group_norm_silu_fwd(x, gamma, beta, num_groups: int, eps: float = GN_EPS,
                        pre_bias: Optional[torch.Tensor] = None):
    """(y, mean, inv): y = silu(GN(x + pre_bias)·γ + β) and the (N, G) f32
    statistics. CPU tensors take :func:`gn_silu_plain`; bf16, fp16 and f32
    CUDA tensors K1 (:func:`~dmme_tpu_torch.ops.route`), or its ``simt.cu``
    version at a width outside K1's domain (:func:`kernel_takes`)."""
    where = _where(x)
    if where == "kernel":
        return _launch(x, gamma, beta, pre_bias, num_groups, eps)
    if where == "simt":
        return _launch_simt(x, gamma, beta, pre_bias, num_groups, eps)
    return gn_silu_plain(x, gamma, beta, pre_bias, num_groups, eps)


def group_norm_silu_bwd(x, dz, gamma, beta, pre_bias, mean, inv, num_groups: int):
    """(dx, dγ, dβ, dbias) of :func:`group_norm_silu_fwd` from its saved
    statistics; the three vectors (N, C) f32. CPU tensors take
    :func:`gn_silu_bwd_plain`; CUDA tensors K2, or its ``simt.cu`` version
    as :func:`group_norm_silu_fwd` decides."""
    where = _where(x)
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


class GroupNormSiLURows(torch.autograd.Function):
    """:class:`GroupNormSiLU` on an H-shard of the ``spatial`` mesh axis
    (``parallel/spatial.py``): the rank's channel sums, all-reduced over
    the spatial group, then the rows normalized with the whole sample's
    statistics; the backward likewise, its group means from the
    all-reduced sums. dγ, dβ and dbias are the rows' partial sums (the
    world all-reduce of whole leaves completes them)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, pre_bias, num_groups: int, eps: float, where):
        pixels = x.shape[1] * where.size * x.shape[2]
        sums = where.reduce_(group_norm_silu_sums(x))
        y, mean, inv = group_norm_silu_apply(x, sums, gamma, beta, num_groups, pixels, eps,
                                             pre_bias)
        ctx.save_for_backward(x, gamma, beta, pre_bias, mean, inv)
        ctx.num_groups, ctx.pixels, ctx.where = num_groups, pixels, where
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, pre_bias, mean, inv = ctx.saved_tensors
        c = x.shape[-1]
        mine = group_norm_silu_bwd_sums(x, dy, gamma, beta, pre_bias, mean, inv, ctx.num_groups)
        total = ctx.where.reduce_(mine.clone())
        dx, dbias = group_norm_silu_bwd_dx(x, dy, gamma, beta, pre_bias, mean, inv, total,
                                           ctx.num_groups, ctx.pixels)
        return (dx, _grad_like(mine[:, c:], gamma), _grad_like(mine[:, :c], beta),
                None if pre_bias is None else _grad_like(dbias, pre_bias), None, None, None)


def group_norm_silu_rows(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         num_groups: int, eps: float = GN_EPS,
                         pre_bias: Optional[torch.Tensor] = None, *, where) -> torch.Tensor:
    """:func:`group_norm_silu` of the whole sample on this rank's rows
    ``x`` of it, ``where`` the ``parallel.spatial.SpatialGroup`` that holds
    the other rows (:class:`GroupNormSiLURows`)."""
    return GroupNormSiLURows.apply(x, gamma, beta, pre_bias, num_groups, eps, where)
