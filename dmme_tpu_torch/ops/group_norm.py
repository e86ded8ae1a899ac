"""GroupNorm(+pre-bias, +per-sample affine)+SiLU, forward and backward:
two Triton kernels and the autograd Function that joins them.

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
output (x→y; x, dz→dx). Design: one program per (sample, group) owns its
whole group, so every group reduction is a plain in-program sum, with no
float atomics and no second launch, and repeated runs agree bit for bit.
Each kernel reads its group twice (K1: statistics, then normalise+SiLU;
K2: the four per-channel sums, then dx); the second read mostly hits L2,
which holds a 32×32×512 bf16 sample many times over. The one-hot group
matmuls of the TPU kernels are a Mosaic workaround and have no
counterpart. A γ or β shared by the batch is read through a row stride of
0, not copied per sample. Launches per call: 1 each.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

GN_EPS = 1e-5

#: K1 (forward) launches since the last reset (incremented only by its launcher)
launches = 0
#: K2 (backward) launches since the last reset (incremented only by its launcher)
bwd_launches = 0

_KERNELS = None


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


def _triton_kernel():
    global _KERNELS
    if _KERNELS is None:
        import triton
        import triton.language as tl

        @triton.jit
        def gn_silu_fwd(x_ptr, g_ptr, b_ptr, bias_ptr, y_ptr, mean_ptr, inv_ptr,
                        HW, C, G, CG, SG, SB, SP, eps, HAS_BIAS: tl.constexpr,
                        BLOCK_HW: tl.constexpr, BLOCK_C: tl.constexpr):
            pid = tl.program_id(0)
            n = pid // G
            g = pid % G
            offs_c = tl.arange(0, BLOCK_C)
            cmask = offs_c < CG
            ch = g * CG + offs_c
            base = n.to(tl.int64) * HW * C
            acc_s = tl.zeros([BLOCK_C], dtype=tl.float32)
            acc_q = tl.zeros([BLOCK_C], dtype=tl.float32)
            for start in range(0, HW, BLOCK_HW):
                offs_p = start + tl.arange(0, BLOCK_HW)
                m = (offs_p < HW)[:, None] & cmask[None, :]
                v = tl.load(x_ptr + base + offs_p[:, None] * C + ch[None, :],
                            mask=m, other=0.0).to(tl.float32)
                acc_s += tl.sum(v, axis=0)
                acc_q += tl.sum(v * v, axis=0)
            if HAS_BIAS:
                bias = tl.load(bias_ptr + n * SP + ch, mask=cmask, other=0.0)
            else:
                bias = tl.zeros([BLOCK_C], dtype=tl.float32)
            usum = acc_s + HW * bias
            usq = acc_q + 2.0 * bias * acc_s + HW * bias * bias
            cnt = (HW * CG).to(tl.float32)
            mean = tl.sum(usum, axis=0) / cnt
            var = tl.sum(usq, axis=0) / cnt - mean * mean
            inv = 1.0 / tl.sqrt(var + eps)
            tl.store(mean_ptr + pid, mean)
            tl.store(inv_ptr + pid, inv)
            gamma = tl.load(g_ptr + n * SG + ch, mask=cmask, other=0.0)
            beta = tl.load(b_ptr + n * SB + ch, mask=cmask, other=0.0)
            a = inv * gamma
            d = beta + (bias - mean) * inv * gamma
            for start in range(0, HW, BLOCK_HW):
                offs_p = start + tl.arange(0, BLOCK_HW)
                m = (offs_p < HW)[:, None] & cmask[None, :]
                off = base + offs_p[:, None] * C + ch[None, :]
                v = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
                y = v * a[None, :] + d[None, :]
                y = y / (1.0 + tl.exp(-y))
                tl.store(y_ptr + off, y.to(y_ptr.dtype.element_ty), mask=m)

        @triton.jit
        def gn_silu_bwd(x_ptr, dz_ptr, g_ptr, b_ptr, bias_ptr, mean_ptr, inv_ptr,
                        dx_ptr, dg_ptr, db_ptr, dbias_ptr, HW, C, G, CG, SG, SB, SP,
                        HAS_BIAS: tl.constexpr, BLOCK_HW: tl.constexpr,
                        BLOCK_C: tl.constexpr):
            pid = tl.program_id(0)
            n = pid // G
            g = pid % G
            offs_c = tl.arange(0, BLOCK_C)
            cmask = offs_c < CG
            ch = g * CG + offs_c
            base = n.to(tl.int64) * HW * C
            mean = tl.load(mean_ptr + pid)
            inv = tl.load(inv_ptr + pid)
            gamma = tl.load(g_ptr + n * SG + ch, mask=cmask, other=0.0)
            beta = tl.load(b_ptr + n * SB + ch, mask=cmask, other=0.0)
            if HAS_BIAS:
                bias = tl.load(bias_ptr + n * SP + ch, mask=cmask, other=0.0)
            else:
                bias = tl.zeros([BLOCK_C], dtype=tl.float32)
            shift = bias - mean
            # pass 1: per-channel Σdy (dβ) and Σdy·x̂ (dγ); masked lanes load dz = 0
            acc_dy = tl.zeros([BLOCK_C], dtype=tl.float32)
            acc_dyx = tl.zeros([BLOCK_C], dtype=tl.float32)
            for start in range(0, HW, BLOCK_HW):
                offs_p = start + tl.arange(0, BLOCK_HW)
                m = (offs_p < HW)[:, None] & cmask[None, :]
                off = base + offs_p[:, None] * C + ch[None, :]
                v = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
                dz = tl.load(dz_ptr + off, mask=m, other=0.0).to(tl.float32)
                xh = (v + shift[None, :]) * inv
                y = xh * gamma[None, :] + beta[None, :]
                s = 1.0 / (1.0 + tl.exp(-y))
                dy = dz * (s * (1.0 + y * (1.0 - s)))
                acc_dy += tl.sum(dy, axis=0)
                acc_dyx += tl.sum(dy * xh, axis=0)
            row = n.to(tl.int64) * C + ch
            tl.store(db_ptr + row, acc_dy, mask=cmask)
            tl.store(dg_ptr + row, acc_dyx, mask=cmask)
            # group means of dx̂ = dy·γ and of dx̂·x̂ (γ is 0 on masked channels)
            cnt = (HW * CG).to(tl.float32)
            m1 = tl.sum(acc_dy * gamma, axis=0) / cnt
            m2 = tl.sum(acc_dyx * gamma, axis=0) / cnt
            # pass 2: dx, and its per-channel sum (dbias)
            acc_du = tl.zeros([BLOCK_C], dtype=tl.float32)
            for start in range(0, HW, BLOCK_HW):
                offs_p = start + tl.arange(0, BLOCK_HW)
                m = (offs_p < HW)[:, None] & cmask[None, :]
                off = base + offs_p[:, None] * C + ch[None, :]
                v = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
                dz = tl.load(dz_ptr + off, mask=m, other=0.0).to(tl.float32)
                xh = (v + shift[None, :]) * inv
                y = xh * gamma[None, :] + beta[None, :]
                s = 1.0 / (1.0 + tl.exp(-y))
                dy = dz * (s * (1.0 + y * (1.0 - s)))
                du = inv * (dy * gamma[None, :] - m1 - xh * m2)
                du = tl.where(m, du, 0.0)
                tl.store(dx_ptr + off, du.to(dx_ptr.dtype.element_ty), mask=m)
                acc_du += tl.sum(du, axis=0)
            tl.store(dbias_ptr + row, acc_du, mask=cmask)

        _KERNELS = (triton, gn_silu_fwd, gn_silu_bwd)
    return _KERNELS


def _check(x, num_groups: int, what: str) -> None:
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by {num_groups} groups")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what} kernel takes bf16 activations, got {x.dtype}")


def _blocks(triton, hw: int, cg: int, tile: int) -> Tuple[int, int]:
    """(BLOCK_HW, BLOCK_C): a group's channels by up to ``tile`` elements."""
    block_c = triton.next_power_of_2(cg)
    return max(16, min(triton.next_power_of_2(hw), tile // block_c)), block_c


def _launch(x, gamma, beta, bias, num_groups: int, eps: float):
    global launches
    n, h, w, c = x.shape
    _check(x, num_groups, "group_norm_silu")
    x = x.contiguous()
    (gamma, sg), (beta, sb) = broadcast_rows(gamma, n, c), broadcast_rows(beta, n, c)
    has_bias = bias is not None
    bias, sp = broadcast_rows(bias, n, c) if has_bias else (x, 0)  # x: an unread stand-in
    triton, kernel, _ = _triton_kernel()
    block_hw, block_c = _blocks(triton, h * w, c // num_groups, 4096)
    y = torch.empty_like(x)
    mean = torch.empty((n, num_groups), device=x.device, dtype=torch.float32)
    inv = torch.empty_like(mean)
    kernel[(n * num_groups,)](
        x, gamma, beta, bias, y, mean, inv, h * w, c, num_groups, c // num_groups,
        sg, sb, sp, eps,
        HAS_BIAS=has_bias, BLOCK_HW=block_hw, BLOCK_C=block_c, num_warps=4,
    )
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
    x, dz = x.contiguous(), dz.contiguous()
    mean, inv = mean.to(torch.float32).contiguous(), inv.to(torch.float32).contiguous()
    (gamma, sg), (beta, sb) = broadcast_rows(gamma, n, c), broadcast_rows(beta, n, c)
    has_bias = bias is not None
    bias, sp = broadcast_rows(bias, n, c) if has_bias else (mean, 0)  # mean: an unread stand-in
    triton, _, kernel = _triton_kernel()
    # half K1's tile: each element holds twice the live f32 values
    block_hw, block_c = _blocks(triton, h * w, c // num_groups, 2048)
    dx = torch.empty_like(x)
    dgamma, dbeta, dbias = (torch.empty((n, c), device=x.device, dtype=torch.float32)
                            for _ in range(3))
    kernel[(n * num_groups,)](
        x, dz, gamma, beta, bias, mean, inv, dx, dgamma, dbeta, dbias,
        h * w, c, num_groups, c // num_groups, sg, sb, sp,
        HAS_BIAS=has_bias, BLOCK_HW=block_hw, BLOCK_C=block_c, num_warps=4,
    )
    bwd_launches += 1
    return dx, dgamma, dbeta, dbias


def _on_cpu(x: torch.Tensor, what: str) -> bool:
    """True for a CPU tensor (plain version); False for CUDA; raise otherwise."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    return False


def group_norm_silu_fwd(x, gamma, beta, num_groups: int, eps: float = GN_EPS,
                        pre_bias: Optional[torch.Tensor] = None):
    """(y, mean, inv): y = silu(GN(x + pre_bias)·γ + β) and the (N, G) f32
    statistics. CPU tensors take :func:`gn_silu_plain`; CUDA tensors K1."""
    if _on_cpu(x, "group_norm_silu"):
        return gn_silu_plain(x, gamma, beta, pre_bias, num_groups, eps)
    return _launch(x, gamma, beta, pre_bias, num_groups, eps)


def group_norm_silu_bwd(x, dz, gamma, beta, pre_bias, mean, inv, num_groups: int):
    """(dx, dγ, dβ, dbias) of :func:`group_norm_silu_fwd` from its saved
    statistics; the three vectors (N, C) f32. CPU tensors take
    :func:`gn_silu_bwd_plain`; CUDA tensors K2."""
    if _on_cpu(x, "group_norm_silu backward"):
        return gn_silu_bwd_plain(x, dz, gamma, beta, pre_bias, mean, inv, num_groups)
    return _launch_bwd(x, dz, gamma, beta, pre_bias, mean, inv, num_groups)


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
