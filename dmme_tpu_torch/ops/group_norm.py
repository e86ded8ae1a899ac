"""GroupNorm(+pre-bias, +per-sample affine)+SiLU forward: a Triton kernel.

Replaces the TPU kernel ``dmme_tpu/ops/group_norm.py:_fwd_kernel`` (reached
through ``_fwd_pallas`` and ``group_norm_silu``), which holds whole samples
in VMEM. It computes

    y = silu(GN(x + pre_bias)·γ + β)

over NHWC ``x`` with per-sample (N, C) γ, β and pre-bias, f32 statistics
taken as E[u²] − E[u]² with the pre-bias folded into the channel sums
analytically (Σ(x+b) = Σx + HW·b, Σ(x+b)² = Σx² + 2bΣx + HW·b²), and also
writes the (N, G) mean and inverse std that a backward pass reads.

Bound on the card: bytes. It does a few operations per element, far below
the H100's ~295 bf16 operations per byte, so the least time is one read of
x plus one write of y. Design: one program per (sample, group) reads its
group's channels twice (statistics, then normalise+SiLU); the second read
mostly hits L2, which holds a 32×32×512 bf16 sample many times over. The
sums are plain per-program reductions, with no float atomics, so repeated
runs agree bit for bit. A γ or β shared by the batch is read through a row
stride of 0, not copied per sample. Launches per call: 1.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

GN_EPS = 1e-5

#: kernel launches since the last reset (incremented only by the launcher)
launches = 0

_KERNEL = None


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


def _triton_kernel():
    global _KERNEL
    if _KERNEL is None:
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

        _KERNEL = (triton, gn_silu_fwd)
    return _KERNEL


def _launch(x, gamma, beta, bias, num_groups: int, eps: float):
    global launches
    n, h, w, c = x.shape
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by {num_groups} groups")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"group_norm_silu kernel takes bf16 activations, got {x.dtype}")
    x = x.contiguous()
    (gamma, sg), (beta, sb) = broadcast_rows(gamma, n, c), broadcast_rows(beta, n, c)
    has_bias = bias is not None
    bias, sp = broadcast_rows(bias, n, c) if has_bias else (x, 0)  # x: an unread stand-in
    triton, kernel = _triton_kernel()
    cg = c // num_groups
    block_c = triton.next_power_of_2(cg)
    block_hw = max(16, min(triton.next_power_of_2(h * w), 4096 // block_c))
    y = torch.empty_like(x)
    mean = torch.empty((n, num_groups), device=x.device, dtype=torch.float32)
    inv = torch.empty_like(mean)
    kernel[(n * num_groups,)](
        x, gamma, beta, bias, y, mean, inv, h * w, c, num_groups, cg, sg, sb, sp, eps,
        HAS_BIAS=has_bias, BLOCK_HW=block_hw, BLOCK_C=block_c, num_warps=4,
    )
    launches += 1
    return y, mean, inv


def group_norm_silu_fwd(x, gamma, beta, num_groups: int, eps: float = GN_EPS,
                        pre_bias: Optional[torch.Tensor] = None):
    """(y, mean, inv): y = silu(GN(x + pre_bias)·γ + β) and the (N, G) f32
    statistics. CPU tensors take :func:`gn_silu_plain`; CUDA tensors the
    Triton kernel."""
    if x.device.type == "cpu":
        return gn_silu_plain(x, gamma, beta, pre_bias, num_groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_silu: no kernel for device {x.device}")
    return _launch(x, gamma, beta, pre_bias, num_groups, eps)


def group_norm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    num_groups: int, eps: float = GN_EPS,
                    pre_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """silu(GN(x + pre_bias)·gamma + beta) with per-sample affine.

    ``x``: (N, H, W, C); ``gamma``/``beta``: (C,) or (N, C); ``pre_bias``:
    optional (N, C) channel bias added before normalisation (the DDPM
    ResBlock's additive conditioning). Output in x's dtype.
    """
    return group_norm_silu_fwd(x, gamma, beta, num_groups, eps, pre_bias)[0]
