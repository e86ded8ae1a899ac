"""Fused ResBlock forward: a CUDA C++ kernel sequence for Hopper (``csrc/resblock.cu``).

Replaces the TPU kernel ``dmme_tpu/ops/resblock.py:_resblock_kernel``
(reached through ``resblock_forward``), the inference-only ResBlock

    h = silu(GN1(x));  h = conv3x3(h) + b1
    h = silu(GN2(h + pre2)·g2 + b2v);  h = conv3x3(h) + b2
    out = h + (x | x·Wr + br)

The TPU kernel keeps a whole batch block in VMEM; a 32×32×128 bf16 sample
alone exceeds an SM's shared memory, so here the block is four launches:
GN1 statistics, conv1 as an implicit GEMM whose tile loader applies
GN1+SiLU (h0 never reaches device memory; taps outside the image read 0),
GN2 statistics of h1 + pre2 (a separate pass, not atomics, so runs agree bit
for bit), and conv2 with GN2+SiLU in the loader and bias + skip (identity,
or the 1×1 projection continuing the same accumulation) in the epilogue.

Bound on the card: operations (a ResBlock does hundreds of operations per
byte it must move). This first version is a plain wmma-tiled kernel,
without pipelining, far from that bound. Where a conv's 64×64 output tiles
are fewer than the card's SMs (the 4×4 and 8×8 blocks), its K steps are
split over more blocks whose f32 partial tiles one more launch sums in a
fixed order. Launches per call: 4, plus 1 for each conv that is split
(``launches`` counts calls). The wrapper lays the conv weights out in bf16,
tap-major, once per weight state (:func:`pack_weights`), and hands affines
shared by the batch over with a row stride of 0, so a call on the card
issues the kernels' launches and no copies.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from dmme_tpu_torch.ops import build
from dmme_tpu_torch.ops.group_norm import GN_EPS, broadcast_rows, gn_silu_plain

#: ResBlock calls that launched the kernels since the last reset
launches = 0

_FN = None

BM, BN, BK = 64, 64, 32  # the conv kernel's tile (csrc/resblock.cu)


def _conv3x3_plain(h: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """NHWC ``h`` in the compute dtype, OIHW ``w``: 9 shifted matmuls with
    operands in h's dtype and f32 accumulation, + bias. Returns f32."""
    n, hh, ww, _ = h.shape
    pad = F.pad(h.float(), (0, 0, 1, 1, 1, 1))
    wk = w.to(h.dtype).float()
    acc = torch.zeros((n, hh, ww, w.shape[0]), device=h.device, dtype=torch.float32)
    for k in range(9):
        dy, dx = divmod(k, 3)
        tap = pad[:, dy : dy + hh, dx : dx + ww, :]
        acc = acc + torch.einsum("nhwc,dc->nhwd", tap, wk[:, :, dy, dx])
    return acc + bias.float()


def resblock_plain(x, g1, b1v, pre2, g2, b2v, w1, b1, w2, b2, wr, br,
                   num_groups: int, eps: float) -> torch.Tensor:
    """Plain PyTorch version: the math of ``dmme_tpu``'s ``_resblock_xla``."""
    dtype = x.dtype
    xf = x.float()
    h0 = gn_silu_plain(xf, g1, b1v, None, num_groups, eps)[0]
    h1 = _conv3x3_plain(h0.to(dtype), w1, b1)
    h2 = gn_silu_plain(h1, g2, b2v, pre2, num_groups, eps)[0]
    h3 = _conv3x3_plain(h2.to(dtype), w2, b2)
    if wr is not None:
        wm = wr.reshape(wr.shape[0], wr.shape[1]).to(dtype).float()
        skip = torch.einsum("nhwc,dc->nhwd", xf, wm) + br.float()
    else:
        skip = xf
    return (h3 + skip).to(dtype)


def _fn():
    global _FN
    if _FN is None:
        fn = build.library("resblock").dmme_resblock_fwd
        vp = ctypes.c_void_p
        fn.argtypes = [vp] * 16 + [ctypes.c_int] * 13 + [ctypes.c_float, vp]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


class PackedWeights(NamedTuple):
    """A ResBlock's weights in the kernel's layout."""

    w1: torch.Tensor            # (9·C_in, C_out) bf16, rows ordered (dy, dx, c_in)
    w2: torch.Tensor            # (9·C_out, C_out) bf16
    wr: Optional[torch.Tensor]  # (C_in, C_out) bf16, or None for the identity skip
    b1: torch.Tensor            # (C_out,) f32
    b2: torch.Tensor            # (C_out,) f32, plus br when wr is given


#: packed weights by the identity and in-place version of their sources
_PACKED: "OrderedDict[tuple, tuple]" = OrderedDict()
_PACKED_MAX = 64  # entries: 22 ResBlocks per UNet, so the weights of about 3 states


def _version(t: torch.Tensor) -> int:
    return 0 if t.is_inference() else t._version


def pack_weights(w1, b1, w2, b2, wr=None, br=None) -> PackedWeights:
    """The kernel's layout of a ResBlock's weights (OIHW f32 in), made once
    per weight state. Entries are keyed on the identity and in-place version
    of the source tensors and hold those tensors, so no key is reused while
    its entry lives; an in-place update of a source makes a new entry."""
    src = (w1, b1, w2, b2, wr, br)
    key = tuple(None if t is None else (id(t), _version(t)) for t in src)
    hit = _PACKED.get(key)
    if hit is not None:
        _PACKED.move_to_end(key)
        return hit[1]
    cout = w1.shape[0]

    def taps(wt):  # OIHW -> (9·C_in, C_out), rows ordered (dy, dx, c_in)
        return wt.permute(2, 3, 1, 0).reshape(9 * wt.shape[1], cout).to(torch.bfloat16).contiguous()

    b2f = b2.to(torch.float32)
    wr_m = None
    if wr is not None:
        wr_m = wr.reshape(cout, -1).t().to(torch.bfloat16).contiguous()
        b2f = b2f + br.to(torch.float32)
    packed = PackedWeights(taps(w1), taps(w2), wr_m, b1.to(torch.float32).contiguous(),
                           b2f.contiguous())
    _PACKED[key] = (src, packed)
    if len(_PACKED) > _PACKED_MAX:
        _PACKED.popitem(last=False)
    return packed


def _splits(m: int, cout: int, k_steps: int, sms: int) -> int:
    """K slices for one conv: enough blocks for two per SM where the output
    tiles alone are fewer than the SMs, at least 4 K steps per slice."""
    blocks = -(-m // BM) * (cout // BN)
    if blocks >= sms:
        return 1
    return max(1, min(-(-2 * sms // blocks), k_steps // 4))


def _launch(x, g1, b1v, pre2, g2, b2v, w1, b1, w2, b2, wr, br,
            num_groups: int, eps: float) -> torch.Tensor:
    global launches
    n, h, w, cin = x.shape
    cout = w1.shape[0]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"resblock kernel takes bf16 activations, got {x.dtype}")
    for c in (cin, cout):
        if c % num_groups or 256 % (c // num_groups):
            raise ValueError(f"resblock kernel: {c} channels in {num_groups} groups not supported")
    if cin % 32 or cout % 64:
        raise ValueError(f"resblock kernel takes C_in % 32 == 0 and C_out % 64 == 0, got {cin}, {cout}")
    if wr is None and cin != cout:
        raise ValueError("identity skip needs C_in == C_out")
    dev = x.device
    x = x.contiguous()
    pw = pack_weights(w1, b1, w2, b2, wr, br)
    vecs = [broadcast_rows(v, n, c)
            for v, c in ((g1, cin), (b1v, cin), (pre2, cout), (g2, cout), (b2v, cout))]
    f32 = dict(device=dev, dtype=torch.float32)
    h1 = torch.empty((n * h * w * cout,), **f32)
    coef = torch.empty((2 * n * (cin + cout),), **f32)
    stats = torch.empty((4 * n * num_groups,), **f32)
    out = torch.empty((n, h, w, cout), device=dev, dtype=torch.bfloat16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    m = n * h * w
    s1 = _splits(m, cout, 9 * cin // BK, sms)
    s2 = _splits(m, cout, (9 * cout + (cin if wr is not None else 0)) // BK, sms)
    partial = torch.empty((max(s1, s2) * m * cout if max(s1, s2) > 1 else 1,), **f32)
    status = _fn()(
        x.data_ptr(), *(v.data_ptr() for v, _ in vecs),
        pw.w1.data_ptr(), pw.b1.data_ptr(), pw.w2.data_ptr(), pw.b2.data_ptr(),
        None if pw.wr is None else pw.wr.data_ptr(),
        h1.data_ptr(), coef.data_ptr(), stats.data_ptr(), partial.data_ptr(), out.data_ptr(),
        n, h, w, cin, cout, num_groups, s1, s2, *(stride for _, stride in vecs), float(eps),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(status, "resblock kernel launch")
    launches += 1
    return out


def resblock_forward(
    x: torch.Tensor,
    g1, b1v,            # GN1 affine, (N, Cin) f32
    pre2, g2, b2v,      # GN2 pre-bias + affine, (N, Cout) f32
    w1, b1,             # conv1 (Cout, Cin, 3, 3) OIHW + (Cout,)
    w2, b2,             # conv2 (Cout, Cout, 3, 3) + (Cout,)
    wr: Optional[torch.Tensor] = None,   # (Cout, Cin, 1, 1) or None
    br: Optional[torch.Tensor] = None,
    num_groups: int = 32,
    eps: float = GN_EPS,
) -> torch.Tensor:
    """Fused ResBlock forward (see module docstring), NHWC. Inference only:
    it has no backward, so it raises under grad mode when any input requires
    grad, on every device. CPU tensors take :func:`resblock_plain`; CUDA
    tensors the kernels."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, g1, b1v, pre2, g2, b2v, w1, b1, w2, b2, wr, br)):
        raise RuntimeError(
            "resblock_forward is inference-only and has no backward, but an input "
            "requires grad: call it under torch.no_grad(), or train through the "
            "standard ResBlock path (train=True)")
    if x.device.type == "cpu":
        return resblock_plain(x, g1, b1v, pre2, g2, b2v, w1, b1, w2, b2, wr, br,
                              num_groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"resblock_forward: no kernel for device {x.device}")
    return _launch(x, g1, b1v, pre2, g2, b2v, w1, b1, w2, b2, wr, br, num_groups, eps)
