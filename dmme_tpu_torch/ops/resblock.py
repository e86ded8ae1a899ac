"""Fused ResBlock forward: a CUDA C++ kernel sequence for Hopper (``csrc/resblock.cu``).

Replaces the TPU kernel ``dmme_tpu/ops/resblock.py:_resblock_kernel``
(reached through ``resblock_forward``), the inference-only ResBlock

    h = silu(GN1(x));  h = conv3x3(h) + b1
    h = silu(GN2(h + pre2)·g2 + b2v);  h = conv3x3(h) + b2
    out = h + (x | x·Wr + br)

The TPU kernel keeps a whole batch block in VMEM; a 32×32×128 bf16 sample
alone exceeds an SM's shared memory, so here the block is four launches:
GN1+SiLU (one pass per (sample, group) that holds the group on chip and
writes h0 once, in bf16), conv1 as an implicit GEMM over h0, GN2+SiLU of
h1 + pre2 (a separate pass, not atomics, so runs agree bit for bit), and
conv2 with bias + skip (identity, or the 1×1 projection continuing the same
accumulation) in the epilogue. The convs are warp-specialised: a producer
thread fills a ring of shared-memory stages by TMA (4-D boxes of the NHWC
operand shifted by the tap; the zero fill outside the image is the TPU
kernel's zero padding), one or two consumer warpgroups run ``wgmma`` with
f32 accumulators in registers.

Bound on the card: operations (a ResBlock does hundreds of operations per
byte it must move). Where a conv's output tiles are fewer than the card's
SMs, its K steps are split over more blocks whose f32 partial tiles are
summed in a fixed order (:func:`conv_plan`): conv1's by the GN2 pass as it
reads them, conv2's by one more launch. Launches per call: 4, plus 1 if
conv2 is split (``launches`` counts calls). The wrapper lays the conv
weights out in bf16, K-major, once per weight state (:func:`pack_weights`),
and hands affines shared by the batch over with a row stride of 0, so a
call on the card issues the kernels' launches and no copies.

f32 and fp16 activations take K4's version in ``csrc/simt.cu``
(:func:`_launch_simt`, ``simt_launches``): the same four steps, GN passes a
block per (group, sample) and convs as implicit GEMMs of 64×64 output tiles
on the CUDA cores, conv1's output kept in f32 for GN2 as in
:func:`resblock_plain`; four launches a call.

Shapes: C_in and C_out multiples of 8 (a partial last 64-channel K step
reads zeros past C from TMA; a partial output tile is masked at C_out) and
any H×W (an M tile is a TMA box of whole rows or whole images where the
shape allows, else a spatial box whose pixels outside the image read zeros
and are not stored; :func:`pixel_box`).
"""

from __future__ import annotations

import ctypes
import functools
from collections import OrderedDict
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from dmme_tpu_torch.ops import build, route, simt_code
from dmme_tpu_torch.ops.group_norm import GN_EPS, broadcast_rows, gn_silu_plain

#: ResBlock calls that launched the kernels since the last reset
launches = 0
#: f32/fp16 ResBlock calls that launched the kernels of ``csrc/simt.cu``
simt_launches = 0

_FN = None
_SIMT = None

BN, BK = 128, 64  # output channels a tile and K a step (csrc/resblock.cu)
MIN_STEPS = 4  # K steps a split slice takes at least
GN_THREADS = 256  # threads of the GN+SiLU pass; at most this many channels a group
CHANNELS = 8  # C_in and C_out are multiples of this: 16-byte TMA strides


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
        fn.argtypes = ([vp] * 10 + [ctypes.c_int] + [vp] * 4 + [ctypes.c_int] * 19
                       + [ctypes.c_float, vp])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


class PackedWeights(NamedTuple):
    """A ResBlock's weights in the kernel's layout: K-major rows, one per
    output channel, as TMA and ``wgmma`` read them."""

    w1: torch.Tensor            # (C_out, 9·C_in), K ordered (dy, dx, c_in)
    w2: torch.Tensor            # (C_out, 9·C_out [+ C_in]), wr's rows appended
    wr: Optional[torch.Tensor]  # (C_out, C_in) view of w2's last C_in columns, or None
    b1: torch.Tensor            # (C_out,) f32
    b2: torch.Tensor            # (C_out,) f32, plus br when wr is given


#: packed weights by the identity and in-place version of their sources
_PACKED: "OrderedDict[tuple, tuple]" = OrderedDict()
_PACKED_MAX = 64  # entries: 22 ResBlocks per UNet, so the weights of about 3 states


def _version(t: torch.Tensor) -> int:
    return 0 if t.is_inference() else t._version


def pack_weights(w1, b1, w2, b2, wr=None, br=None,
                 dtype: torch.dtype = torch.bfloat16) -> PackedWeights:
    """The kernels' layout of a ResBlock's weights (OIHW f32 in), the conv
    weights in ``dtype`` (the activations'), made once per weight state.
    Entries are keyed on the dtype and the identity and in-place version of
    the source tensors and hold those tensors, so no key is reused while its
    entry lives; an in-place update of a source makes a new entry."""
    src = (w1, b1, w2, b2, wr, br)
    key = (dtype,) + tuple(None if t is None else (id(t), _version(t)) for t in src)
    hit = _PACKED.get(key)
    if hit is not None:
        _PACKED.move_to_end(key)
        return hit[1]
    cout = w1.shape[0]

    def taps(wt):  # OIHW -> (C_out, 9·C_in), K ordered (dy, dx, c_in)
        return wt.permute(0, 2, 3, 1).reshape(cout, 9 * wt.shape[1]).to(dtype)

    b2f = b2.to(torch.float32)
    w2p, wr_m = taps(w2).contiguous(), None
    if wr is not None:
        cin = wr.shape[1]
        w2p = torch.cat([w2p, wr.reshape(cout, cin).to(dtype)], dim=1)
        wr_m = w2p[:, 9 * cout:]
        b2f = b2f + br.to(torch.float32)
    packed = PackedWeights(taps(w1).contiguous(), w2p, wr_m, b1.to(torch.float32).contiguous(),
                           b2f.contiguous())
    _PACKED[key] = (src, packed)
    if len(_PACKED) > _PACKED_MAX:
        _PACKED.popitem(last=False)
    return packed


def pixel_box(h: int, w: int, bm: int) -> Tuple[int, int, int]:
    """(images, rows, columns) of the NHWC pixels that one M tile of ``bm``
    output pixels covers: one TMA box. In raster order (segments of whole
    rows, whole rows or whole images) where H and W allow; else a spatial
    box of ``bm`` pixels, columns the power of two at or above W up to
    ``bm``, which may reach past the image."""
    if w >= bm and w % bm == 0:
        return 1, 1, bm
    if w < bm and bm % w == 0:
        rows = bm // w
        if h >= rows and h % rows == 0:
            return 1, rows, w
        if h < rows and rows % h == 0:
            return rows // h, h, w
    bw = min(bm, 1 << (w - 1).bit_length())
    return 1, bm // bw, bw


def tile_pixels(n: int, h: int, w: int, box: Tuple[int, int, int], tile: int) -> List[int]:
    """The raster indices of the pixels that M tile ``tile`` stores, in
    tile-row order (the kernel's epilogue): pixels outside the batch are
    skipped."""
    bn, bh, bw = box
    tx, ty = -(-w // bw), -(-h // bh)
    img0, y0, x0 = tile // (tx * ty) * bn, tile // tx % ty * bh, tile % tx * bw
    out = []
    for r in range(bn * bh * bw):
        img, y, x = img0 + r // (bh * bw), y0 + r // bw % bh, x0 + r % bw
        if img < n and y < h and x < w:
            out.append((img * h + y) * w + x)
    return out


class ConvPlan(NamedTuple):
    """Launch geometry of one conv of K4."""

    bm: int                   # output pixels a tile (64 per consumer warpgroup)
    box: Tuple[int, int, int]  # (images, rows, columns) of a tile: TMA box (64, w, h, n)
    m_tiles: int
    n_tiles: int              # tiles of BN output channels
    steps: int                # 64-deep K steps: 9 taps × ⌈C_in/64⌉ [+ ⌈C_proj/64⌉]
    splits: int               # split-K slices (blockIdx.z), summed in slice order
    per: int                  # K steps a slice; the last may take fewer

    def slices(self) -> List[range]:
        """The K steps of each split slice, in order."""
        return [range(z * self.per, min(self.steps, (z + 1) * self.per))
                for z in range(self.splits)]


@functools.lru_cache(maxsize=None)
def conv_plan(n: int, h: int, w: int, c_in: int, c_out: int, c_proj: int, sms: int) -> ConvPlan:
    """The conv kernel's tile, TMA box and split-K for an (N, H, W, C_in)
    operand, C_out outputs and a 1×1 projection over C_proj channels
    continuing the accumulation (0 for none), on a card with ``sms`` SMs,
    made once per shape. Tiles of 128 pixels where they alone make blocks
    for a quarter of the SMs (the 32×32 layers at batch 8; measured faster
    there, PERF.md), else 64; the rule reads only M and C_out, so both convs
    of a ResBlock take the same tile. Then the K steps split into
    ⌊SMs / tiles⌋ slices of at least ``MIN_STEPS`` steps, none empty."""
    if c_in % CHANNELS or c_proj % CHANNELS or c_out % CHANNELS:
        raise ValueError(f"resblock kernel takes C_in and C_out that are multiples of "
                         f"{CHANNELS}, got {c_in}, {c_out}")
    m, n_tiles = n * h * w, -(-c_out // BN)
    bm = 128 if 4 * -(-m // 128) * n_tiles >= sms else 64
    box = pixel_box(h, w, bm)
    steps = 9 * -(-c_in // BK) + -(-c_proj // BK)
    bn, bh, bw = box
    m_tiles = -(-n // bn) * -(-h // bh) * -(-w // bw)
    splits = max(1, min(sms // (m_tiles * n_tiles), steps // MIN_STEPS))
    per = -(-steps // splits)
    return ConvPlan(bm, box, m_tiles, n_tiles, steps, -(-steps // per), per)


def _launch(x, g1, b1v, pre2, g2, b2v, w1, b1, w2, b2, wr, br,
            num_groups: int, eps: float) -> torch.Tensor:
    global launches
    n, h, w, cin = x.shape
    cout = w1.shape[0]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"resblock kernel takes bf16 activations, got {x.dtype}")
    for c in (cin, cout):
        if c % num_groups or c // num_groups > GN_THREADS:
            raise ValueError(f"resblock kernel: {c} channels in {num_groups} groups not supported")
    if wr is None and cin != cout:
        raise ValueError("identity skip needs C_in == C_out")
    dev = x.device
    sms = build.sm_count(dev)
    p1 = conv_plan(n, h, w, cin, cout, 0, sms)
    p2 = conv_plan(n, h, w, cout, cout, cin if wr is not None else 0, sms)
    x = x.contiguous()
    pw = pack_weights(w1, b1, w2, b2, wr, br)
    vecs = [broadcast_rows(v, n, c)
            for v, c in ((g1, cin), (b1v, cin), (pre2, cout), (g2, cout), (b2v, cout))]
    m = n * h * w
    f32 = dict(device=dev, dtype=torch.float32)
    hbuf = torch.empty((m * max(cin, cout),), device=dev, dtype=torch.bfloat16)
    # conv1's f32 output where it is not split (split, GN2 reads the slices),
    # and the slices of whichever conv is split
    h1 = torch.empty((m * cout,), **f32) if p1.splits == 1 else None
    splits = max(p1.splits, p2.splits)
    partial = torch.empty((splits * m * cout,), **f32) if splits > 1 else None
    out = torch.empty((n, h, w, cout), device=dev, dtype=torch.bfloat16)
    status = _fn()(
        x.data_ptr(), *(v.data_ptr() for v, _ in vecs),
        pw.w1.data_ptr(), pw.b1.data_ptr(), pw.w2.data_ptr(), pw.b2.data_ptr(),
        int(pw.wr is not None), hbuf.data_ptr(), None if h1 is None else h1.data_ptr(),
        None if partial is None else partial.data_ptr(),
        out.data_ptr(), n, h, w, cin, cout, num_groups, p1.bm, *p1.box, p1.splits, p1.per,
        p2.splits, p2.per, *(stride for _, stride in vecs), float(eps),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(status, "resblock kernel launch")
    launches += 1
    return out


def _simt_fn():
    global _SIMT
    if _SIMT is None:
        fn = build.library("simt").dmme_simt_resblock
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([i] + [vp] * 10 + [i] + [vp] * 5 + [i] * 6 + [ctypes.c_float] + [i] * 5
                       + [vp])
        fn.restype = i
        _SIMT = fn
    return _SIMT


def _launch_simt(x, g1, b1v, pre2, g2, b2v, w1, b1, w2, b2, wr, br,
                 num_groups: int, eps: float) -> torch.Tensor:
    """K4 for f32 or fp16 ``x`` (``csrc/simt.cu``): GN1+SiLU, conv1, GN2+SiLU
    of conv1 + pre2, conv2 with bias and skip, four launches. The convs'
    weights are packed in x's dtype (:func:`pack_weights`); conv1's output
    stays f32 for GN2, as in :func:`resblock_plain`."""
    global simt_launches
    n, h, w, cin = x.shape
    cout = w1.shape[0]
    code = simt_code(x, "resblock")
    for c in (cin, cout):
        if c % num_groups:
            raise ValueError(f"resblock kernel: {c} channels in {num_groups} groups")
    if wr is None and cin != cout:
        raise ValueError("identity skip needs C_in == C_out")
    dev = x.device
    x = x.contiguous()
    pw = pack_weights(w1, b1, w2, b2, wr, br, dtype=x.dtype)
    vecs = [broadcast_rows(v, n, c)
            for v, c in ((g1, cin), (b1v, cin), (pre2, cout), (g2, cout), (b2v, cout))]
    m = n * h * w
    h0 = torch.empty((m * cin,), device=dev, dtype=x.dtype)
    h1 = torch.empty((m * cout,), device=dev, dtype=torch.float32)
    h2 = torch.empty((m * cout,), device=dev, dtype=x.dtype)
    stats = torch.empty((2 * n * num_groups,), device=dev, dtype=torch.float32)
    out = torch.empty((n, h, w, cout), device=dev, dtype=x.dtype)
    status = _simt_fn()(
        code, x.data_ptr(), *(v.data_ptr() for v, _ in vecs), pw.w1.data_ptr(),
        pw.b1.data_ptr(), pw.w2.data_ptr(), pw.b2.data_ptr(), int(pw.wr is not None),
        h0.data_ptr(), h1.data_ptr(), h2.data_ptr(), stats.data_ptr(), out.data_ptr(), n, h, w,
        cin, cout, num_groups, float(eps), *(stride for _, stride in vecs),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "resblock simt kernel launch")
    simt_launches += 1
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
    grad, on every device. CPU tensors take :func:`resblock_plain`; bf16
    CUDA tensors the kernels, f32 and fp16 ones those of ``simt.cu``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, g1, b1v, pre2, g2, b2v, w1, b1, w2, b2, wr, br)):
        raise RuntimeError(
            "resblock_forward is inference-only and has no backward, but an input "
            "requires grad: call it under torch.no_grad(), or train through the "
            "standard ResBlock path (train=True)")
    where = route(x.device, x.dtype, "resblock_forward")
    if where == "kernel":
        return _launch(x, g1, b1v, pre2, g2, b2v, w1, b1, w2, b2, wr, br, num_groups, eps)
    if where == "simt":
        return _launch_simt(x, g1, b1v, pre2, g2, b2v, w1, b1, w2, b2, wr, br, num_groups, eps)
    return resblock_plain(x, g1, b1v, pre2, g2, b2v, w1, b1, w2, b2, wr, br, num_groups, eps)
