"""Hand-written Hopper kernels for the UNet's hot operations.

Each wrapper module holds the kernel's launcher, launch counters that the
launcher alone increments, and a plain PyTorch version of the same
function. Where a call goes is :func:`route`'s decision, made from the
kernel, the tensor's device and its dtype alone, before any build or
launch: a CPU tensor takes the plain version; a CUDA tensor launches a
kernel or raises. K3 and K4 take bf16, fp16 and f32 activations on the
tensor cores (``attention.cu``, ``resblock.cu``: fp16 as bf16 is taken, f32
as 3xTF32); K1 and K2 take the three on ``group_norm.cu``'s bulk-copy
cluster kernels, and send a width outside their domain (C % 8 != 0 or
C > 2048) to ``simt.cu`` in any of them, as the TPU kernels compute any
dtype and width.

* :mod:`.group_norm` — GroupNorm(+pre-bias, +per-sample affine)+SiLU forward and
  backward, CUDA C++ (sm_90a)
* :mod:`.attention`  — single-pass softmax attention forward, CUDA C++ (sm_90a)
* :mod:`.resblock`   — the fused ResBlock forward, CUDA C++ (sm_90a)

The CUDA sources live in ``csrc/`` and are built by :mod:`.build`.
"""

import torch

#: where a CUDA tensor goes, by kernel and activation dtype: "kernel" (the
#: kernels of group_norm.cu, attention.cu and resblock.cu; group_norm.py
#: sends a width outside group_norm.cu's domain to simt.cu)
ROUTES = {
    "group_norm_silu": {torch.bfloat16: "kernel", torch.float32: "kernel",
                        torch.float16: "kernel"},
    "attention": {torch.bfloat16: "kernel", torch.float16: "kernel", torch.float32: "kernel"},
    "resblock": {torch.bfloat16: "kernel", torch.float16: "kernel", torch.float32: "kernel"},
}
#: bytes of shared memory a block may use on an H100
SMEM_MAX = 232448
#: the activation dtypes of ``csrc/simt.cu`` and ``csrc/group_norm.cu``, by
#: the code their entry points take
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def route(device: torch.device, dtype: torch.dtype, kernel: str) -> str:
    """Where ``kernel`` (a key of :data:`ROUTES`) sends a call on tensors of
    ``device`` and ``dtype``: ``"cpu"`` (the plain version) or ``"kernel"``
    (CUDA: the hand-written kernel). Raises for any other device, and for a
    dtype the kernel lacks on CUDA."""
    if device.type == "cpu":
        return "cpu"
    if device.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {device}")
    try:
        return ROUTES[kernel][dtype]
    except KeyError:
        raise TypeError(f"{kernel}: no kernel for {dtype} activations "
                        f"({', '.join(str(d)[6:] for d in ROUTES[kernel])})") from None


def simt_code(x: torch.Tensor, what: str) -> int:
    """The ``simt.cu`` dtype code of ``x``; raises for a dtype it lacks."""
    try:
        return DTYPE_CODES[x.dtype]
    except KeyError:
        raise TypeError(f"{what} simt kernel takes f32, fp16 or bf16, got {x.dtype}") from None


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to tf32 (10 mantissa bits), to nearest with ties
    away from zero: the low 13 bits of the f32 pattern cleared after adding
    half of them, bit for bit what ``cvt.rna.tf32.f32`` gives."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo): hi = tf32(x), lo = tf32(x − hi), so that x = hi + lo to
    about 2^-22 relative. The kernels' 3xTF32 products are hi·hi + hi·lo +
    lo·hi with f32 accumulation (``hopper.cuh:tf32_split``)."""
    x = x.float()
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)

