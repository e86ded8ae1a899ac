"""Hand-written Hopper kernels for the UNet's hot operations.

Each wrapper module holds the kernel's launcher, a ``launches`` counter that
the launcher alone increments, and a plain PyTorch version of the same
function. Where a call goes is :func:`route`'s decision, made from the
tensor's device and dtype alone, before any build or launch: a CPU tensor
takes the plain version; a CUDA tensor launches a kernel or raises. bf16
activations take the tensor-core kernels of ``group_norm.cu``,
``attention.cu`` and ``resblock.cu``; f32 and fp16 activations take the same
functions in ``simt.cu`` (CUDA cores, every sum in f32), as the TPU kernels
compute in any dtype, counted in each wrapper's ``simt_launches``.

* :mod:`.group_norm` — GroupNorm(+pre-bias, +per-sample affine)+SiLU forward and
  backward, CUDA C++ (sm_90a)
* :mod:`.attention`  — single-pass softmax attention forward, CUDA C++ (sm_90a)
* :mod:`.resblock`   — the fused ResBlock forward, CUDA C++ (sm_90a)

The CUDA sources live in ``csrc/`` and are built by :mod:`.build`.
"""

import torch

#: the activation dtypes of the tensor-core kernels
KERNEL_DTYPES = (torch.bfloat16,)
#: the activation dtypes of ``csrc/simt.cu``, by the code its entry points take
SIMT_DTYPES = {torch.float32: 0, torch.float16: 1}


def route(device: torch.device, dtype: torch.dtype, what: str) -> str:
    """Where a wrapper sends a call on tensors of ``device`` and ``dtype``:
    ``"cpu"`` (the plain version), ``"kernel"`` (CUDA, bf16: the tensor-core
    kernel) or ``"simt"`` (CUDA, f32 or fp16: the kernel of ``simt.cu``).
    Raises for any other device, and for another dtype on CUDA."""
    if device.type == "cpu":
        return "cpu"
    if device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {device}")
    if dtype in KERNEL_DTYPES:
        return "kernel"
    if dtype in SIMT_DTYPES:
        return "simt"
    raise TypeError(f"{what}: no kernel for {dtype} activations (bf16, f32 or fp16)")


def simt_code(x: torch.Tensor, what: str) -> int:
    """The ``simt.cu`` dtype code of ``x``; raises for a dtype it lacks."""
    try:
        return SIMT_DTYPES[x.dtype]
    except KeyError:
        raise TypeError(f"{what} simt kernel takes f32 or fp16, got {x.dtype}") from None
