"""Hand-written Hopper kernels for the UNet's hot operations.

Each wrapper module holds the kernel's launcher, a ``launches`` counter that
the launcher alone increments, and a plain PyTorch version of the same
function. A wrapper takes the plain version only for a tensor on the CPU; for
a CUDA tensor it launches the kernel or raises.

* :mod:`.group_norm` — GroupNorm(+pre-bias, +per-sample affine)+SiLU forward and
  backward, CUDA C++ (sm_90a)
* :mod:`.attention`  — single-pass softmax attention forward, CUDA C++ (sm_90a)
* :mod:`.resblock`   — the fused ResBlock forward, CUDA C++ (sm_90a)

The CUDA sources live in ``csrc/`` and are built by :mod:`.build`.
"""
