"""dmme_tpu_torch: the PyTorch/CUDA port of ``dmme_tpu`` for NVIDIA Hopper.

The JAX package ``dmme_tpu`` is the reference; every module here mirrors the
file of the same name there and is held against it by the ``test_torch_port_*``
tests. Activations keep the JAX package's NHWC layout at every public function.

* ``dmme_tpu_torch.equations`` — schedule and reverse-process math on tensors
* ``dmme_tpu_torch.ops``       — hand-written Hopper kernels (CUDA C++)
  with a plain PyTorch version of each, taken only for CPU tensors
* ``dmme_tpu_torch.models``    — the DDPM UNet as ``nn.Module``s
* ``dmme_tpu_torch.diffusion`` — DDPM / DDIM training loss and sampling
* ``dmme_tpu_torch.data``      — CIFAR-10 (on-disk or synthetic), flips on the device
* ``dmme_tpu_torch.training``  — ``LitDDPM``/``LitDDIM``, ``TrainState``, the
  optimizer chain, EMA and ``fit``
* ``dmme_tpu_torch.parallel``  — the train step (one device)
* ``dmme_tpu_torch.serving``   — the HTTP sampling server

Entry points run on the CUDA device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
