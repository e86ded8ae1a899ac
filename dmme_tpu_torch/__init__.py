"""dmme_tpu_torch: the PyTorch/CUDA port of ``dmme_tpu`` for NVIDIA Hopper.

The JAX package ``dmme_tpu`` is the reference; every module here mirrors the
file of the same name there and is held against it by the ``test_torch_port_*``
tests. Activations keep the JAX package's NHWC layout at every public function.

* ``dmme_tpu_torch.equations`` — schedule and reverse-process math on tensors
* ``dmme_tpu_torch.ops``       — hand-written Hopper kernels (CUDA C++) with a
  plain PyTorch version of each, taken for CPU tensors and, counted, for
  CUDA tensors outside the kernels' dtype (bf16)
* ``dmme_tpu_torch.models``    — the DDPM and IDDPM UNets, the ADM family
  (generator, noisy classifier) and the DiT with its mixture-of-experts FFN
  as ``nn.Module``s
* ``dmme_tpu_torch.diffusion`` — DDPM / DDIM / IDDPM / EDM / flow training
  losses, the samplers, classifier-free and classifier guidance, RePaint
  inpainting and progressive distillation
* ``dmme_tpu_torch.data``      — CIFAR-10 (on-disk or synthetic) and the
  procedural ``Shapes``, flips on the device
* ``dmme_tpu_torch.training``  — the harnesses (``LitDDPM`` … ``LitDistill``, ``LitClassifier``),
  ``TrainState``, the optimizer chain, EMA, ``fit`` with checkpoints
  (``checkpoint``), resume, restarts and loggers (``loggers``), and
  ``evaluate.validate``
* ``dmme_tpu_torch.callbacks`` — ``GenerateImage``
* ``dmme_tpu_torch.parallel``  — the train step (one device)
* ``dmme_tpu_torch.serving``   — the HTTP sampling server
* ``dmme_tpu_torch.config``    — the YAML ``class_path`` trees of ``configs/``
* ``dmme_tpu_torch.trainer``   — the command line:
  ``python -m dmme_tpu_torch.trainer {fit,validate,sample,predict,serve} --config x.yaml``
* ``dmme_tpu_torch.distill``   — progressive distillation round by round:
  ``python -m dmme_tpu_torch.distill --config x.yaml --rounds N``

Entry points run on the CUDA device unless the caller passes ``device="cpu"``.
The package root re-exports what the port has of ``dmme_tpu/__init__.py``'s
names; ``datasets``, ``LSUN`` and ``ImageFolder64`` wait for ROADMAP A.12.
"""

__version__ = "0.1.0"

from dmme_tpu_torch.utils import (denorm, gaussian, gaussian_like, make_history, norm, pad,
                                  uniform_int)
from dmme_tpu_torch import equations, models, diffusion
from dmme_tpu_torch import diffusion as diffusion_models  # the JAX package's alias
from dmme_tpu_torch.training import LitClassifier, LitDDIM, LitDDPM, LitEDM, LitIDDPM
from dmme_tpu_torch.data import CIFAR10
from dmme_tpu_torch import callbacks

__all__ = ["gaussian", "gaussian_like", "uniform_int", "pad", "norm", "denorm", "make_history",
           "equations", "models", "diffusion", "diffusion_models", "callbacks", "LitDDPM",
           "LitDDIM", "LitEDM", "LitIDDPM", "LitClassifier", "CIFAR10", "__version__"]
