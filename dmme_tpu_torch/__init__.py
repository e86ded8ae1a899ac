"""dmme_tpu_torch: the PyTorch/CUDA port of ``dmme_tpu`` for NVIDIA Hopper.

The JAX package ``dmme_tpu`` is the reference; every module here mirrors the
file of the same name there and is held against it by the ``test_torch_port_*``
tests. Activations keep the JAX package's NHWC layout at every public function.

* ``dmme_tpu_torch.equations`` — schedule and reverse-process math on tensors
* ``dmme_tpu_torch.ops``       — hand-written Hopper kernels (CUDA C++) with a
  plain PyTorch version of each, taken for CPU tensors and, counted, for
  CUDA tensors outside the kernels' dtype (bf16)
* ``dmme_tpu_torch.models``    — the DDPM and IDDPM UNets, the ADM family
  (generator, noisy classifier), the DiT with its mixture-of-experts FFN and
  the KL-VAE codec of latent diffusion as ``nn.Module``s
* ``dmme_tpu_torch.diffusion`` — DDPM / DDIM / IDDPM / EDM / flow training
  losses, the samplers, classifier-free and classifier guidance, RePaint
  inpainting and progressive distillation
* ``dmme_tpu_torch.data``      — CIFAR-10 (on-disk or synthetic), ImageNet-64
  (``ImageFolder64``), LSUN over a dependency-free LMDB reader (``LSUN``,
  ``LMDBReader``; ``dmme_tpu_torch.native`` builds its C++ scanner) and the
  procedural ``Shapes``, flips on the device
* ``dmme_tpu_torch.datasets``  — LSUN's raw LMDB categories (``LSUNClass``, ``LSUN``)
* ``dmme_tpu_torch.training``  — the harnesses (``LitDDPM`` … ``LitDistill``, ``LitClassifier``,
  latent diffusion's ``LitVAE``, ``LitLatentDDPM`` and ``LitLatentFlow``),
  ``TrainState``, the optimizer chain, EMA, ``fit`` with checkpoints
  (``checkpoint``), resume, restarts and loggers (``loggers``), and
  ``evaluate.validate``/``evaluate.test``
* ``dmme_tpu_torch.eval``      — FID and the Inception Score: streaming
  statistics, ``InceptionV3`` (FID-standard and torchvision topologies) and
  its weight loaders
* ``dmme_tpu_torch.callbacks`` — ``GenerateImage`` and ``ProfileTrace`` (a
  ``torch.profiler`` trace of a window of steps; ``utils.profiling``)
* ``dmme_tpu_torch.parallel``  — the train step (one device)
* ``dmme_tpu_torch.serving``   — the HTTP sampling server
* ``dmme_tpu_torch.config``    — the YAML ``class_path`` trees of ``configs/``
* ``dmme_tpu_torch.trainer``   — the command line:
  ``python -m dmme_tpu_torch.trainer {fit,validate,test,sample,predict,serve} --config x.yaml``
* ``dmme_tpu_torch.distill``   — progressive distillation round by round:
  ``python -m dmme_tpu_torch.distill --config x.yaml --rounds N``
* ``dmme_tpu_torch.fid``       — the FID tool:
  ``python -m dmme_tpu_torch.fid PATH1 PATH2 [--weights w.pth]``

Entry points run on the CUDA device unless the caller passes ``device="cpu"``.
The package root re-exports ``dmme_tpu/__init__.py``'s names.
"""

__version__ = "0.1.0"

from dmme_tpu_torch.utils import (denorm, gaussian, gaussian_like, make_history, norm, pad,
                                  uniform_int)
from dmme_tpu_torch import equations, models, diffusion
from dmme_tpu_torch import diffusion as diffusion_models  # the JAX package's alias
from dmme_tpu_torch.training import LitClassifier, LitDDIM, LitDDPM, LitEDM, LitIDDPM
from dmme_tpu_torch.data import CIFAR10, ImageFolder64, LSUN
from dmme_tpu_torch import callbacks, datasets

__all__ = ["gaussian", "gaussian_like", "uniform_int", "pad", "norm", "denorm", "make_history",
           "equations", "models", "diffusion", "diffusion_models", "callbacks", "LitDDPM",
           "LitDDIM", "LitEDM", "LitIDDPM", "LitClassifier", "CIFAR10", "ImageFolder64", "LSUN",
           "datasets", "__version__"]
