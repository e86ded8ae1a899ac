"""Diffusion algorithms and samplers (mirrors ``dmme_tpu.diffusion``)."""

from dmme_tpu_torch.diffusion.cfg import classifier_free
from dmme_tpu_torch.diffusion.ddim import DDIM
from dmme_tpu_torch.diffusion.ddpm import DDPM
from dmme_tpu_torch.diffusion.deep_cache import DeepCachedDDIM, DeepCachedDPM
from dmme_tpu_torch.diffusion.distill import ProgressiveDistillation
from dmme_tpu_torch.diffusion.dpm_solver import DPMSolverPP
from dmme_tpu_torch.diffusion.edm import EDM
from dmme_tpu_torch.diffusion.factory import make_sampler
from dmme_tpu_torch.diffusion.fast import CachedDDIM
from dmme_tpu_torch.diffusion.flow import FlowMatching
from dmme_tpu_torch.diffusion.guidance import (ClassifierGuidedDDIM, ClassifierGuidedDDPM,
                                               classifier_grad)
from dmme_tpu_torch.diffusion.iddpm import IDDPM, NoiseVariance
from dmme_tpu_torch.diffusion.inpaint import inpaint
from dmme_tpu_torch.diffusion.unipc import UniPC

__all__ = ["DDPM", "DDIM", "IDDPM", "NoiseVariance", "DPMSolverPP", "UniPC", "EDM",
           "FlowMatching", "CachedDDIM", "DeepCachedDDIM", "DeepCachedDPM", "make_sampler",
           "classifier_free", "ClassifierGuidedDDPM", "ClassifierGuidedDDIM", "classifier_grad",
           "ProgressiveDistillation", "inpaint"]
