"""UNet denoisers as ``nn.Module``s (mirrors ``dmme_tpu.models``)."""

from dmme_tpu_torch.models import ddpm
from dmme_tpu_torch.models.blocks import init_weights
from dmme_tpu_torch.models.unet import UNet, build_topology

__all__ = ["ddpm", "UNet", "build_topology", "init_weights"]
