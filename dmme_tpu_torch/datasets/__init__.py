"""Raw datasets (mirrors ``dmme_tpu.datasets``): LSUN's LMDB categories."""

from dmme_tpu_torch.datasets.lsun import LSUN, LSUNClass

__all__ = ["LSUN", "LSUNClass"]
