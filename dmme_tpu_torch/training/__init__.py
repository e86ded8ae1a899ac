"""The sampling surface of the Lightning-style harnesses (mirrors ``dmme_tpu.training``)."""

from dmme_tpu_torch.training.lit import LitDDIM, LitDDPM, ParamsState

__all__ = ["LitDDPM", "LitDDIM", "ParamsState"]
