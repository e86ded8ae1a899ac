"""Inception Score, streaming over classifier logits (mirrors
``dmme_tpu/eval/inception_score.py``).

IS = exp(E_x KL(p(y|x) ‖ p(y))). The marginal p(y) needs every sample, so
the state streams Σ p(y|x), Σ p log p, Σ (Σ_y p log p)² and the count on the
logits' device, and ``compute`` closes the form on the host, as the
reference's ``kl_mean, kl_std = inception.compute(); exp(kl_mean)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class ISStats(NamedTuple):
    n: torch.Tensor            # ()
    prob_sum: torch.Tensor     # (K,)  Σ p(y|x)
    plogp_sum: torch.Tensor    # ()    Σ_x Σ_y p log p
    plogp_per: torch.Tensor    # ()    Σ_x (Σ_y p log p)², for the std

    @classmethod
    def create(cls, num_classes: int, device=None) -> "ISStats":
        return cls(n=torch.zeros((), device=device),
                   prob_sum=torch.zeros((num_classes,), device=device),
                   plogp_sum=torch.zeros((), device=device),
                   plogp_per=torch.zeros((), device=device))


class InceptionScore:
    """``num_classes=None`` sizes the state from the first logits: 1008 for
    the FID-standard Inception, 1000 for torchvision's."""

    def __init__(self, num_classes: Optional[int] = None):
        self.num_classes = num_classes
        self.stats = ISStats.create(num_classes) if num_classes else None

    @staticmethod
    def _update(stats: ISStats, logits: torch.Tensor) -> ISStats:
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        p = torch.exp(logp)
        per = torch.sum(p * logp, dim=-1)  # (N,) Σ_y p log p a sample
        return ISStats(n=stats.n + logits.shape[0], prob_sum=stats.prob_sum + p.sum(dim=0),
                       plogp_sum=stats.plogp_sum + per.sum(),
                       plogp_per=stats.plogp_per + torch.sum(torch.square(per)))

    def update(self, logits: torch.Tensor) -> None:
        if self.stats is None:
            self.num_classes = int(logits.shape[-1])
            self.stats = ISStats.create(self.num_classes, logits.device)
        elif self.stats.n.device != logits.device:
            self.stats = ISStats(*(t.to(logits.device) for t in self.stats))
        self.stats = self._update(self.stats, logits)

    def compute(self) -> Tuple[float, float]:
        """(kl_mean, kl_std); the score is exp(kl_mean).

        KL(p(y|x) ‖ p̄) = Σ_y p log p − Σ_y p log p̄: the first term streams
        exactly, the second takes the final marginal, so the mean is exact
        and the std is that of the entropy term alone."""
        if self.stats is None:
            raise RuntimeError(
                "InceptionScore.compute() before any update(): no logits "
                "were ever seen (empty test iterator? dataset smaller than "
                "batch_size drops the only batch)")
        n = float(self.stats.n)
        assert n > 0
        marginal = self.stats.prob_sum.cpu().numpy().astype(np.float64) / n
        log_marginal = np.log(np.clip(marginal, 1e-12, None))
        plogp_mean = float(self.stats.plogp_sum) / n
        cross = float(marginal @ log_marginal)
        kl_mean = plogp_mean - cross
        var = max(float(self.stats.plogp_per) / n - plogp_mean ** 2, 0.0)
        return kl_mean, float(np.sqrt(var))

    def score(self) -> float:
        kl_mean, _ = self.compute()
        return float(np.exp(kl_mean))

    def reset(self) -> None:
        self.stats = ISStats.create(self.num_classes) if self.num_classes else None
