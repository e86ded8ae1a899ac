"""Fréchet Inception Distance: streaming statistics and the closed form
(mirrors ``dmme_tpu/eval/fid.py``).

The accumulator keeps only (n, Σx, Σxxᵀ) of each distribution, in float32
on the features' device: O(d²) state that never stores a feature and merges
exactly by addition. Real statistics survive :meth:`reset` unless
``reset_real_features`` is set, as in the reference's torchmetrics metric.
The matrix square root of the Fréchet formula runs on the host, in float64,
through the eigendecomposition of a symmetrised product.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dmme_tpu_torch.parallel.mesh import flat_all_reduce
from dmme_tpu_torch.utils.device import ieee_f32


class FeatureStats(NamedTuple):
    """Streaming first and second moments of d-dimensional feature vectors."""

    n: torch.Tensor       # ()     the count, float32 as the sums
    sum: torch.Tensor     # (d,)
    outer: torch.Tensor   # (d, d) Σ x xᵀ

    @classmethod
    def create(cls, dim: int, dtype: torch.dtype = torch.float32,
               device=None) -> "FeatureStats":
        return cls(n=torch.zeros((), dtype=dtype, device=device),
                   sum=torch.zeros((dim,), dtype=dtype, device=device),
                   outer=torch.zeros((dim, dim), dtype=dtype, device=device))

    def to(self, device) -> "FeatureStats":
        return FeatureStats(*(t.to(device) for t in self))

    def update(self, feats: torch.Tensor) -> "FeatureStats":
        """Add a batch of features (N, d): one (d×N)(N×d) product for Σxxᵀ,
        in the stats' dtype on their device, TF32 off."""
        feats = feats.to(self.sum.dtype)
        with ieee_f32():
            outer = self.outer + torch.matmul(feats.T, feats)
        return FeatureStats(n=self.n + feats.shape[0], sum=self.sum + feats.sum(dim=0),
                            outer=outer)

    def merge(self, other: "FeatureStats") -> "FeatureStats":
        return FeatureStats(self.n + other.n, self.sum + other.sum, self.outer + other.outer)

    def moments(self) -> Tuple[np.ndarray, np.ndarray]:
        """(mean, unbiased covariance) in float64 on the host."""
        n = float(self.n)
        s = self.sum.cpu().numpy().astype(np.float64)
        o = self.outer.cpu().numpy().astype(np.float64)
        assert n > 1, "need at least 2 samples for covariance"
        mu = s / n
        cov = (o - n * np.outer(mu, mu)) / (n - 1)
        return mu, cov


def _sqrtm_product(c1: np.ndarray, c2: np.ndarray, eps: float = 1e-6) -> float:
    """tr((C1 C2)^{1/2}) as tr((S C2 S)^{1/2}) with S = C1^{1/2}, which is
    symmetric, so ``eigh`` applies."""
    w1, v1 = np.linalg.eigh(c1)
    s1 = (v1 * np.sqrt(np.clip(w1, 0, None))) @ v1.T
    m = s1 @ c2 @ s1
    w = np.linalg.eigvalsh((m + m.T) / 2)
    return float(np.sqrt(np.clip(w, 0, None)).sum())


def frechet_distance(mu1: np.ndarray, cov1: np.ndarray, mu2: np.ndarray,
                     cov2: np.ndarray) -> float:
    """FID = |μ1 − μ2|² + tr(C1 + C2 − 2 (C1 C2)^{1/2})."""
    diff = float(np.sum((mu1 - mu2) ** 2))
    return diff + float(np.trace(cov1) + np.trace(cov2)) - 2.0 * _sqrtm_product(cov1, cov2)


class FrechetInceptionDistance:
    """torchmetrics' interface over the streaming statistics. ``update``
    takes FEATURE batches (N, d); extracting them is the caller's concern
    (:mod:`dmme_tpu_torch.eval.inception`). The statistics follow the
    features onto their device at the first update."""

    def __init__(self, dim: int = 2048, reset_real_features: bool = False):
        self.dim = dim
        self.reset_real_features = reset_real_features
        self.real = FeatureStats.create(dim)
        self.fake = FeatureStats.create(dim)
        self._real_override: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def save_real_stats(self, path: str) -> None:
        """The real distribution's (μ, Σ) as pytorch-fid's ``.npz`` (keys
        ``mu`` and ``sigma``), so later runs skip the real pass."""
        mu, cov = self.real.moments()
        np.savez(path, mu=mu, sigma=cov)

    def load_real_stats(self, path: str) -> None:
        """Use precomputed real (μ, Σ): pytorch-fid's stats files or
        :meth:`save_real_stats`'s, of either package."""
        d = np.load(path)
        self._real_override = (np.asarray(d["mu"], np.float64),
                               np.asarray(d["sigma"], np.float64))

    @staticmethod
    def _update(stats: FeatureStats, feats: torch.Tensor) -> FeatureStats:
        if stats.sum.device != feats.device:
            stats = stats.to(feats.device)
        return stats.update(feats)

    def update(self, feats: torch.Tensor, real: bool) -> None:
        if real:
            self.real = self._update(self.real, feats)
        else:
            self.fake = self._update(self.fake, feats)

    def merge_across(self, mesh) -> None:
        """Sum both distributions' statistics over the mesh's ranks (JAX's
        ``psum`` of the stats across devices), on the mesh's device."""
        if mesh.world == 1:
            return
        self.real, self.fake = self.real.to(mesh.device), self.fake.to(mesh.device)
        flat_all_reduce([*self.real, *self.fake])

    def compute(self) -> float:
        if self._real_override is not None:
            mu_r, cov_r = self._real_override
        else:
            mu_r, cov_r = self.real.moments()
        mu_f, cov_f = self.fake.moments()
        return frechet_distance(mu_r, cov_r, mu_f, cov_f)

    def reset(self) -> None:
        self.fake = FeatureStats.create(self.dim)
        if self.reset_real_features:
            self.real = FeatureStats.create(self.dim)
