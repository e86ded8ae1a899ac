"""Evaluation: FID and Inception Score with an InceptionV3 feature extractor
(mirrors ``dmme_tpu/eval``)."""

from dmme_tpu_torch.eval.fid import FeatureStats, FrechetInceptionDistance, frechet_distance
from dmme_tpu_torch.eval.inception import InceptionV3, make_feature_fn, preprocess
from dmme_tpu_torch.eval.inception_score import InceptionScore

__all__ = [
    "FeatureStats",
    "FrechetInceptionDistance",
    "frechet_distance",
    "InceptionScore",
    "InceptionV3",
    "make_feature_fn",
    "preprocess",
]
