# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Image module metrics (counterpart of ``torchmetrics_tpu/image/__init__.py``)."""
from torchmetrics_tpu_torch.image.fid import FrechetInceptionDistance
from torchmetrics_tpu_torch.image.inception_score import InceptionScore
from torchmetrics_tpu_torch.image.kid import KernelInceptionDistance
from torchmetrics_tpu_torch.image.lpip import LearnedPerceptualImagePatchSimilarity
from torchmetrics_tpu_torch.image.mifid import MemorizationInformedFrechetInceptionDistance
from torchmetrics_tpu_torch.image.perceptual_path_length import PerceptualPathLength
from torchmetrics_tpu_torch.image.metrics import (
    ErrorRelativeGlobalDimensionlessSynthesis,
    MultiScaleStructuralSimilarityIndexMeasure,
    PeakSignalNoiseRatio,
    PeakSignalNoiseRatioWithBlockedEffect,
    QualityWithNoReference,
    RelativeAverageSpectralError,
    RootMeanSquaredErrorUsingSlidingWindow,
    SpatialCorrelationCoefficient,
    SpatialDistortionIndex,
    SpectralAngleMapper,
    SpectralDistortionIndex,
    StructuralSimilarityIndexMeasure,
    TotalVariation,
    UniversalImageQualityIndex,
    VisualInformationFidelity,
)

__all__ = [
    "ErrorRelativeGlobalDimensionlessSynthesis",
    "FrechetInceptionDistance",
    "InceptionScore",
    "KernelInceptionDistance",
    "LearnedPerceptualImagePatchSimilarity",
    "MemorizationInformedFrechetInceptionDistance",
    "PerceptualPathLength",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "PeakSignalNoiseRatioWithBlockedEffect",
    "QualityWithNoReference",
    "RelativeAverageSpectralError",
    "RootMeanSquaredErrorUsingSlidingWindow",
    "SpatialCorrelationCoefficient",
    "SpatialDistortionIndex",
    "SpectralAngleMapper",
    "SpectralDistortionIndex",
    "StructuralSimilarityIndexMeasure",
    "TotalVariation",
    "UniversalImageQualityIndex",
    "VisualInformationFidelity",
]
