# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Image functional metrics (counterpart of ``torchmetrics_tpu/functional/image/__init__.py``)."""
from torchmetrics_tpu_torch.functional.image.distortion import (
    quality_with_no_reference,
    spatial_distortion_index,
    spectral_distortion_index,
)
from torchmetrics_tpu_torch.functional.image.metrics import (
    error_relative_global_dimensionless_synthesis,
    image_gradients,
    peak_signal_noise_ratio,
    peak_signal_noise_ratio_with_blocked_effect,
    relative_average_spectral_error,
    root_mean_squared_error_using_sliding_window,
    spatial_correlation_coefficient,
    spectral_angle_mapper,
    total_variation,
    universal_image_quality_index,
    visual_information_fidelity,
)
from torchmetrics_tpu_torch.image.lpip import learned_perceptual_image_patch_similarity
from torchmetrics_tpu_torch.image.perceptual_path_length import perceptual_path_length
from torchmetrics_tpu_torch.functional.image.ssim import (
    multiscale_structural_similarity_index_measure,
    structural_similarity_index_measure,
)

__all__ = [
    "error_relative_global_dimensionless_synthesis",
    "image_gradients",
    "learned_perceptual_image_patch_similarity",
    "multiscale_structural_similarity_index_measure",
    "peak_signal_noise_ratio",
    "perceptual_path_length",
    "peak_signal_noise_ratio_with_blocked_effect",
    "quality_with_no_reference",
    "relative_average_spectral_error",
    "root_mean_squared_error_using_sliding_window",
    "spatial_correlation_coefficient",
    "spatial_distortion_index",
    "spectral_angle_mapper",
    "spectral_distortion_index",
    "structural_similarity_index_measure",
    "total_variation",
    "universal_image_quality_index",
    "visual_information_fidelity",
]
