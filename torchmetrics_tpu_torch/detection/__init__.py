# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Detection module metrics (counterpart of ``torchmetrics_tpu/detection/__init__.py``)."""
from torchmetrics_tpu_torch.detection.iou import (
    CompleteIntersectionOverUnion,
    DistanceIntersectionOverUnion,
    GeneralizedIntersectionOverUnion,
    IntersectionOverUnion,
)
from torchmetrics_tpu_torch.detection.mean_ap import MeanAveragePrecision
from torchmetrics_tpu_torch.detection.panoptic_qualities import ModifiedPanopticQuality, PanopticQuality

__all__ = [
    "CompleteIntersectionOverUnion",
    "DistanceIntersectionOverUnion",
    "GeneralizedIntersectionOverUnion",
    "IntersectionOverUnion",
    "MeanAveragePrecision",
    "ModifiedPanopticQuality",
    "PanopticQuality",
]
