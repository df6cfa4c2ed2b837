# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Detection functional metrics (counterpart of ``torchmetrics_tpu/functional/detection/__init__.py``)."""
from torchmetrics_tpu_torch.functional.detection.iou import (
    complete_intersection_over_union,
    distance_intersection_over_union,
    generalized_intersection_over_union,
    intersection_over_union,
)
from torchmetrics_tpu_torch.functional.detection.map import coco_mean_average_precision
from torchmetrics_tpu_torch.functional.detection.panoptic_quality import modified_panoptic_quality, panoptic_quality

__all__ = [
    "coco_mean_average_precision",
    "complete_intersection_over_union",
    "distance_intersection_over_union",
    "generalized_intersection_over_union",
    "intersection_over_union",
    "modified_panoptic_quality",
    "panoptic_quality",
]
