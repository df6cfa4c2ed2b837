# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Functional segmentation metrics (counterpart of ``torchmetrics_tpu/functional/segmentation``)."""
from torchmetrics_tpu_torch.functional.segmentation.generalized_dice import generalized_dice_score
from torchmetrics_tpu_torch.functional.segmentation.mean_iou import mean_iou

__all__ = ["generalized_dice_score", "mean_iou"]
