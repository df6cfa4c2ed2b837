# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Segmentation module metrics (counterpart of ``torchmetrics_tpu/segmentation``)."""
from torchmetrics_tpu_torch.segmentation.metrics import GeneralizedDiceScore, MeanIoU

__all__ = ["GeneralizedDiceScore", "MeanIoU"]
