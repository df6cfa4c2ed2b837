# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Multimodal module metrics of the port (counterpart of ``torchmetrics_tpu/multimodal``)."""
from torchmetrics_tpu_torch.multimodal.clip_iqa import CLIPImageQualityAssessment
from torchmetrics_tpu_torch.multimodal.clip_score import CLIPScore

__all__ = ["CLIPImageQualityAssessment", "CLIPScore"]
