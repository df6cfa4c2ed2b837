# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Multimodal functional metrics of the port (counterpart of ``torchmetrics_tpu/functional/multimodal``)."""
from torchmetrics_tpu_torch.functional.multimodal.clip_iqa import clip_image_quality_assessment
from torchmetrics_tpu_torch.functional.multimodal.clip_score import clip_score

__all__ = ["clip_image_quality_assessment", "clip_score"]
