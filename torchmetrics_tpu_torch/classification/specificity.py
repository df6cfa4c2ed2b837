# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Specificity module metrics (counterpart of ``torchmetrics_tpu/classification/specificity.py``)."""
from __future__ import annotations

from torchmetrics_tpu_torch.classification._derived import make_stat_scores_family
from torchmetrics_tpu_torch.functional.classification.specificity import _specificity_reduce

BinarySpecificity, MulticlassSpecificity, MultilabelSpecificity, Specificity = make_stat_scores_family(
    "Specificity", _specificity_reduce
)

__all__ = ["BinarySpecificity", "MulticlassSpecificity", "MultilabelSpecificity", "Specificity"]
