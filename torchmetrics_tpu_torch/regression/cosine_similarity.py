# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""CosineSimilarity (counterpart of ``torchmetrics_tpu/regression/cosine_similarity.py``).

States: ``preds`` and ``target``, ``cat`` lists of float32 ``(N, D)`` rows.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.regression.cosine_similarity import (
    _cosine_similarity_compute,
    _cosine_similarity_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

Tensor = torch.Tensor


class CosineSimilarity(Metric):
    """Cosine similarity of rows, summed, averaged or per row."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, reduction: Optional[str] = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        allowed_reduction = ("sum", "mean", "none", None)
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.reduction = reduction
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Append a batch of rows."""
        preds, target = self._inputs(preds, target)
        preds, target = _cosine_similarity_update(preds.to(torch.float32), target.to(torch.float32))
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        """Cosine similarity over every row seen."""
        return _cosine_similarity_compute(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.reduction)
