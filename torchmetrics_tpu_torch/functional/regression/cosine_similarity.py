# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Cosine similarity (counterpart of ``torchmetrics_tpu/functional/regression/cosine_similarity.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.regression.utils import _float32_pair
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape

Tensor = torch.Tensor


def _cosine_similarity_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Validate the ``(N, D)`` shapes; the rows pass through as float32."""
    _check_same_shape(preds, target)
    if preds.ndim != 2:
        raise ValueError(f"Expected input to cosine similarity to be 2D tensors of shape `[N,D]` but got {preds.ndim}D")
    return preds.to(torch.float32), target.to(torch.float32)


def _cosine_similarity_compute(preds: Tensor, target: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    """Row-wise cosine similarity, summed, averaged or per row."""
    dot_product = torch.sum(preds * target, dim=-1)
    preds_norm = torch.linalg.vector_norm(preds, dim=-1)
    target_norm = torch.linalg.vector_norm(target, dim=-1)
    similarity = dot_product / (preds_norm * target_norm)
    reduction_mapping = {
        "sum": torch.sum,
        "mean": torch.mean,
        "none": lambda x: x,
        None: lambda x: x,
    }
    if reduction not in reduction_mapping:
        raise ValueError(f"Expected reduction to be one of {list(reduction_mapping)} but got {reduction}")
    return reduction_mapping[reduction](similarity)


def cosine_similarity(preds: Tensor, target: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    """Compute the cosine similarity."""
    preds, target = _cosine_similarity_update(*_float32_pair(preds, target))
    return _cosine_similarity_compute(preds, target, reduction)
