# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""KL divergence (counterpart of ``torchmetrics_tpu/functional/regression/kl_divergence.py``)."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.regression.utils import _float32_pair
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.compute import _safe_xlogy

Tensor = torch.Tensor


def _kld_update(p: Tensor, q: Tensor, log_prob: bool) -> Tuple[Tensor, int]:
    """Per-row KL measures and the number of rows."""
    _check_same_shape(p, q)
    if p.ndim != 2 or q.ndim != 2:
        raise ValueError(f"Expected both p and q distribution to be 2D but got {p.ndim} and {q.ndim} respectively")

    total = p.shape[0]
    if log_prob:
        measures = torch.sum(torch.exp(p) * (p - q), dim=-1)
    else:
        p = p / torch.sum(p, dim=-1, keepdim=True)
        q = q / torch.sum(q, dim=-1, keepdim=True)
        measures = torch.sum(_safe_xlogy(p, p / q), dim=-1)
    return measures, total


def _kld_compute(measures: Tensor, total: Union[int, Tensor], reduction: Optional[str] = "mean") -> Tensor:
    """Reduce the KL measures: ``"sum"``, ``"mean"`` or ``"none"``/``None``."""
    if reduction == "sum":
        return torch.sum(measures)
    if reduction == "mean":
        return torch.sum(measures) / total
    if reduction is None or reduction == "none":
        return measures
    return measures / total


def kl_divergence(p: Tensor, q: Tensor, log_prob: bool = False, reduction: Optional[str] = "mean") -> Tensor:
    """Compute the KL divergence."""
    p, q = _float32_pair(p, q)
    measures, total = _kld_update(p, q, log_prob)
    return _kld_compute(measures, total, reduction)
