# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Homogeneity, completeness and V-measure (counterpart of
``torchmetrics_tpu/functional/clustering/homogeneity_completeness_v_measure.py``)."""
from __future__ import annotations

from typing import Tuple

import torch

from torchmetrics_tpu_torch.functional.clustering.mutual_info_score import mutual_info_score
from torchmetrics_tpu_torch.functional.clustering.utils import calculate_entropy, check_cluster_labels
from torchmetrics_tpu_torch.utilities.data import _jnp_dtype, _to_tensors

Tensor = torch.Tensor


def _ratio_or_one(num: Tensor, den: Tensor) -> Tensor:
    """``num / den``, and 1 where ``den`` is 0."""
    nonzero = den != 0
    return torch.where(nonzero, num / torch.where(nonzero, den, torch.ones_like(den)), torch.ones_like(num))


def _homogeneity_score_compute(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """homogeneity = MI / H(target)."""
    check_cluster_labels(preds, target)
    if target.numel() == 0:
        zero = torch.tensor(0.0, device=target.device)
        return zero, zero, zero, zero
    entropy_target = calculate_entropy(target)
    entropy_preds = calculate_entropy(preds)
    mutual_info = mutual_info_score(preds, target)
    return _ratio_or_one(mutual_info, entropy_target), mutual_info, entropy_preds, entropy_target


def _completeness_score_compute(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """completeness = MI / H(preds)."""
    homogeneity, mutual_info, entropy_preds, _ = _homogeneity_score_compute(preds, target)
    return _ratio_or_one(mutual_info, entropy_preds), homogeneity


def homogeneity_score(preds: Tensor, target: Tensor) -> Tensor:
    """Homogeneity: each cluster contains only one class."""
    preds, target = map(_jnp_dtype, _to_tensors(preds, target))
    homogeneity, _, _, _ = _homogeneity_score_compute(preds, target)
    return homogeneity


def completeness_score(preds: Tensor, target: Tensor) -> Tensor:
    """Completeness: all members of a class are in one cluster."""
    preds, target = map(_jnp_dtype, _to_tensors(preds, target))
    completeness, _ = _completeness_score_compute(preds, target)
    return completeness


def v_measure_score(preds: Tensor, target: Tensor, beta: float = 1.0) -> Tensor:
    """Weighted harmonic mean of homogeneity and completeness (a host read of their sum)."""
    preds, target = map(_jnp_dtype, _to_tensors(preds, target))
    completeness, homogeneity = _completeness_score_compute(preds, target)
    if bool(homogeneity + completeness == 0):
        return torch.tensor(0.0, device=preds.device)
    return (1 + beta) * homogeneity * completeness / (beta * homogeneity + completeness)
