# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Mutual information score (counterpart of ``torchmetrics_tpu/functional/clustering/mutual_info_score.py``)."""
from __future__ import annotations

import torch

from torchmetrics_tpu_torch.functional.clustering.utils import _f32, calculate_contingency_matrix, check_cluster_labels
from torchmetrics_tpu_torch.utilities.data import _jnp_dtype, _to_tensors

Tensor = torch.Tensor


def _mutual_info_score_update(preds: Tensor, target: Tensor) -> Tensor:
    """The int32 contingency matrix."""
    check_cluster_labels(preds, target)
    return calculate_contingency_matrix(preds, target)


def _mutual_info_score_compute(contingency: Tensor) -> Tensor:
    """MI from the contingency matrix; zero entries contribute 0 by a mask (float32)."""
    n = _f32(contingency.sum())
    u = _f32(contingency.sum(dim=1))
    v = _f32(contingency.sum(dim=0))
    if u.shape[0] == 1 or v.shape[0] == 1:
        return torch.tensor(0.0, device=contingency.device)
    nz = contingency > 0
    cont = _f32(contingency)
    log_outer = torch.log(torch.clamp(u, min=1))[:, None] + torch.log(torch.clamp(v, min=1))[None, :]
    terms = cont / n * (torch.log(n) + torch.log(torch.clamp(cont, min=1)) - log_outer)
    return torch.where(nz, terms, torch.zeros_like(terms)).sum()


def mutual_info_score(preds: Tensor, target: Tensor) -> Tensor:
    """Mutual information between two clusterings."""
    preds, target = map(_jnp_dtype, _to_tensors(preds, target))
    contingency = _mutual_info_score_update(preds, target)
    return _mutual_info_score_compute(contingency)
