# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Normalized mutual information (counterpart of
``torchmetrics_tpu/functional/clustering/normalized_mutual_info_score.py``)."""
from __future__ import annotations

import torch

from torchmetrics_tpu_torch.functional.clustering.mutual_info_score import mutual_info_score
from torchmetrics_tpu_torch.functional.clustering.utils import (
    _validate_average_method_arg,
    calculate_entropy,
    calculate_generalized_mean,
    check_cluster_labels,
)
from torchmetrics_tpu_torch.utilities.data import _jnp_dtype, _to_tensors

Tensor = torch.Tensor


def normalized_mutual_info_score(preds: Tensor, target: Tensor, average_method: str = "arithmetic") -> Tensor:
    """NMI = MI / the generalized mean of H(preds) and H(target); MI itself where MI is about 0."""
    preds, target = map(_jnp_dtype, _to_tensors(preds, target))
    check_cluster_labels(preds, target)
    _validate_average_method_arg(average_method)
    mutual_info = mutual_info_score(preds, target)
    # ~zero MI stands for itself (the normalizer may be 0 there), as jnp.isclose(mi, 0, atol=eps) decides
    eps = torch.finfo(torch.float32).eps
    degenerate = torch.isclose(mutual_info, torch.zeros_like(mutual_info), rtol=1e-5, atol=eps)
    normalizer = calculate_generalized_mean(
        torch.stack([calculate_entropy(preds), calculate_entropy(target)]), average_method
    )
    one = torch.ones_like(normalizer)
    return torch.where(degenerate, mutual_info, mutual_info / torch.where(degenerate, one, normalizer))
