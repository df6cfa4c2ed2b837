# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Explained variance (counterpart of
``torchmetrics_tpu/functional/regression/explained_variance.py``).

The masked assignments of zero numerators and denominators are
``torch.where`` selections: no host read."""
from __future__ import annotations

from typing import Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.regression.utils import _float32_pair
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape

Tensor = torch.Tensor

ALLOWED_MULTIOUTPUT = ("raw_values", "uniform_average", "variance_weighted")


def _explained_variance_update(preds: Tensor, target: Tensor) -> Tuple[int, Tensor, Tensor, Tensor, Tensor]:
    """Rows, then the sums of the error, its square, the target and its square."""
    _check_same_shape(preds, target)
    diff = target - preds
    return (
        preds.shape[0],
        torch.sum(diff, dim=0),
        torch.sum(diff * diff, dim=0),
        torch.sum(target, dim=0),
        torch.sum(target * target, dim=0),
    )


def _explained_variance_compute(
    num_obs: Union[int, Tensor],
    sum_error: Tensor,
    sum_squared_error: Tensor,
    sum_target: Tensor,
    sum_squared_target: Tensor,
    multioutput: str = "uniform_average",
) -> Tensor:
    """Explained variance from the streaming sums."""
    diff_avg = sum_error / num_obs
    numerator = sum_squared_error / num_obs - diff_avg * diff_avg
    target_avg = sum_target / num_obs
    denominator = sum_squared_target / num_obs - target_avg * target_avg

    nonzero_numerator = numerator != 0
    nonzero_denominator = denominator != 0
    safe_denominator = torch.where(nonzero_denominator, denominator, torch.ones_like(denominator))
    output_scores = torch.where(
        nonzero_numerator & nonzero_denominator,
        1.0 - numerator / safe_denominator,
        torch.where(nonzero_numerator & ~nonzero_denominator, torch.zeros_like(diff_avg), torch.ones_like(diff_avg)),
    )

    if multioutput == "raw_values":
        return output_scores
    if multioutput == "uniform_average":
        return torch.mean(output_scores)
    if multioutput == "variance_weighted":
        denom_sum = torch.sum(denominator)
        return torch.sum(denominator / denom_sum * output_scores)
    raise ValueError(f"Argument `multioutput` must be one of {ALLOWED_MULTIOUTPUT}, but got {multioutput}")


def explained_variance(preds: Tensor, target: Tensor, multioutput: str = "uniform_average") -> Tensor:
    """Compute the explained variance."""
    if multioutput not in ALLOWED_MULTIOUTPUT:
        raise ValueError(f"Invalid input to argument `multioutput`. Choose one of the following: {ALLOWED_MULTIOUTPUT}")
    preds, target = _float32_pair(preds, target)
    num_obs, sum_error, sum_squared_error, sum_target, sum_squared_target = _explained_variance_update(preds, target)
    return _explained_variance_compute(num_obs, sum_error, sum_squared_error, sum_target, sum_squared_target, multioutput)
