# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""R² score (counterpart of ``torchmetrics_tpu/functional/regression/r2.py``).

The masked assignments of near-constant outputs are ``torch.where``
selections, so the compute reads the device only for its sample-count check.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.regression.utils import _float32_pair
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor


def _r2_score_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor, int]:
    """Streaming sums of R²: sum of squared targets, sum of targets, residual sum of squares, rows."""
    _check_same_shape(preds, target)
    if preds.ndim > 2:
        raise ValueError(
            f"Expected both prediction and target to be 1D or 2D tensors, but received tensors with dimension {tuple(preds.shape)}"
        )
    sum_obs = torch.sum(target, dim=0)
    sum_squared_obs = torch.sum(target * target, dim=0)
    residual = target - preds
    rss = torch.sum(residual * residual, dim=0)
    return sum_squared_obs, sum_obs, rss, target.shape[0]


def _r2_score_compute(
    sum_squared_obs: Tensor,
    sum_obs: Tensor,
    rss: Tensor,
    num_obs: Union[int, Tensor],
    adjusted: int = 0,
    multioutput: str = "uniform_average",
) -> Tensor:
    """R² from the streaming sums."""
    if int(num_obs) < 2:
        raise ValueError("Needs at least two samples to calculate r2 score.")

    mean_obs = sum_obs / num_obs
    tss = sum_squared_obs - sum_obs * mean_obs

    # account for near-constant targets
    zero = torch.zeros_like(rss)
    cond_rss = ~torch.isclose(rss, zero, rtol=1e-5, atol=1e-4)
    cond_tss = ~torch.isclose(tss, zero, rtol=1e-5, atol=1e-4)
    cond = cond_rss & cond_tss
    safe_tss = torch.where(cond, tss, torch.ones_like(tss))
    raw_scores = torch.where(cond, 1 - rss / safe_tss, torch.where(cond_rss & ~cond_tss, zero, torch.ones_like(rss)))

    if multioutput == "raw_values":
        r2 = raw_scores
    elif multioutput == "uniform_average":
        r2 = torch.mean(raw_scores)
    elif multioutput == "variance_weighted":
        tss_sum = torch.sum(tss)
        r2 = torch.sum(tss / tss_sum * raw_scores)
    else:
        raise ValueError(
            "Argument `multioutput` must be either `raw_values`,"
            f" `uniform_average` or `variance_weighted`. Received {multioutput}."
        )

    if adjusted < 0 or not isinstance(adjusted, int):
        raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")

    if adjusted != 0:
        if adjusted > num_obs - 1:
            rank_zero_warn(
                "More independent regressions than data points in"
                " adjusted r2 score. Falls back to standard r2 score.",
                UserWarning,
            )
        elif adjusted == num_obs - 1:
            rank_zero_warn("Division by zero in adjusted r2 score. Falls back to standard r2 score.", UserWarning)
        else:
            return 1 - (1 - r2) * (num_obs - 1) / (num_obs - adjusted - 1)
    return r2


def r2_score(preds: Tensor, target: Tensor, adjusted: int = 0, multioutput: str = "uniform_average") -> Tensor:
    """Compute the R² score."""
    preds, target = _float32_pair(preds, target)
    sum_squared_obs, sum_obs, rss, num_obs = _r2_score_update(preds, target)
    return _r2_score_compute(sum_squared_obs, sum_obs, rss, num_obs, adjusted, multioutput)
