# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Minkowski distance (counterpart of ``torchmetrics_tpu/functional/regression/minkowski.py``)."""
from __future__ import annotations

import torch

from torchmetrics_tpu_torch.functional.regression.utils import _float32_pair
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

Tensor = torch.Tensor


def _check_p(p: float) -> None:
    if not (isinstance(p, (float, int)) and p >= 1):
        raise TorchMetricsUserError(f"Argument ``p`` must be a float or int greater than 1, but got {p}")


def _minkowski_distance_update(preds: Tensor, targets: Tensor, p: float) -> Tensor:
    """Sum of the ``p``-th powers of the absolute errors (0-d)."""
    _check_same_shape(preds, targets)
    _check_p(p)
    return torch.sum(torch.pow(torch.abs(preds - targets), p))


def _minkowski_distance_compute(distance: Tensor, p: float) -> Tensor:
    """The ``p``-th root of the summed powers."""
    return torch.pow(distance, 1.0 / p)


def minkowski_distance(preds: Tensor, targets: Tensor, p: float) -> Tensor:
    """Compute the Minkowski distance."""
    preds, targets = _float32_pair(preds, targets)
    return _minkowski_distance_compute(_minkowski_distance_update(preds, targets, p), p)
