# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Log-cosh error (counterpart of ``torchmetrics_tpu/functional/regression/log_cosh.py``).

``log(cosh(d))`` is computed as ``d + softplus(-2d) - log(2)``, which does
not overflow. The softplus is ``logaddexp(x, 0)``, which is what
``jax.nn.softplus`` computes; ``torch.nn.functional.softplus`` would
switch to the identity above its ``threshold`` and differ there.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from torchmetrics_tpu_torch.functional.regression.utils import _check_data_shape_to_num_outputs, _float32_pair
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape

Tensor = torch.Tensor


def _unsqueeze_tensors(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    if preds.ndim == 2:
        return preds, target
    return preds[:, None], target[:, None]


def _log_cosh_error_update(preds: Tensor, target: Tensor, num_outputs: int) -> Tuple[Tensor, Tensor]:
    """Sum of log-cosh errors (per output, squeezed) and the number of rows (int32, 0-d)."""
    _check_same_shape(preds, target)
    _check_data_shape_to_num_outputs(preds, target, num_outputs)
    preds, target = _unsqueeze_tensors(preds, target)
    diff = preds - target
    softplus = torch.logaddexp(-2.0 * diff, torch.zeros_like(diff))
    sum_log_cosh_error = torch.sum(diff + softplus - math.log(2.0), dim=0).squeeze()
    num_obs = torch.full((), target.shape[0], dtype=torch.int32, device=target.device)
    return sum_log_cosh_error, num_obs


def _log_cosh_error_compute(sum_log_cosh_error: Tensor, num_obs: Tensor) -> Tensor:
    """Mean log-cosh error."""
    return (sum_log_cosh_error / num_obs).squeeze()


def log_cosh_error(preds: Tensor, target: Tensor) -> Tensor:
    """Compute the log-cosh error."""
    preds, target = _float32_pair(preds, target)
    num_outputs = 1 if preds.ndim == 1 else preds.shape[-1]
    sum_log_cosh_error, num_obs = _log_cosh_error_update(preds, target, num_outputs)
    return _log_cosh_error_compute(sum_log_cosh_error, num_obs)
