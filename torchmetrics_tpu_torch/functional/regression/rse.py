# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Relative squared error (counterpart of ``torchmetrics_tpu/functional/regression/rse.py``)."""
from __future__ import annotations

from typing import Union

import torch

from torchmetrics_tpu_torch.functional.regression.r2 import _r2_score_update
from torchmetrics_tpu_torch.functional.regression.utils import _float32_pair

Tensor = torch.Tensor


def _relative_squared_error_compute(
    sum_squared_obs: Tensor,
    sum_obs: Tensor,
    sum_squared_error: Tensor,
    num_obs: Union[int, Tensor],
    squared: bool = True,
) -> Tensor:
    """RSE (or its root with ``squared=False``), averaged over the outputs."""
    epsilon = torch.finfo(sum_squared_error.dtype).eps
    rse = sum_squared_error / torch.clamp(sum_squared_obs - sum_obs * sum_obs / num_obs, min=epsilon)
    if not squared:
        rse = torch.sqrt(rse)
    return torch.mean(rse)


def relative_squared_error(preds: Tensor, target: Tensor, squared: bool = True) -> Tensor:
    """Compute the relative squared error."""
    preds, target = _float32_pair(preds, target)
    sum_squared_obs, sum_obs, rss, num_obs = _r2_score_update(preds, target)
    return _relative_squared_error_compute(sum_squared_obs, sum_obs, rss, num_obs, squared=squared)
