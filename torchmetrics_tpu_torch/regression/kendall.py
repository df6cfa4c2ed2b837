# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""KendallRankCorrCoef (counterpart of ``torchmetrics_tpu/regression/kendall.py``).

The pair census is global, so the whole stream stays in ``cat`` states
(float32 ``(N, 1)`` rows for one output) until ``compute``.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.regression.kendall import (
    _kendall_corrcoef_compute,
    _MetricVariant,
    _TestAlternative,
)
from torchmetrics_tpu_torch.functional.regression.utils import _check_data_shape_to_num_outputs
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

Tensor = torch.Tensor


class KendallRankCorrCoef(Metric):
    """Kendall rank correlation (tau a, b or c), with an optional significance test."""

    is_differentiable = False
    higher_is_better = None
    full_state_update = True
    plot_lower_bound = -1.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        variant: str = "b",
        t_test: bool = False,
        alternative: Optional[str] = "two-sided",
        num_outputs: int = 1,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(t_test, bool):
            raise ValueError(f"Argument `t_test` is expected to be of a type `bool`, but got {type(t_test)}.")
        if t_test and alternative is None:
            raise ValueError("Argument `alternative` is required if `t_test=True` but got `None`.")
        self.variant = _MetricVariant.from_str(str(variant))
        self.alternative = _TestAlternative.from_str(str(alternative)) if t_test else None
        self.num_outputs = num_outputs
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Append a batch."""
        preds, target = self._inputs(preds, target)
        preds, target = preds.to(torch.float32), target.to(torch.float32)
        _check_same_shape(preds, target)
        _check_data_shape_to_num_outputs(preds, target, self.num_outputs)
        if self.num_outputs == 1 and preds.ndim == 1:
            preds = preds[:, None]
            target = target[:, None]
        self.preds.append(preds)
        self.target.append(target)

    def compute(self):
        """Tau (and the p-value with ``t_test=True``) over the whole stream."""
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        if self.num_outputs == 1:
            preds = preds.reshape(-1)
            target = target.reshape(-1)
        tau, p_value = _kendall_corrcoef_compute(
            preds,
            target,
            str(self.variant.value),
            str(self.alternative.value) if self.alternative is not None else None,
        )
        if p_value is not None:
            return tau, p_value
        return tau
