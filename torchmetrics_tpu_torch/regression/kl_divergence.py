# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""KLDivergence (counterpart of ``torchmetrics_tpu/regression/kl_divergence.py``).

With ``reduction`` ``"mean"`` or ``"sum"`` the ``measures`` state is a
float32 0-d sum; with ``"none"``/``None`` the per-row measures go into a
``cat`` list state. ``total`` is int32, 0-d.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.regression.kl_divergence import _kld_compute, _kld_update
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

Tensor = torch.Tensor


class KLDivergence(Metric):
    """KL divergence of ``p`` from ``q``, row by row."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, log_prob: bool = False, reduction: Optional[str] = "mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(log_prob, bool):
            raise TypeError(f"Expected argument `log_prob` to be bool but got {log_prob}")
        self.log_prob = log_prob
        allowed_reduction = ["mean", "sum", "none", None]
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.reduction = reduction

        if self.reduction in ["mean", "sum"]:
            self.add_state("measures", 0.0, dist_reduce_fx="sum")
        else:
            self.add_state("measures", [], dist_reduce_fx="cat")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, p: Tensor, q: Tensor) -> None:
        """Fold a batch of rows into the state."""
        p, q = self._inputs(p, q)
        measures, total = _kld_update(p.to(torch.float32), q.to(torch.float32), self.log_prob)
        if self.reduction is None or self.reduction == "none":
            self.measures.append(measures)
        else:
            self.measures = self.measures + torch.sum(measures)
        self.total = self.total + total

    def compute(self) -> Tensor:
        """The reduced KL divergence."""
        measures = dim_zero_cat(self.measures) if self.reduction in ["none", None] else self.measures
        return _kld_compute(measures, self.total, self.reduction)
