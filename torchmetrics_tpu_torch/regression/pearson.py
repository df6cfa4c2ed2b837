# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""PearsonCorrCoef (counterpart of ``torchmetrics_tpu/regression/pearson.py``).

States: ``mean_x``, ``mean_y``, ``var_x``, ``var_y``, ``corr_xy`` and the
count ``n_total``, all float32 ``(num_outputs,)`` with
``dist_reduce_fx=None``: a replica gather stacks them along a leading axis,
repeated sharded folds along several, and ``compute`` flattens every
leading axis into one shard axis and merges the shards with
:func:`_final_aggregation`.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from torchmetrics_tpu_torch.functional.regression.pearson import (
    _final_aggregation,
    _pearson_corrcoef_compute,
    _pearson_corrcoef_update,
)
from torchmetrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class PearsonCorrCoef(Metric):
    """Pearson correlation coefficient, per output."""

    is_differentiable = True
    higher_is_better = None
    full_state_update = True
    plot_lower_bound = -1.0
    plot_upper_bound = 1.0

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(num_outputs, int) or num_outputs < 1:
            raise ValueError(f"Expected argument `num_outputs` to be an int larger than 0, but got {num_outputs}")
        self.num_outputs = num_outputs
        for name in ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total"):
            self.add_state(name, default=torch.zeros(self.num_outputs), dist_reduce_fx=None)

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Fold a batch into the streaming statistics."""
        preds, target = self._inputs(preds, target)
        self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total = _pearson_corrcoef_update(
            preds.to(torch.float32),
            target.to(torch.float32),
            self.mean_x,
            self.mean_y,
            self.var_x,
            self.var_y,
            self.corr_xy,
            self.n_total,
            self.num_outputs,
        )

    def _merged_states(self) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
        """``(mean_x, mean_y, var_x, var_y, corr_xy, n_total)``, merged across
        shards where the states arrive stacked (one or several leading axes)."""
        if (self.num_outputs == 1 and self.mean_x.numel() > 1) or (self.num_outputs > 1 and self.mean_x.ndim > 1):

            def shards(v: Tensor) -> Tensor:
                return v.reshape(-1, self.num_outputs)

            return _final_aggregation(
                shards(self.mean_x), shards(self.mean_y), shards(self.var_x),
                shards(self.var_y), shards(self.corr_xy), shards(self.n_total),
            )
        return self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total

    def compute(self) -> Tensor:
        """Pearson r."""
        _, _, var_x, var_y, corr_xy, n_total = self._merged_states()
        return _pearson_corrcoef_compute(var_x, var_y, corr_xy, n_total)
