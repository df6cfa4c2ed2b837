# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""CriticalSuccessIndex (counterpart of ``torchmetrics_tpu/regression/csi.py``).

States: ``hits``, ``misses`` and ``false_alarms`` (int32, 0-d), or with
``keep_sequence_dim`` their per-index counts in ``cat`` list states.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.regression.csi import (
    _critical_success_index_compute,
    _critical_success_index_update,
)
from torchmetrics_tpu_torch.functional.regression.utils import _jnp_dtype
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

Tensor = torch.Tensor


class CriticalSuccessIndex(Metric):
    """Critical success index at a ``threshold``."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, threshold: float, keep_sequence_dim: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(threshold, (int, float)):
            raise ValueError(f"Expected argument `threshold` to be a float but got {threshold}")
        self.threshold = float(threshold)
        if keep_sequence_dim is not None and (not isinstance(keep_sequence_dim, int) or keep_sequence_dim < 0):
            raise ValueError(f"Expected argument `keep_sequence_dim` to be an int but got {keep_sequence_dim}")
        self.keep_sequence_dim = keep_sequence_dim

        if keep_sequence_dim is None:
            self.add_state("hits", default=0, dist_reduce_fx="sum")
            self.add_state("misses", default=0, dist_reduce_fx="sum")
            self.add_state("false_alarms", default=0, dist_reduce_fx="sum")
        else:
            self.add_state("hits_list", default=[], dist_reduce_fx="cat")
            self.add_state("misses_list", default=[], dist_reduce_fx="cat")
            self.add_state("false_alarms_list", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Fold a batch's counts into the state."""
        preds, target = self._inputs(preds, target)
        hits, misses, false_alarms = _critical_success_index_update(
            _jnp_dtype(preds), _jnp_dtype(target), self.threshold, self.keep_sequence_dim
        )
        if self.keep_sequence_dim is None:
            self.hits = self.hits + hits
            self.misses = self.misses + misses
            self.false_alarms = self.false_alarms + false_alarms
        else:
            self.hits_list.append(hits)
            self.misses_list.append(misses)
            self.false_alarms_list.append(false_alarms)

    def compute(self) -> Tensor:
        """CSI from the counts."""
        if self.keep_sequence_dim is None:
            hits, misses, false_alarms = self.hits, self.misses, self.false_alarms
        else:
            hits = dim_zero_cat(self.hits_list)
            misses = dim_zero_cat(self.misses_list)
            false_alarms = dim_zero_cat(self.false_alarms_list)
        return _critical_success_index_compute(hits, misses, false_alarms)
