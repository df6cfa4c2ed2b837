# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Group fairness module metrics (counterpart of ``torchmetrics_tpu/classification/group_fairness.py``).

States: per-group float32 ``tp``, ``fp``, ``tn`` and ``fn`` of
``(num_groups,)``, each batch's int32 counts added to them. ``update`` takes
three positional arguments, ``(preds, target, groups)``; the result dicts
are built at compute, on the host, as in JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from torchmetrics_tpu_torch.functional.classification.group_fairness import (
    _binary_groups_stat_counts,
    _check_fairness_task,
    _fairness_ratios,
    _fairness_target,
    _groups_reduce,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import _to_tensor

Tensor = torch.Tensor


def _check_num_groups(num_groups: int) -> None:
    if not isinstance(num_groups, int) or num_groups < 2:
        raise ValueError(f"Expected argument `num_groups` to be an int larger than 1, but got {num_groups}")


class _AbstractGroupStatScores(Metric):
    """Create and update per-group tp/fp/tn/fn states."""

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def _create_states(self, num_groups: int, threshold: float, ignore_index: Optional[int], validate_args: bool) -> None:
        self.num_groups = num_groups
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        for name in ("tp", "fp", "tn", "fn"):
            self.add_state(name, torch.zeros(num_groups, dtype=torch.float32), dist_reduce_fx="sum")

    def _update_states(self, preds: Tensor, target: Tensor, groups: Tensor) -> None:
        tp, fp, tn, fn = _binary_groups_stat_counts(
            preds, target, groups, self.num_groups, self.threshold, self.ignore_index, self.validate_args
        )
        self.tp = self.tp + tp
        self.fp = self.fp + fp
        self.tn = self.tn + tn
        self.fn = self.fn + fn


class BinaryGroupStatRates(_AbstractGroupStatScores):
    """tp/fp/tn/fn rates by group."""

    def __init__(
        self,
        num_groups: int,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _check_num_groups(num_groups)
        self._create_states(num_groups, threshold, ignore_index, validate_args)

    def update(self, preds: Tensor, target: Tensor, groups: Tensor) -> None:
        """Fold the batch's per-group stat scores."""
        preds, target = self._inputs(preds, target)
        self._update_states(preds, target, _to_tensor(groups, self.device))

    def compute(self) -> Dict[str, Tensor]:
        """Per-group rates, keyed ``group_{i}``."""
        return _groups_reduce(self.tp, self.fp, self.tn, self.fn)


class BinaryFairness(_AbstractGroupStatScores):
    """Demographic parity and/or equal opportunity ratios."""

    def __init__(
        self,
        num_groups: int,
        task: str = "all",
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _check_fairness_task(task)
        _check_num_groups(num_groups)
        self.task = task
        self._create_states(num_groups, threshold, ignore_index, validate_args)

    def update(self, preds: Tensor, target: Optional[Tensor], groups: Tensor) -> None:
        """Fold the batch's per-group stat scores (demographic parity ignores ``target``)."""
        preds = _to_tensor(preds, self.device)
        target = _fairness_target(self.task, preds, target)
        self._update_states(preds, target, _to_tensor(groups, self.device))

    def compute(self) -> Dict[str, Tensor]:
        """The ratios of the task, keyed ``DP_{argmin}_{argmax}`` / ``EO_{argmin}_{argmax}``."""
        return _fairness_ratios(self.task, self.tp, self.fp, self.tn, self.fn)


__all__ = ["BinaryFairness", "BinaryGroupStatRates"]
