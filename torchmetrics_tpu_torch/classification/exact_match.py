# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Exact match module metrics (counterpart of ``torchmetrics_tpu/classification/exact_match.py``).

States: int32 ``correct``/``total`` counters with ``"sum"`` (global), or
append-lists with ``"cat"`` (samplewise)."""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.functional.classification.exact_match import (
    _exact_match_reduce,
    _multiclass_exact_match_update,
    _multilabel_exact_match_format,
    _multilabel_exact_match_update,
)
from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_tensor_validation,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat
from torchmetrics_tpu_torch.utilities.enums import ClassificationTaskNoBinary

Tensor = torch.Tensor


class _AbstractExactMatch(Metric):
    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def _create_state(self, multidim_average: str) -> None:
        if multidim_average == "samplewise":
            self.add_state("correct", [], dist_reduce_fx="cat")
            self.add_state("total", [], dist_reduce_fx="cat")
        else:
            self.add_state("correct", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
            self.add_state("total", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def _update_state(self, correct: Tensor, total: Tensor) -> None:
        if isinstance(self.correct, list):
            self.correct.append(correct)
            self.total.append(total.expand(correct.shape).contiguous() if total.ndim == 0 else total)
        else:
            self.correct = self.correct + correct
            self.total = self.total + total

    def _final_state(self) -> Tuple[Tensor, Tensor]:
        return dim_zero_cat(self.correct), dim_zero_cat(self.total)

    def compute(self) -> Tensor:
        """``correct / total``."""
        correct, total = self._final_state()
        return _exact_match_reduce(correct, total)


class MulticlassExactMatch(_AbstractExactMatch):
    """Multiclass exact match: a sample counts when all its entries match."""
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        num_classes: int,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_stat_scores_arg_validation(num_classes, 1, None, multidim_average, ignore_index)
        self.num_classes = num_classes
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(multidim_average)

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        preds, target = self._inputs(preds, target)
        if self.validate_args:
            _multiclass_stat_scores_tensor_validation(preds, target, self.num_classes, self.multidim_average, self.ignore_index)
        preds, target = _multiclass_stat_scores_format(preds, target, 1)
        self._update_state(*_multiclass_exact_match_update(preds, target, self.multidim_average, self.ignore_index))


class MultilabelExactMatch(_AbstractExactMatch):
    """Multilabel exact match: a sample counts when all its labels match."""
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_stat_scores_arg_validation(num_labels, threshold, None, multidim_average, ignore_index)
        self.num_labels = num_labels
        self.threshold = threshold
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(multidim_average)

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        preds, target = self._inputs(preds, target)
        if self.validate_args:
            _multilabel_stat_scores_tensor_validation(preds, target, self.num_labels, self.multidim_average, self.ignore_index)
        preds, target = _multilabel_exact_match_format(preds, target, self.num_labels, self.threshold, self.ignore_index)
        self._update_state(*_multilabel_exact_match_update(preds, target, self.num_labels, self.multidim_average))


class ExactMatch(_ClassificationTaskWrapper):
    """Task-dispatching exact match (multiclass and multilabel)."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTaskNoBinary.from_str(task)
        kwargs.update({"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTaskNoBinary.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassExactMatch(num_classes, **kwargs)
        if task == ClassificationTaskNoBinary.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
            return MultilabelExactMatch(num_labels, threshold, **kwargs)
        raise ValueError(f"Not handled value: {task}")


__all__ = ["MulticlassExactMatch", "MultilabelExactMatch", "ExactMatch"]
