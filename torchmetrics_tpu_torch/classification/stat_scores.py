# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""StatScores module metrics, binary, multiclass and multilabel (counterpart
of ``torchmetrics_tpu/classification/stat_scores.py``).

States are int32 tp/fp/tn/fn counters with ``dist_reduce_fx="sum"``
(scalar, or per class), or append-lists with ``"cat"`` for samplewise.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_compute,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
    _binary_stat_scores_update,
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_compute,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multiclass_stat_scores_update,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_compute,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
    _multilabel_stat_scores_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.ops.stat_counts import stat_counts_segmented
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat
from torchmetrics_tpu_torch.utilities.enums import ClassificationTask

Tensor = torch.Tensor


class _AbstractStatScores(Metric):
    """Shared state handling."""

    tp: Union[List[Tensor], Tensor]
    fp: Union[List[Tensor], Tensor]
    tn: Union[List[Tensor], Tensor]
    fn: Union[List[Tensor], Tensor]

    def _create_state(self, size: int, multidim_average: str = "global") -> None:
        """Init tp/fp/tn/fn states: fixed int32 tensors (global) or lists (samplewise)."""
        for name in ("tp", "fp", "tn", "fn"):
            if multidim_average == "samplewise":
                self.add_state(name, [], dist_reduce_fx="cat")
            else:
                self.add_state(name, torch.zeros(size if size > 1 else (), dtype=torch.int32), dist_reduce_fx="sum")

    def _update_state(self, tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> None:
        """Fold a batch of counts into the state (replacing, never writing into, the tensors)."""
        if isinstance(self.tp, list):
            self.tp.append(tp)
            self.fp.append(fp)
            self.tn.append(tn)
            self.fn.append(fn)
        else:
            self.tp = self.tp + tp
            self.fp = self.fp + fp
            self.tn = self.tn + tn
            self.fn = self.fn + fn

    def _final_state(self) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        """Concatenate list states / return tensor states."""
        return dim_zero_cat(self.tp), dim_zero_cat(self.fp), dim_zero_cat(self.tn), dim_zero_cat(self.fn)


class BinaryStatScores(_AbstractStatScores):
    """Binary tp/fp/tn/fn."""

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        zero_division = kwargs.pop("zero_division", 0)
        super().__init__(**kwargs)
        if validate_args:
            _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index, zero_division)
        self.threshold = threshold
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.zero_division = zero_division
        self._create_state(size=1, multidim_average=multidim_average)

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        preds, target = self._inputs(preds, target)
        if self.validate_args:
            _binary_stat_scores_tensor_validation(preds, target, self.multidim_average, self.ignore_index)
        preds, target = _binary_stat_scores_format(preds, target, self.threshold, self.ignore_index)
        tp, fp, tn, fn = _binary_stat_scores_update(preds, target, self.multidim_average)
        self._update_state(tp, fp, tn, fn)

    def compute(self) -> Tensor:
        """Compute the final statistics."""
        tp, fp, tn, fn = self._final_state()
        return _binary_stat_scores_compute(tp, fp, tn, fn, self.multidim_average)


class MulticlassStatScores(_AbstractStatScores):
    """Multiclass tp/fp/tn/fn; kernel K2 counts them from the scores in one launch."""

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        num_classes: int,
        top_k: int = 1,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        zero_division = kwargs.pop("zero_division", 0)
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index, zero_division)
        self.num_classes = num_classes
        self.top_k = top_k
        self.average = average
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.zero_division = zero_division
        self._create_state(size=1 if (average == "micro" and top_k == 1) else num_classes, multidim_average=multidim_average)

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        preds, target = self._inputs(preds, target)
        if self.validate_args:
            _multiclass_stat_scores_tensor_validation(preds, target, self.num_classes, self.multidim_average, self.ignore_index)
        preds, target = _multiclass_stat_scores_format(preds, target, self.top_k, self.average, self.multidim_average)
        tp, fp, tn, fn = _multiclass_stat_scores_update(
            preds, target, self.num_classes, self.top_k, self.average, self.multidim_average, self.ignore_index
        )
        self._update_state(tp, fp, tn, fn)

    def compute(self) -> Tensor:
        """Compute the final statistics."""
        tp, fp, tn, fn = self._final_state()
        return _multiclass_stat_scores_compute(tp, fp, tn, fn, self.average, self.multidim_average)

    def _sliced_fresh_states(self, cells: Tensor, num_cells: int, *batch: Any) -> Optional[Dict[str, Tensor]]:
        """The sliced plan's kernel route: this batch's tp/fp/tn/fn per cohort
        cell, ``(num_cells, *state)``, from K2s (``ops.stat_counts_segmented``),
        where the update takes K2's bincount branch; ``None`` otherwise (the
        plan then runs the update per row under ``vmap``). Equal bit for bit
        to the per-row updates summed over each cell."""
        if type(self).update is not MulticlassStatScores.update or len(batch) != 2:
            return None
        if self.top_k != 1 or self.multidim_average != "global" or self.average == "micro":
            return None
        preds, target = self._inputs(*batch)
        if self.validate_args:
            _multiclass_stat_scores_tensor_validation(preds, target, self.num_classes, self.multidim_average, self.ignore_index)
        rows = preds.shape[0]
        preds, target = _multiclass_stat_scores_format(preds, target, self.top_k, self.average, self.multidim_average)
        if preds.ndim != target.ndim + 1:
            preds, target = preds.reshape(-1), target.reshape(-1)
        per_row = target.numel() // rows if rows else 0
        cells = cells[:, None].expand(rows, per_row).reshape(-1)  # each row's cell, for each of its entries
        counts = stat_counts_segmented(preds, target, cells, num_cells, self.num_classes, self.ignore_index)
        shape = (num_cells, *self.tp.shape)
        return {name: counts[:, i].reshape(shape) for i, name in enumerate(("tp", "fp", "tn", "fn"))}


class MultilabelStatScores(_AbstractStatScores):
    """Multilabel tp/fp/tn/fn per label (elementwise compares and int32 sums)."""

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        zero_division = kwargs.pop("zero_division", 0)
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index, zero_division)
        self.num_labels = num_labels
        self.threshold = threshold
        self.average = average
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.zero_division = zero_division
        self._create_state(size=num_labels, multidim_average=multidim_average)

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        preds, target = self._inputs(preds, target)
        if self.validate_args:
            _multilabel_stat_scores_tensor_validation(preds, target, self.num_labels, self.multidim_average, self.ignore_index)
        preds, target = _multilabel_stat_scores_format(preds, target, self.num_labels, self.threshold, self.ignore_index)
        tp, fp, tn, fn = _multilabel_stat_scores_update(preds, target, self.multidim_average)
        self._update_state(tp, fp, tn, fn)

    def compute(self) -> Tensor:
        """Compute the final statistics."""
        tp, fp, tn, fn = self._final_state()
        return _multilabel_stat_scores_compute(tp, fp, tn, fn, self.average, self.multidim_average)


class StatScores(_ClassificationTaskWrapper):
    """Task-dispatching StatScores."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "micro",
        multidim_average: str = "global",
        top_k: Optional[int] = 1,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update({"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryStatScores(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            if not isinstance(top_k, int):
                raise ValueError(f"`top_k` is expected to be `int` but `{type(top_k)} was passed.`")
            return MulticlassStatScores(num_classes, top_k, average, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
            return MultilabelStatScores(num_labels, threshold, average, **kwargs)
        raise ValueError(f"Not handled value: {task}")
