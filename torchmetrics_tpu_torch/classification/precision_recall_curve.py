# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""PrecisionRecallCurve module metrics (counterpart of
``torchmetrics_tpu/classification/precision_recall_curve.py``).

Two state modes, registered with the same ``add_state`` calls as JAX's, so
the ``state_spec`` fingerprints of the two packages match:

- **binned** (``thresholds`` given): the fixed-shape ``(T, ..., 2, 2)`` int32
  confusion tensor with ``dist_reduce_fx="sum"``, written each batch by
  kernel K1 in one launch (labels mode for multiclass, matrix mode for
  binary, micro and multilabel). The module asks once, at init, whether its
  grid ascends and whether K1's O(1) bin index is exact on it.
- **exact** (``thresholds=None``, the default): append-lists ``preds`` and
  ``target`` with ``dist_reduce_fx="cat"``. An update only appends (no host
  sync); compute concatenates them and builds the unique-threshold curve.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    CurveState,
    ThresholdsArg,
    _adjust_threshold_arg,
    _binned_curve_state,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
    _thresholds_ascend,
    _uniform_grid,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat
from torchmetrics_tpu_torch.utilities.enums import _task_call

Tensor = torch.Tensor


class _AbstractCurveMetric(Metric):
    """Shared state plumbing for the curve family."""

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    preds: List[Tensor]
    target: List[Tensor]
    confmat: Tensor
    thresholds: Optional[Tensor]

    def _create_curve_state(self, thresholds: ThresholdsArg, state_shape) -> None:
        """Fix the grid (``None``: the exact mode) and register the states.

        ``state_shape(T)`` is the binned state's shape for a grid of ``T``
        thresholds.
        """
        self.thresholds = _adjust_threshold_arg(thresholds, self.device)
        self._thresholds_ascend = _thresholds_ascend(self.thresholds)
        self._thresholds_affine = _uniform_grid(self.thresholds) if self._thresholds_ascend else None
        if self.thresholds is None:
            # the exact curve over every seen score: unbounded by its contract
            self.add_state("preds", [], dist_reduce_fx="cat")
            self.add_state("target", [], dist_reduce_fx="cat")
        else:
            self.add_state("confmat", torch.zeros(state_shape(len(self.thresholds)), dtype=torch.int32), dist_reduce_fx="sum")

    def _update_curve_state(self, state: CurveState) -> None:
        if isinstance(state, tuple):
            self.preds.append(state[0])
            self.target.append(state[1])
        else:
            self.confmat = self.confmat + state

    def _curve_state(self) -> CurveState:
        if self.thresholds is None:
            return dim_zero_cat(self.preds), dim_zero_cat(self.target)
        return self.confmat

    def _sliced_confmat(
        self, preds: Tensor, target: Tensor, labels: bool, cells: Tensor, num_cells: int, rows: int
    ) -> Dict[str, Tensor]:
        """The sliced plan's kernel route: the binned state of each cohort cell,
        ``(num_cells, *confmat)``, from K1s over formatted inputs whose
        ``rows`` batch rows each span ``len(preds) // rows`` entries."""
        per_row = preds.shape[0] // rows if rows else 0
        cells = cells[:, None].expand(rows, per_row).reshape(-1)  # each row's cell, for each of its entries
        state = _binned_curve_state(
            preds,
            target,
            self.thresholds,
            labels=labels,
            ascending=self._thresholds_ascend,
            affine=self._thresholds_affine,
            cells=cells,
            num_cells=num_cells,
        )
        return {"confmat": state.reshape((num_cells, *self.confmat.shape))}

    def to(self, device) -> "_AbstractCurveMetric":
        super().to(device)
        if self.thresholds is not None:
            self.thresholds = self.thresholds.to(self.device)
        return self


class BinaryPrecisionRecallCurve(_AbstractCurveMetric):
    """Binary precision-recall curve."""

    def __init__(
        self,
        thresholds: ThresholdsArg = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_curve_state(thresholds, lambda len_t: (len_t, 2, 2))

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        preds, target = self._inputs(preds, target)
        if self.validate_args:
            _binary_precision_recall_curve_tensor_validation(preds, target, self.ignore_index)
        preds, target, _ = _binary_precision_recall_curve_format(preds, target, self.thresholds, self.ignore_index)
        state = _binary_precision_recall_curve_update(
            preds, target, self.thresholds, self._thresholds_ascend, self._thresholds_affine
        )
        self._update_curve_state(state)

    def _sliced_fresh_states(self, cells: Tensor, num_cells: int, *batch: Any) -> Optional[Dict[str, Tensor]]:
        """The binned state per cohort cell from K1s (matrix mode), ``None``
        in the exact mode; equal bit for bit to the per-row updates (each
        row's sigmoid decided on its own) summed over each cell."""
        if self.thresholds is None or type(self).update is not BinaryPrecisionRecallCurve.update or len(batch) != 2:
            return None
        preds, target = self._inputs(*batch)
        if preds.ndim == 0:
            return None
        if self.validate_args:
            _binary_precision_recall_curve_tensor_validation(preds, target, self.ignore_index)
        rows = preds.shape[0]
        preds, target, _ = _binary_precision_recall_curve_format(preds, target, self.thresholds, self.ignore_index, rows=rows)
        return self._sliced_confmat(preds, target, False, cells, num_cells, rows)

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        """Compute the final curve."""
        return _binary_precision_recall_curve_compute(self._curve_state(), self.thresholds)

    def plot(self, curve: Optional[Tuple] = None, score: Any = None, ax: Any = None) -> Any:
        from torchmetrics_tpu_torch.utilities.plot import plot_curve

        curve = curve if curve is not None else self.compute()
        return plot_curve(curve, score=score, ax=ax, label_names=("Recall", "Precision"))


class MulticlassPrecisionRecallCurve(_AbstractCurveMetric):
    """Multiclass precision-recall curves."""

    def __init__(
        self,
        num_classes: int,
        thresholds: ThresholdsArg = None,
        average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index, average)
        self.num_classes = num_classes
        self.average = average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_curve_state(
            thresholds, lambda len_t: (len_t, 2, 2) if average == "micro" else (len_t, num_classes, 2, 2)
        )

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        preds, target = self._inputs(preds, target)
        if self.validate_args:
            _multiclass_precision_recall_curve_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        preds, target, _ = _multiclass_precision_recall_curve_format(
            preds, target, self.num_classes, self.thresholds, self.ignore_index, self.average
        )
        state = _multiclass_precision_recall_curve_update(
            preds, target, self.num_classes, self.thresholds, self.average, self._thresholds_ascend, self._thresholds_affine
        )
        self._update_curve_state(state)

    def _sliced_fresh_states(self, cells: Tensor, num_cells: int, *batch: Any) -> Optional[Dict[str, Tensor]]:
        """The binned state per cohort cell from K1s (labels mode; matrix
        mode for ``average="micro"``), ``None`` in the exact mode; equal bit
        for bit to the per-row updates (each row's softmax decided on its
        own) summed over each cell."""
        if self.thresholds is None or type(self).update is not MulticlassPrecisionRecallCurve.update or len(batch) != 2:
            return None
        preds, target = self._inputs(*batch)
        if self.validate_args:
            _multiclass_precision_recall_curve_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        rows = preds.shape[0]
        preds, target, _ = _multiclass_precision_recall_curve_format(
            preds, target, self.num_classes, self.thresholds, self.ignore_index, self.average, rows=rows
        )
        return self._sliced_confmat(preds, target, self.average != "micro", cells, num_cells, rows)

    def compute(self):
        """Compute the final per-class curves."""
        return _multiclass_precision_recall_curve_compute(self._curve_state(), self.num_classes, self.thresholds, self.average)

    def plot(self, curve: Optional[Tuple] = None, score: Any = None, ax: Any = None) -> Any:
        from torchmetrics_tpu_torch.utilities.plot import plot_curve

        curve = curve if curve is not None else self.compute()
        return plot_curve(curve, score=score, ax=ax, label_names=("Recall", "Precision"))


class MultilabelPrecisionRecallCurve(_AbstractCurveMetric):
    """Multilabel precision-recall curves; the binned state comes from K1's matrix mode."""

    def __init__(
        self,
        num_labels: int,
        thresholds: ThresholdsArg = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        self.num_labels = num_labels
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_curve_state(thresholds, lambda len_t: (len_t, num_labels, 2, 2))

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        preds, target = self._inputs(preds, target)
        if self.validate_args:
            _multilabel_precision_recall_curve_tensor_validation(preds, target, self.num_labels, self.ignore_index)
        preds, target, _ = _multilabel_precision_recall_curve_format(
            preds, target, self.num_labels, self.thresholds, self.ignore_index
        )
        state = _multilabel_precision_recall_curve_update(
            preds, target, self.num_labels, self.thresholds, self._thresholds_ascend, self._thresholds_affine
        )
        self._update_curve_state(state)

    def _sliced_fresh_states(self, cells: Tensor, num_cells: int, *batch: Any) -> Optional[Dict[str, Tensor]]:
        """The binned state per cohort cell from K1s (matrix mode), ``None``
        in the exact mode; equal bit for bit to the per-row updates (each
        row's sigmoid decided on its own) summed over each cell."""
        if self.thresholds is None or type(self).update is not MultilabelPrecisionRecallCurve.update or len(batch) != 2:
            return None
        preds, target = self._inputs(*batch)
        if self.validate_args:
            _multilabel_precision_recall_curve_tensor_validation(preds, target, self.num_labels, self.ignore_index)
        rows = preds.shape[0]
        preds, target, _ = _multilabel_precision_recall_curve_format(
            preds, target, self.num_labels, self.thresholds, self.ignore_index, rows=rows
        )
        return self._sliced_confmat(preds, target, False, cells, num_cells, rows)

    def compute(self):
        """Compute the final per-label curves."""
        return _multilabel_precision_recall_curve_compute(self._curve_state(), self.num_labels, self.thresholds, self.ignore_index)

    def plot(self, curve: Optional[Tuple] = None, score: Any = None, ax: Any = None) -> Any:
        from torchmetrics_tpu_torch.utilities.plot import plot_curve

        curve = curve if curve is not None else self.compute()
        return plot_curve(curve, score=score, ax=ax, label_names=("Recall", "Precision"))


class PrecisionRecallCurve(_ClassificationTaskWrapper):
    """Task-dispatching PrecisionRecallCurve."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: ThresholdsArg = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        return _task_call(
            task,
            num_classes,
            num_labels,
            lambda: BinaryPrecisionRecallCurve(**kwargs),
            lambda: MulticlassPrecisionRecallCurve(num_classes, **kwargs),
            lambda: MultilabelPrecisionRecallCurve(num_labels, **kwargs),
        )


__all__ = [
    "BinaryPrecisionRecallCurve",
    "MulticlassPrecisionRecallCurve",
    "MultilabelPrecisionRecallCurve",
    "PrecisionRecallCurve",
]
