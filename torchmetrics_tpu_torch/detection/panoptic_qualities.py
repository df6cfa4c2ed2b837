# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Panoptic quality module metrics (counterpart of ``torchmetrics_tpu/detection/panoptic_qualities.py``)."""
from __future__ import annotations

from typing import Any, Collection

import torch

from torchmetrics_tpu_torch.functional.detection.panoptic_quality import (
    _get_category_id_to_continuous_id,
    _get_void_color,
    _host,
    _panoptic_quality_compute,
    _panoptic_quality_update,
    _parse_categories,
    _preprocess_inputs,
    _validate_inputs,
)
from torchmetrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class PanopticQuality(Metric):
    """Panoptic quality.

    Inputs: ``(B, *spatial, 2)`` int maps of ``(category_id, instance_id)``.
    States: per-category ``iou_sum`` (float32) and ``true_positives``/
    ``false_positives``/``false_negatives`` (int32) on the metric's device,
    reduced by ``"sum"``. The segment matching of a batch is host numpy.
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    _modified: bool = False

    def __init__(
        self,
        things: Collection[int],
        stuffs: Collection[int],
        allow_unknown_preds_category: bool = False,
        return_sq_and_rq: bool = False,
        return_per_class: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        things_p, stuffs_p = _parse_categories(things, stuffs)
        self.things = things_p
        self.stuffs = stuffs_p
        self.void_color = _get_void_color(things_p, stuffs_p)
        self.cat_id_to_continuous_id = _get_category_id_to_continuous_id(things_p, stuffs_p)
        self.allow_unknown_preds_category = allow_unknown_preds_category
        self.return_sq_and_rq = return_sq_and_rq
        self.return_per_class = return_per_class

        num_categories = len(things_p) + len(stuffs_p)
        self.add_state("iou_sum", default=torch.zeros(num_categories, dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("true_positives", default=torch.zeros(num_categories, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("false_positives", default=torch.zeros(num_categories, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("false_negatives", default=torch.zeros(num_categories, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Any, target: Any) -> None:
        """Fold a batch of maps into the states (the matching on the host, the sums on the device)."""
        _validate_inputs(preds, target)
        preds_f = _preprocess_inputs(
            self.things, self.stuffs, _host(preds), self.void_color, self.allow_unknown_preds_category
        )
        target_f = _preprocess_inputs(self.things, self.stuffs, _host(target), self.void_color, True)
        iou_sum, tp, fp, fn = _panoptic_quality_update(
            preds_f,
            target_f,
            self.cat_id_to_continuous_id,
            self.void_color,
            modified_metric_stuffs=self.stuffs if self._modified else None,
            device=self._device,
        )
        # the batch's sums in the states' dtypes (``set_dtype`` may have narrowed ``iou_sum``), as JAX casts them
        self.iou_sum = self.iou_sum + iou_sum.to(self.iou_sum.dtype)
        self.true_positives = self.true_positives + tp
        self.false_positives = self.false_positives + fp
        self.false_negatives = self.false_negatives + fn

    def compute(self) -> Tensor:
        """PQ (with SQ and RQ, per class, as asked) from the states."""
        pq, sq, rq, pq_avg, sq_avg, rq_avg = _panoptic_quality_compute(
            self.iou_sum, self.true_positives, self.false_positives, self.false_negatives
        )
        if self.return_per_class:
            if self.return_sq_and_rq:
                return torch.stack([pq, sq, rq], -1)
            return pq[None, :]
        if self.return_sq_and_rq:
            return torch.stack([pq_avg, sq_avg, rq_avg])
        return pq_avg

    def plot(self, val=None, ax=None):
        return self._plot(val, ax)


class ModifiedPanopticQuality(PanopticQuality):
    """Modified PQ: stuff segments match at IoU > 0 and count a true positive per target segment."""

    _modified = True
