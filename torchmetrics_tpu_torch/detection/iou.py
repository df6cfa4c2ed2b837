# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""IoU-family module metrics (counterpart of ``torchmetrics_tpu/detection/iou.py``).

One base class parameterized by the pairwise matrix of
:mod:`~torchmetrics_tpu_torch.functional.detection.helpers`. The states are
the JAX package's list states: each image's ground-truth labels (int32)
and its pairwise matrix (float32), on the metric's device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from torchmetrics_tpu_torch.functional.detection.helpers import (
    _input_validator,
    box_convert,
    box_iou,
    complete_box_iou,
    distance_box_iou,
    generalized_box_iou,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import _jnp_dtype, _to_tensor

Tensor = torch.Tensor

_ALLOWED_BOX_FORMATS = ("xyxy", "xywh", "cxcywh")


class IntersectionOverUnion(Metric):
    """Intersection over union of detection boxes.

    Input: per-image dicts with ``boxes``/``labels`` (``scores`` ignored).
    Output: ``{"iou": scalar}``, plus an entry per ground-truth class with
    ``class_metrics``.
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = True
    full_state_update: bool = True

    _iou_type: str = "iou"
    _invalid_val: float = -1.0
    _kernel: staticmethod = staticmethod(box_iou)

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_threshold: Optional[float] = None,
        class_metrics: bool = False,
        respect_labels: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if box_format not in _ALLOWED_BOX_FORMATS:
            raise ValueError(f"Expected argument `box_format` to be one of {_ALLOWED_BOX_FORMATS} but got {box_format}")
        self.box_format = box_format
        self.iou_threshold = iou_threshold
        if not isinstance(class_metrics, bool):
            raise ValueError("Expected argument `class_metrics` to be a boolean")
        self.class_metrics = class_metrics
        if not isinstance(respect_labels, bool):
            raise ValueError("Expected argument `respect_labels` to be a boolean")
        self.respect_labels = respect_labels
        self.add_state("groundtruth_labels", default=[], dist_reduce_fx=None)
        self.add_state("iou_matrix", default=[], dist_reduce_fx=None)

    def update(self, preds: Sequence[Dict[str, Tensor]], target: Sequence[Dict[str, Tensor]]) -> None:
        """Append each image's pairwise matrix, with pairs below the
        threshold or of other labels set to the invalid value."""
        _input_validator(preds, target, ignore_score=True)
        invalid = torch.tensor(self._invalid_val, dtype=torch.float32, device=self._device)
        for p, t in zip(preds, target):
            det_boxes = self._get_safe_item_values(p["boxes"])
            gt_boxes = self._get_safe_item_values(t["boxes"])
            t_labels = _jnp_dtype(_to_tensor(t["labels"], self._device)).reshape(-1)
            p_labels = _jnp_dtype(_to_tensor(p["labels"], self._device)).reshape(-1)
            self.groundtruth_labels.append(t_labels)
            mat = self._kernel(det_boxes, gt_boxes)
            if self.iou_threshold is not None:
                mat = torch.where(mat < self.iou_threshold, invalid, mat)
            if self.respect_labels:
                mat = torch.where(p_labels[:, None] == t_labels[None, :], mat, invalid)
            self.iou_matrix.append(mat)

    def _get_safe_item_values(self, boxes: Any) -> Tensor:
        boxes = _to_tensor(boxes, self._device).to(torch.float32)
        if boxes.numel() > 0:
            boxes = box_convert(boxes, in_fmt=self.box_format, out_fmt="xyxy")
        return boxes.reshape(-1, 4)

    def compute(self) -> Dict[str, Tensor]:
        """The mean over the valid pairs (summed in float64), and per class over their columns."""
        if self.iou_matrix:
            flat = torch.cat([m.reshape(-1) for m in self.iou_matrix])
        else:
            flat = torch.zeros(0, dtype=torch.float32, device=self._device)
        keep = flat != self._invalid_val
        total = torch.where(keep, flat, 0.0).to(torch.float64).sum()
        count = keep.sum()
        score = torch.where(count > 0, total / count.clamp(min=1), 0.0).to(torch.float32)
        results: Dict[str, Tensor] = {f"{self._iou_type}": score}
        if self.class_metrics:
            if self.groundtruth_labels:
                labels = torch.cat([lab.reshape(-1) for lab in self.groundtruth_labels])
                col_labels = torch.cat([lab.reshape(1, -1).expand(m.shape[0], -1).reshape(-1)
                                        for m, lab in zip(self.iou_matrix, self.groundtruth_labels)])
            else:
                labels = col_labels = torch.zeros(0, dtype=torch.int32, device=self._device)
            classes = torch.unique(labels)
            slot = torch.searchsorted(classes, col_labels)  # each entry's ground-truth class
            sums = torch.zeros(classes.numel(), dtype=torch.float64, device=flat.device)
            sums.index_add_(0, slot, torch.where(keep, flat, 0.0).to(torch.float64))
            counts = torch.zeros(classes.numel(), dtype=torch.int64, device=flat.device).index_add_(0, slot, keep.to(torch.int64))
            per_class = torch.where(counts > 0, sums / counts.clamp(min=1), 0.0).to(torch.float32)
            for i, cl in enumerate(classes.tolist()):
                results[f"{self._iou_type}/cl_{int(cl)}"] = per_class[i]
        return results

    def plot(self, val=None, ax=None):
        return self._plot(val, ax)


class GeneralizedIntersectionOverUnion(IntersectionOverUnion):
    """GIoU of detection boxes."""

    _iou_type = "giou"
    _invalid_val = -1.5  # GIoU lies in (-1, 1], so -1 is a valid value
    _kernel = staticmethod(generalized_box_iou)


class DistanceIntersectionOverUnion(IntersectionOverUnion):
    """DIoU of detection boxes."""

    _iou_type = "diou"
    _invalid_val = -1.5
    _kernel = staticmethod(distance_box_iou)


class CompleteIntersectionOverUnion(IntersectionOverUnion):
    """CIoU of detection boxes."""

    _iou_type = "ciou"
    _invalid_val = -2.0
    _kernel = staticmethod(complete_box_iou)
