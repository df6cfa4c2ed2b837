# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Box geometry and detection input validation (counterpart of
``torchmetrics_tpu/functional/detection/helpers.py``).

``box_convert``, ``box_area``, the pairwise IoU with crowd columns and the
G/D/C-IoU matrices are plain PyTorch on the input's device, op for op the
JAX package's ``jnp`` expressions (so each product and sum rounds on its
own: XLA's CPU backend may contract ``a * b + c`` into one FMA, which puts
an ulp between the two packages' IoUs; the tests state that budget).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.utilities.data import _to_tensor

Tensor = torch.Tensor

_ALLOWED_BOX_FORMATS = ("xyxy", "xywh", "cxcywh")


def _as_tensor(x: Any, dtype: Union[torch.dtype, None] = None) -> Tensor:
    """A tensor where it lies, anything else on the card (see ``_to_tensor``); in ``dtype`` when given."""
    x = _to_tensor(x)
    return x if dtype is None else x.to(dtype)


def box_convert(boxes: Any, in_fmt: str, out_fmt: str) -> Tensor:
    """Convert boxes between ``xyxy``/``xywh``/``cxcywh`` formats."""
    if in_fmt not in _ALLOWED_BOX_FORMATS or out_fmt not in _ALLOWED_BOX_FORMATS:
        raise ValueError(f"Unsupported box format conversion {in_fmt} -> {out_fmt}")
    boxes = _as_tensor(boxes)
    if in_fmt == out_fmt:
        return boxes
    if in_fmt == "xywh":
        x, y, w, h = boxes.unbind(-1)
        xyxy = torch.stack([x, y, x + w, y + h], -1)
    elif in_fmt == "cxcywh":
        cx, cy, w, h = boxes.unbind(-1)
        xyxy = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    else:
        xyxy = boxes
    if out_fmt == "xyxy":
        return xyxy
    x1, y1, x2, y2 = xyxy.unbind(-1)
    if out_fmt == "xywh":
        return torch.stack([x1, y1, x2 - x1, y2 - y1], -1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def box_area(boxes: Any) -> Tensor:
    """Area of ``xyxy`` boxes."""
    boxes = _as_tensor(boxes)
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def _pairwise_intersection(preds: Tensor, target: Tensor) -> Tensor:
    """Intersection areas of every (pred, target) pair of ``xyxy`` boxes."""
    lt = torch.maximum(preds[..., :, None, :2], target[..., None, :, :2])
    rb = torch.minimum(preds[..., :, None, 2:], target[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    return wh[..., 0] * wh[..., 1]


def _iou_and_union(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    inter = _pairwise_intersection(preds, target)
    union = box_area(preds)[..., :, None] + box_area(target)[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0), union


def box_iou(preds: Any, target: Any, iscrowd: Any = None) -> Tensor:
    """Pairwise IoU matrix ``(N, M)`` between ``xyxy`` boxes.

    ``iscrowd`` (``(M,)`` bool) makes a column a COCO crowd region: its IoU
    is the intersection over the prediction's area.
    """
    preds = _as_tensor(preds, torch.float32)
    target = _to_tensor(target, preds.device).to(torch.float32)
    inter = _pairwise_intersection(preds, target)
    area_p = box_area(preds)[..., :, None]
    area_t = box_area(target)[..., None, :]
    union = area_p + area_t - inter
    if iscrowd is not None:
        crowd = _to_tensor(iscrowd, preds.device).to(torch.bool)
        union = torch.where(crowd[..., None, :], area_p * torch.ones_like(union), union)
    return torch.where(union > 0, inter / union, 0.0)


def _hull(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    lt = torch.minimum(preds[..., :, None, :2], target[..., None, :, :2])
    rb = torch.maximum(preds[..., :, None, 2:], target[..., None, :, 2:])
    return lt, rb


def generalized_box_iou(preds: Any, target: Any) -> Tensor:
    """Pairwise GIoU matrix: IoU - (hull - union) / hull."""
    preds = _as_tensor(preds, torch.float32)
    target = _to_tensor(target, preds.device).to(torch.float32)
    iou, union = _iou_and_union(preds, target)
    lt, rb = _hull(preds, target)
    wh = torch.clamp(rb - lt, min=0.0)
    hull = wh[..., 0] * wh[..., 1]
    return iou - torch.where(hull > 0, (hull - union) / hull, 0.0)


def distance_box_iou(preds: Any, target: Any) -> Tensor:
    """Pairwise DIoU: IoU - center distance² / hull diagonal²."""
    preds = _as_tensor(preds, torch.float32)
    target = _to_tensor(target, preds.device).to(torch.float32)
    iou, _ = _iou_and_union(preds, target)
    lt, rb = _hull(preds, target)
    diag = torch.sum((rb - lt) ** 2, -1)
    cp = (preds[..., :, None, :2] + preds[..., :, None, 2:]) / 2
    ct = (target[..., None, :, :2] + target[..., None, :, 2:]) / 2
    dist = torch.sum((cp - ct) ** 2, -1)
    return iou - torch.where(diag > 0, dist / diag, 0.0)


def complete_box_iou(preds: Any, target: Any, eps: float = 1e-7) -> Tensor:
    """Pairwise CIoU: DIoU - the aspect-ratio consistency term."""
    preds = _as_tensor(preds, torch.float32)
    target = _to_tensor(target, preds.device).to(torch.float32)
    diou = distance_box_iou(preds, target)
    iou, _ = _iou_and_union(preds, target)
    wp = preds[..., 2] - preds[..., 0]
    hp = preds[..., 3] - preds[..., 1]
    wt = target[..., 2] - target[..., 0]
    ht = target[..., 3] - target[..., 1]
    v = (4 / (math.pi**2)) * (torch.atan(wt / (ht + eps))[..., None, :] - torch.atan(wp / (hp + eps))[..., :, None]) ** 2
    alpha = v / (1 - iou + v + eps)
    return diou - alpha * v


def _fix_empty_arrays(boxes: np.ndarray) -> np.ndarray:
    """Give a degenerate empty box array a ``(0, 4)`` shape."""
    boxes = np.asarray(boxes)
    if boxes.size == 0:
        return boxes.reshape(0, 4) if boxes.ndim != 1 or boxes.shape[0] == 0 else boxes
    return boxes


def _first_dim(x: Any) -> int:
    """``np.asarray(x).shape[0]`` of an input, without copying a tensor off its device."""
    return x.shape[0] if isinstance(x, torch.Tensor) else np.asarray(x).shape[0]


def _input_validator(
    preds: Sequence[Dict[str, Any]],
    targets: Sequence[Dict[str, Any]],
    iou_type: Union[str, Tuple[str, ...]] = "bbox",
    ignore_score: bool = False,
) -> None:
    """Validate the list-of-dicts detection input format, with the JAX package's messages."""
    if isinstance(iou_type, str):
        iou_type = (iou_type,)
    name_map = {"bbox": "boxes", "segm": "masks"}
    if any(tp not in name_map for tp in iou_type):
        raise Exception(f"IOU type {iou_type} is not supported")
    item_val_name = [name_map[tp] for tp in iou_type]

    if not isinstance(preds, Sequence):
        raise ValueError(f"Expected argument `preds` to be of type Sequence, but got {preds}")
    if not isinstance(targets, Sequence):
        raise ValueError(f"Expected argument `target` to be of type Sequence, but got {targets}")
    if len(preds) != len(targets):
        raise ValueError(
            f"Expected argument `preds` and `target` to have the same length, but got {len(preds)} and {len(targets)}"
        )
    for k in [*item_val_name, "labels"] + ([] if ignore_score else ["scores"]):
        if any(k not in p for p in preds):
            raise ValueError(f"Expected all dicts in `preds` to contain the `{k}` key")
    for k in [*item_val_name, "labels"]:
        if any(k not in p for p in targets):
            raise ValueError(f"Expected all dicts in `target` to contain the `{k}` key")
    for i, item in enumerate(targets):
        for ivn in item_val_name:
            if _first_dim(item[ivn]) != _first_dim(item["labels"]):
                raise ValueError(
                    f"Input '{ivn}' and labels of sample {i} in targets have a"
                    f" different length (expected {_first_dim(item[ivn])} labels,"
                    f" got {_first_dim(item['labels'])})"
                )
    if ignore_score:
        return
    for i, item in enumerate(preds):
        for ivn in item_val_name:
            if not (_first_dim(item[ivn]) == _first_dim(item["labels"]) == _first_dim(item["scores"])):
                raise ValueError(
                    f"Input '{ivn}', labels and scores of sample {i} in predictions have a"
                    f" different length (expected {_first_dim(item[ivn])} labels and scores,"
                    f" got {_first_dim(item['labels'])} labels"
                    f" and {_first_dim(item['scores'])} scores)"
                )


def _validate_iou_type_arg(iou_type: Union[str, Tuple[str, ...]] = "bbox") -> Tuple[str, ...]:
    """Validate the ``iou_type`` argument."""
    allowed_iou_types = ("segm", "bbox")
    if isinstance(iou_type, str):
        iou_type = (iou_type,)
    if any(tp not in allowed_iou_types for tp in iou_type):
        raise ValueError(
            f"Expected argument `iou_type` to be one of {allowed_iou_types} or a tuple of, but got {iou_type}"
        )
    return iou_type
