# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Dice score (counterpart of ``torchmetrics_tpu/functional/classification/dice.py``).

Dice is ``2 tp / (2 tp + fp + fn)`` over one-hot ``(N, C)`` predictions and
targets, averaged micro, macro, weighted, per sample or not at all.
``(N, C, ...)`` scores take a softmax (where some value lies outside
[0, 1]) and then ``torch.argmax``, as the JAX package does: two close
logits can tie exactly after the softmax where they did not before, so the
argmax is taken on the softmax, never on the raw scores (kernel K2's
argmax). ``top_k > 1`` takes :func:`select_topk`'s stable sort, which
keeps ``jax.lax.top_k``'s order among ties. The counts are int32 column
sums cast to float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.utilities.compute import _safe_divide, normalize_logits_if_needed
from torchmetrics_tpu_torch.utilities.data import _float32_inputs, _to_tensors, select_topk, to_onehot

Tensor = torch.Tensor
_I32 = torch.int32


def _dice_format(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    top_k: int = 1,
) -> Tuple[Tensor, Tensor]:
    """Inputs as int32 one-hot ``(N, C)`` prediction and target pairs.

    Binary probabilities or labels ``(N, ...)``, multiclass labels
    ``(N, ...)``, or multiclass scores ``(N, C, ...)`` (argmax or top-k).
    With ``num_classes=None`` and same-shape inputs the class count is read
    from the labels on the host, as in JAX.
    """
    if preds.ndim == target.ndim + 1:
        num_classes = preds.shape[1]
        probs = normalize_logits_if_needed(preds.to(torch.float32), "softmax")
        if preds.ndim > 2:
            probs = torch.movedim(probs, 1, -1).reshape(-1, num_classes)
            target = target.reshape(-1)
        if top_k == 1:
            preds_oh = to_onehot(torch.argmax(probs, dim=-1), num_classes)
        else:
            preds_oh = select_topk(probs, top_k, dim=1)
        return preds_oh.to(_I32), to_onehot(target.to(_I32), num_classes)
    preds = preds.reshape(preds.shape[0], -1) if preds.ndim > 1 else preds.reshape(-1)
    target = target.reshape(target.shape[0], -1) if target.ndim > 1 else target.reshape(-1)
    if preds.is_floating_point():
        preds = (normalize_logits_if_needed(_float32_inputs(preds), "sigmoid") >= threshold).to(_I32)
    if num_classes is None:
        max_label = int(torch.maximum(preds.max(), target.max()))
        if max_label > 1:
            num_classes = max_label + 1
    if num_classes is not None and num_classes >= 2:
        return to_onehot(preds.reshape(-1).to(_I32), num_classes), to_onehot(target.reshape(-1).to(_I32), num_classes)
    # binary: score the positive class only
    return preds.reshape(-1, 1).to(_I32), target.reshape(-1, 1).to(_I32)


def _dice_update(preds_oh: Tensor, target_oh: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-class tp, fp, fn (float32 of int32 sums). ``ignore_index`` drops a
    class column at compute, not samples."""
    tp = (preds_oh * target_oh).sum(0, dtype=_I32).to(torch.float32)
    fp = (preds_oh * (1 - target_oh)).sum(0, dtype=_I32).to(torch.float32)
    fn = ((1 - preds_oh) * target_oh).sum(0, dtype=_I32).to(torch.float32)
    return tp, fp, fn


def _keep_columns(n: int, ignore_index: Optional[int], device) -> Tensor:
    """The class columns that count: all but ``ignore_index``."""
    cols = torch.arange(n, device=device)
    return cols != ignore_index if ignore_index is not None else torch.ones(n, dtype=torch.bool, device=device)


def _dice_update_samplewise(
    preds_oh: Tensor, target_oh: Tensor, zero_division: float, ignore_index: Optional[int] = None
) -> Tuple[Tensor, Tensor]:
    """Summed per-sample dice and the sample count (``average='samples'``)."""
    if ignore_index is not None:
        keep = _keep_columns(preds_oh.shape[1], ignore_index, preds_oh.device)
        preds_oh = preds_oh * keep
        target_oh = target_oh * keep
    tp = (preds_oh * target_oh).sum(1, dtype=_I32).to(torch.float32)
    fp = (preds_oh * (1 - target_oh)).sum(1, dtype=_I32).to(torch.float32)
    fn = ((1 - preds_oh) * target_oh).sum(1, dtype=_I32).to(torch.float32)
    per_sample = _safe_divide(2 * tp, 2 * tp + fp + fn, zero_division)
    return per_sample.sum(), torch.full((), per_sample.shape[0], dtype=torch.float32, device=per_sample.device)


def _dice_compute(
    tp: Tensor,
    fp: Tensor,
    fn: Tensor,
    average: Optional[str] = "micro",
    zero_division: float = 0.0,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """Reduce per-class dice."""
    keep = _keep_columns(tp.shape[0], ignore_index, tp.device)
    if average == "micro":
        tp_s = torch.where(keep, tp, 0.0).sum()
        fp_s = torch.where(keep, fp, 0.0).sum()
        fn_s = torch.where(keep, fn, 0.0).sum()
        return _safe_divide(2 * tp_s, 2 * tp_s + fp_s + fn_s, zero_division)
    per_class = _safe_divide(2 * tp, 2 * tp + fp + fn, zero_division)
    if average in (None, "none"):
        return per_class
    if average == "macro":
        # classes with no support leave the mean
        keep_sup = keep & ((tp + fp + fn) > 0)
        return _safe_divide(torch.where(keep_sup, per_class, 0.0).sum(), keep_sup.sum(dtype=_I32), zero_division)
    if average == "weighted":
        weights = torch.where(keep, tp + fn, 0.0)
        return _safe_divide((per_class * weights).sum(), weights.sum(), zero_division)
    raise ValueError(
        f"Expected argument `average` to be one of 'micro', 'macro', 'weighted', 'samples', 'none' but got {average}"
    )


def dice(
    preds: Tensor,
    target: Tensor,
    zero_division: float = 0.0,
    average: Optional[str] = "micro",
    threshold: float = 0.5,
    top_k: int = 1,
    num_classes: Optional[int] = None,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """Dice score."""
    preds, target = _to_tensors(preds, target)
    preds_oh, target_oh = _dice_format(preds, target, threshold, num_classes, top_k)
    if average == "samples":
        total, count = _dice_update_samplewise(preds_oh, target_oh, zero_division, ignore_index)
        return total / count
    tp, fp, fn = _dice_update(preds_oh, target_oh)
    return _dice_compute(tp, fp, fn, average, zero_division, ignore_index)
