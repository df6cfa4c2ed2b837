# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Confusion matrices, binary, multiclass and multilabel (counterpart of
``torchmetrics_tpu/functional/classification/confusion_matrix.py``).

Every path counts ``target * C + preds`` style indices with
:func:`~torchmetrics_tpu_torch.utilities.data._bincount`, which keeps
``jnp.bincount``'s rules (a negative index counts in bin 0, one past the end
is dropped) and has a fixed output size, so a fused plan can capture it in a
CUDA graph. Ignored entries go to a trash bin past the matrix. The indices
are int32 arithmetic, which wraps as XLA's does: without ``ignore_index``
an out-of-range prediction lands in a neighbouring cell, as in JAX. The
argmax of scores is ``torch.argmax`` (the first maximum, a NaN before any
number, as ``jnp.argmax``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.utilities.checks import _check_binary_target, _check_same_shape, _is_concrete
from torchmetrics_tpu_torch.utilities.compute import normalize_logits_if_needed
from torchmetrics_tpu_torch.utilities.data import _bincount, _float32_inputs, _to_tensors
from torchmetrics_tpu_torch.utilities.enums import _task_call

Tensor = torch.Tensor
_I32 = torch.int32
_ALLOWED_NORMALIZE = ("true", "pred", "all", "none", None)


def _confusion_matrix_reduce(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    """Normalize over the true labels (rows), the predictions (columns) or all entries."""
    if normalize not in _ALLOWED_NORMALIZE:
        raise ValueError(f"Argument `normalize` needs to one of the following: {_ALLOWED_NORMALIZE}")
    if normalize is not None and normalize != "none":
        confmat = confmat.to(torch.float32)
        if normalize == "true":
            confmat = confmat / confmat.sum(dim=-1, keepdim=True)
        elif normalize == "pred":
            confmat = confmat / confmat.sum(dim=-2, keepdim=True)
        elif normalize == "all":
            confmat = confmat / confmat.sum(dim=(-2, -1), keepdim=True)
        confmat = torch.nan_to_num(confmat, nan=0.0)
    return confmat


def _check_normalize(normalize: Optional[str]) -> None:
    if normalize not in _ALLOWED_NORMALIZE:
        raise ValueError(f"Expected argument `normalize` to be one of {_ALLOWED_NORMALIZE}, but got {normalize}.")


def _check_ignore_index(ignore_index: Optional[int]) -> None:
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


# ---------------------------------------------------------------------- binary


def _binary_confusion_matrix_arg_validation(
    threshold: float = 0.5, ignore_index: Optional[int] = None, normalize: Optional[str] = None
) -> None:
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")
    _check_ignore_index(ignore_index)
    _check_normalize(normalize)


def _binary_confusion_matrix_tensor_validation(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> None:
    _check_same_shape(preds, target)
    if _is_concrete(target):
        _check_binary_target(target, ignore_index)
    if not preds.is_floating_point() and _is_concrete(preds) and not bool(torch.all((preds == 0) | (preds == 1))):
        raise RuntimeError("Detected non-binary integer predictions; pass a float tensor for probabilities/logits.")


def _binary_confusion_matrix_format(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    convert_to_labels: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Flatten; threshold probabilities (sigmoid first where some value lies
    outside [0, 1]); ignored targets become -1."""
    preds = preds.reshape(-1)
    target = target.reshape(-1).to(_I32)
    if preds.is_floating_point():
        preds = normalize_logits_if_needed(_float32_inputs(preds), "sigmoid")
        if convert_to_labels:
            preds = (preds > threshold).to(_I32)
    else:
        preds = preds.to(_I32)
    if ignore_index is not None:
        target = torch.where(target == ignore_index, torch.full_like(target, -1), target)
    return preds, target


def _binary_confusion_matrix_update(preds: Tensor, target: Tensor) -> Tensor:
    """The 2x2 int32 matrix; ignored entries go to the trash bin 4."""
    unique_mapping = torch.where(target >= 0, target * 2 + preds, torch.full_like(target, 4))
    return _bincount(unique_mapping, minlength=5)[:4].reshape(2, 2)


def _binary_confusion_matrix_compute(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    return _confusion_matrix_reduce(confmat, normalize)


def binary_confusion_matrix(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Binary confusion matrix, ``[[tn, fp], [fn, tp]]``."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    confmat = _binary_confusion_matrix_update(preds, target)
    return _binary_confusion_matrix_compute(confmat, normalize)


# ------------------------------------------------------------------ multiclass


def _multiclass_confusion_matrix_arg_validation(
    num_classes: int, ignore_index: Optional[int] = None, normalize: Optional[str] = None
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    _check_ignore_index(ignore_index)
    _check_normalize(normalize)


def _multiclass_confusion_matrix_tensor_validation(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    if preds.ndim == target.ndim + 1:
        if not preds.is_floating_point():
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if preds.shape[1] != num_classes:
            raise ValueError(
                "If `preds` have one dimension more than `target`, `preds.shape[1]` should be equal to number of classes."
            )
        if preds.shape[2:] != target.shape[1:]:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should be (N, C, ...), and the"
                " shape of `target` should be (N, ...)."
            )
    elif preds.ndim == target.ndim:
        _check_same_shape(preds, target)
    else:
        raise ValueError(
            "Either `preds` and `target` both should have the (same) shape (N, ...), or `target` should be (N, ...)"
            " and `preds` should be (N, C, ...)."
        )
    if _is_concrete(target):
        ok = (target >= 0) & (target < num_classes)
        if ignore_index is not None:
            ok = ok | (target == ignore_index)
        if not bool(torch.all(ok)):
            raise RuntimeError(
                f"Detected values in `target` outside the expected range [0, {num_classes - 1}]"
                + (f" (or ignore_index={ignore_index})" if ignore_index is not None else "")
                + f". Found values: {torch.unique(target)}."
            )
    if not preds.is_floating_point() and _is_concrete(preds) and not bool(torch.all((preds >= 0) & (preds < num_classes))):
        raise RuntimeError(
            f"Detected values in `preds` outside the expected range [0, {num_classes - 1}]. Found values: {torch.unique(preds)}."
        )


def _multiclass_confusion_matrix_format(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """The argmax of scores (float64 scores become float32 first, as
    ``jnp.asarray`` makes them); flat int32 predictions and targets."""
    if preds.ndim == target.ndim + 1:
        preds = torch.argmax(_float32_inputs(preds), dim=1)
    return preds.reshape(-1).to(_I32), target.reshape(-1).to(_I32)


def _multiclass_confusion_matrix_update(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> Tensor:
    """The C x C int32 matrix of ``target * C + preds``; with ``ignore_index``
    the predictions are clipped into the classes and ignored entries go to
    the trash bin ``C**2``."""
    c = num_classes
    if ignore_index is not None:
        unique_mapping = torch.where(target != ignore_index, target * c + preds.clamp(0, c - 1), torch.full_like(target, c * c))
        bins = _bincount(unique_mapping, minlength=c * c + 1)[: c * c]
    else:
        bins = _bincount(target * c + preds, minlength=c * c)
    return bins.reshape(c, c)


def _multiclass_confusion_matrix_compute(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    return _confusion_matrix_reduce(confmat, normalize)


def multiclass_confusion_matrix(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multiclass confusion matrix: rows are true classes, columns predicted ones."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target = _multiclass_confusion_matrix_format(preds, target)
    confmat = _multiclass_confusion_matrix_update(preds, target, num_classes, ignore_index)
    return _multiclass_confusion_matrix_compute(confmat, normalize)


# ------------------------------------------------------------------ multilabel


def _multilabel_confusion_matrix_arg_validation(
    num_labels: int, threshold: float = 0.5, ignore_index: Optional[int] = None, normalize: Optional[str] = None
) -> None:
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")
    _check_ignore_index(ignore_index)
    _check_normalize(normalize)


def _multilabel_confusion_matrix_tensor_validation(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> None:
    _check_same_shape(preds, target)
    if preds.ndim < 2 or preds.shape[1] != num_labels:
        raise ValueError(f"Expected both `preds` and `target` to have 2nd dimension equal to `num_labels`={num_labels}")
    if _is_concrete(target):
        _check_binary_target(target, ignore_index)


def _multilabel_confusion_matrix_format(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    should_threshold: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Flatten ``(N, L, ...)`` to ``(N * X, L)``, thresholding probabilities
    (sigmoid first where some value lies outside [0, 1]); ignored targets become -1."""
    if preds.is_floating_point():
        preds = normalize_logits_if_needed(_float32_inputs(preds), "sigmoid")
        if should_threshold:
            preds = (preds > threshold).to(_I32)
    else:
        preds = preds.to(_I32)
    preds = torch.movedim(preds.reshape(*preds.shape[:2], -1), 1, -1).reshape(-1, num_labels)
    target = torch.movedim(target.reshape(*target.shape[:2], -1), 1, -1).reshape(-1, num_labels).to(_I32)
    if ignore_index is not None:
        target = torch.where(target == ignore_index, torch.full_like(target, -1), target)
    return preds, target


def _multilabel_confusion_matrix_update(preds: Tensor, target: Tensor, num_labels: int) -> Tensor:
    """The (L, 2, 2) int32 matrices; ignored entries go to the trash bin ``4 * L``."""
    labels = torch.arange(num_labels, dtype=_I32, device=target.device)
    unique_mapping = labels[None, :] * 4 + target * 2 + preds
    unique_mapping = torch.where(target >= 0, unique_mapping, torch.full_like(unique_mapping, 4 * num_labels))
    return _bincount(unique_mapping, minlength=4 * num_labels + 1)[: 4 * num_labels].reshape(num_labels, 2, 2)


def _multilabel_confusion_matrix_compute(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    return _confusion_matrix_reduce(confmat, normalize)


def multilabel_confusion_matrix(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multilabel confusion matrices, shape ``(L, 2, 2)``."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index, normalize)
        _multilabel_confusion_matrix_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_confusion_matrix_format(preds, target, num_labels, threshold, ignore_index)
    confmat = _multilabel_confusion_matrix_update(preds, target, num_labels)
    return _multilabel_confusion_matrix_compute(confmat, normalize)


# ------------------------------------------------------------------- dispatch


def confusion_matrix(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching confusion matrix."""
    return _task_call(
        task,
        num_classes,
        num_labels,
        lambda: binary_confusion_matrix(preds, target, threshold, normalize, ignore_index, validate_args),
        lambda: multiclass_confusion_matrix(preds, target, num_classes, normalize, ignore_index, validate_args),
        lambda: multilabel_confusion_matrix(preds, target, num_labels, threshold, normalize, ignore_index, validate_args),
    )
