# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Calibration error (counterpart of
``torchmetrics_tpu/functional/classification/calibration_error.py``).

A confidence falls in bin ``searchsorted(edges, c, right=True) - 1``
(clipped), the edges being ``jnp.linspace(0, 1, n_bins + 1)`` bit for bit
(:func:`_bin_edges`), so a confidence on an edge lands in JAX's bin.
Ignored positions carry the confidence 2.0, outside every bin. The per-bin
sums are masked column sums of an ``(N, n_bins)`` selection, in place of
the JAX package's ``x @ onehot``: a reduction, not a matmul, so TF32 never
applies, and no float atomics, so the same stream gives the same bits on
every run, eager or captured. The count sums ones and is exact in float32
up to 2^24 per bin; the two float sums add in another order than XLA's
(a budget the tests state).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_tensor_validation,
)
from torchmetrics_tpu_torch.utilities.compute import _safe_divide, normalize_logits_if_needed
from torchmetrics_tpu_torch.utilities.data import _float32_inputs, _to_tensors
from torchmetrics_tpu_torch.utilities.enums import _literal_task_call

Tensor = torch.Tensor
_NORMS = ("l1", "l2", "max")


def _check_norm(norm: str) -> None:
    if norm not in _NORMS:
        raise ValueError(f"Argument `norm` is expected to be one of 'l1', 'l2', 'max' but got {norm}")


def _bin_edges(n_bins: int, device: Union[str, torch.device, None] = None) -> Tensor:
    """``jnp.linspace(0, 1, n_bins + 1)`` in float32, bit for bit, built on
    ``device`` with device ops only (so a CUDA graph can capture it): on the
    unit range every point but the last is ``i * r`` rounded once, ``r`` the
    float32 reciprocal of ``n_bins`` (see :func:`_linspace_like_jax`), and the
    last is 1."""
    recip = float(np.float32(1.0) / np.float32(n_bins))
    head = torch.arange(n_bins, dtype=torch.float32, device=device) * recip
    return torch.cat([head, torch.ones(1, dtype=torch.float32, device=device)])


def _bin_sums(confidences: Tensor, accuracies: Tensor, bin_boundaries: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-bin ``(conf_sum, acc_sum, count)`` of the valid confidences (in [0, 1])."""
    n_bins = bin_boundaries.shape[0] - 1
    valid = (confidences >= 0) & (confidences <= 1)
    idx = torch.searchsorted(bin_boundaries.contiguous(), confidences.contiguous(), right=True) - 1
    bins = torch.arange(n_bins, device=confidences.device)
    member = (idx.clamp(0, n_bins - 1)[:, None] == bins[None, :]) & valid[:, None]  # (N, n_bins)
    count = member.sum(0, dtype=torch.int32).to(confidences.dtype)
    conf_sum = torch.where(member, confidences[:, None], 0.0).sum(0)
    acc_sum = torch.where(member, accuracies.to(confidences.dtype)[:, None], 0.0).sum(0)
    return conf_sum, acc_sum, count


def _binning_bucketize(confidences: Tensor, accuracies: Tensor, bin_boundaries: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-bin mean accuracy and confidence, and the bins' proportions of the valid confidences."""
    conf_sum, acc_sum, count = _bin_sums(confidences, accuracies, bin_boundaries)
    return _safe_divide(acc_sum, count), _safe_divide(conf_sum, count), count / count.sum()


def _ce_from_bins(acc_bin: Tensor, conf_bin: Tensor, prop_bin: Tensor, norm: str, debias: bool, n_valid: Tensor) -> Tensor:
    """The norm over per-bin means and proportions (with the ``l2`` debias term)."""
    if norm == "l1":
        return torch.sum(torch.abs(acc_bin - conf_bin) * prop_bin)
    if norm == "max":
        return torch.max(torch.abs(acc_bin - conf_bin))
    ce = torch.sum((acc_bin - conf_bin) ** 2 * prop_bin)
    if debias:
        debias_bins = (acc_bin * (acc_bin - 1) * prop_bin) / (prop_bin * n_valid - 1)
        ce = ce + torch.sum(torch.nan_to_num(debias_bins))
    return torch.where(ce > 0, torch.sqrt(torch.clamp(ce, min=0.0)), 0.0)


def _ce_compute(
    confidences: Tensor,
    accuracies: Tensor,
    bin_boundaries: Union[Tensor, int],
    norm: str = "l1",
    debias: bool = False,
) -> Tensor:
    """Calibration error of the confidences and accuracies of a whole stream."""
    if isinstance(bin_boundaries, int):
        bin_boundaries = _bin_edges(bin_boundaries, confidences.device).to(confidences.dtype)
    _check_norm(norm)
    acc_bin, conf_bin, prop_bin = _binning_bucketize(confidences, accuracies, bin_boundaries)
    n_valid = ((confidences >= 0) & (confidences <= 1)).sum(dtype=torch.int32)
    return _ce_from_bins(acc_bin, conf_bin, prop_bin, norm, debias, n_valid)


def _binning_update(confidences: Tensor, accuracies: Tensor, n_bins: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-bin ``(conf_sum, acc_sum, count)`` of one batch: bin membership is
    decided per sample, so summing per bin at update and dividing at compute
    bins like the whole stream at once, in ``(n_bins,)`` states."""
    return _bin_sums(confidences, accuracies, _bin_edges(n_bins, confidences.device).to(confidences.dtype))


def _ce_compute_binned(conf_sum: Tensor, acc_sum: Tensor, count: Tensor, norm: str = "l1", debias: bool = False) -> Tensor:
    """Calibration error from accumulated per-bin sums (:func:`_binning_update`)."""
    _check_norm(norm)
    n_valid = count.sum()
    return _ce_from_bins(_safe_divide(acc_sum, count), _safe_divide(conf_sum, count), count / n_valid, norm, debias, n_valid)


def _binary_calibration_error_arg_validation(n_bins: int, norm: str = "l1", ignore_index: Optional[int] = None) -> None:
    """Validate non-tensor args."""
    if not isinstance(n_bins, int) or n_bins < 1:
        raise ValueError(f"Expected argument `n_bins` to be an integer larger than 0, but got {n_bins}")
    _check_norm(norm)
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _check_float_preds(preds: Tensor) -> None:
    if not preds.is_floating_point():
        raise ValueError(
            "Expected argument `preds` to be floating tensor with probabilities/logits but got tensor with dtype"
            f" {str(preds.dtype).replace('torch.', '')}"
        )


def _binary_calibration_error_tensor_validation(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> None:
    """Validate input tensors (reads values back to the host, unless capturing)."""
    _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    _check_float_preds(preds)


def _binary_calibration_error_format(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """Flatten and sigmoid-normalize; ignored targets become -1."""
    preds = normalize_logits_if_needed(_float32_inputs(preds).reshape(-1), "sigmoid")
    target = target.reshape(-1)
    if ignore_index is not None:
        target = torch.where(target == ignore_index, -1, target)
    return preds, target


def _binary_calibration_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """The positive-class probability as the confidence, the target as the
    accuracy; an ignored position (target -1) gets the confidence 2.0, which
    falls in no bin."""
    valid = target >= 0
    confidences = torch.where(valid, preds, 2.0)
    accuracies = torch.where(valid, target, 0).to(preds.dtype)
    return confidences, accuracies


def binary_calibration_error(
    preds: Tensor,
    target: Tensor,
    n_bins: int = 15,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Binary expected calibration error."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)
        _binary_calibration_error_tensor_validation(preds, target, ignore_index)
    preds, target = _binary_calibration_error_format(preds, target, ignore_index)
    confidences, accuracies = _binary_calibration_error_update(preds, target)
    return _ce_compute(confidences, accuracies, n_bins, norm)


def _multiclass_calibration_error_arg_validation(
    num_classes: int, n_bins: int, norm: str = "l1", ignore_index: Optional[int] = None
) -> None:
    """Validate non-tensor args."""
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)


def _multiclass_calibration_error_tensor_validation(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    """Validate input tensors (reads values back to the host, unless capturing)."""
    _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    _check_float_preds(preds)


def _multiclass_calibration_error_format(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """Class dim last and flattened to ``(M, C)``; softmax-normalized; ignored targets become -1."""
    preds = _float32_inputs(preds)
    if preds.ndim > 2:
        preds = torch.movedim(preds, 1, -1).reshape(-1, preds.shape[1])
        target = target.reshape(-1)
    preds = normalize_logits_if_needed(preds, "softmax")
    if ignore_index is not None:
        target = torch.where(target == ignore_index, -1, target)
    return preds, target


def _multiclass_calibration_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Top-1 confidence and accuracy per sample; an ignored sample gets the
    confidence 2.0, which falls in no bin."""
    valid = target >= 0
    confidences = torch.where(valid, torch.amax(preds, dim=-1), 2.0)
    accuracies = (valid & (torch.argmax(preds, dim=-1) == target)).to(torch.float32)
    return confidences.to(torch.float32), accuracies


def multiclass_calibration_error(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    n_bins: int = 15,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multiclass expected calibration error."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _multiclass_calibration_error_arg_validation(num_classes, n_bins, norm, ignore_index)
        _multiclass_calibration_error_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target = _multiclass_calibration_error_format(preds, target, ignore_index)
    confidences, accuracies = _multiclass_calibration_error_update(preds, target)
    return _ce_compute(confidences, accuracies, n_bins, norm)


def calibration_error(
    preds: Tensor,
    target: Tensor,
    task: str,
    n_bins: int = 15,
    norm: str = "l1",
    num_classes: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching calibration error."""
    return _literal_task_call(
        task,
        num_classes,
        None,
        lambda: binary_calibration_error(preds, target, n_bins, norm, ignore_index, validate_args),
        lambda: multiclass_calibration_error(preds, target, num_classes, n_bins, norm, ignore_index, validate_args),
    )
