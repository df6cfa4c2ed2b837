# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Nominal-association helpers (counterpart of ``torchmetrics_tpu/functional/nominal/utils.py``).

The contingency table is the port's confusion-matrix count
(``_multiclass_confusion_matrix_update``: the capture-safe ``_bincount``,
int32). Dropping NaN rows, dropping empty rows and columns of the table and
relabelling categories change shapes, so they read values on the host, as
the JAX package's do (eager by design).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.utilities.checks import _is_concrete
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor


def _nominal_input_validation(nan_strategy: str, nan_replace_value: Optional[float]) -> None:
    """Validate the NaN-handling arguments."""
    if nan_strategy not in ("replace", "drop"):
        raise ValueError(
            f"Argument `nan_strategy` is expected to be one of `['replace', 'drop']`, but got {nan_strategy}"
        )
    if nan_strategy == "replace" and not isinstance(nan_replace_value, (float, int)):
        raise ValueError(
            "Argument `nan_replace` is expected to be of a type `int` or `float` when `nan_strategy = 'replace`, "
            f"but got {nan_replace_value}"
        )


def _compute_expected_freqs(confmat: Tensor) -> Tensor:
    """Outer product of the margins over the total."""
    return torch.outer(confmat.sum(dim=1), confmat.sum(dim=0)) / confmat.sum()


def _compute_chi_squared(confmat: Tensor, bias_correction: bool) -> Tensor:
    """Chi-squared statistic, with Yates' correction at one degree of freedom."""
    expected_freqs = _compute_expected_freqs(confmat)
    df = expected_freqs.numel() - sum(expected_freqs.shape) + expected_freqs.ndim - 1
    if df == 0:
        return torch.tensor(0.0, device=confmat.device)
    if df == 1 and bias_correction:
        diff = expected_freqs - confmat
        direction = torch.sign(diff)
        confmat = confmat + direction * torch.clamp(torch.abs(diff), max=0.5)
    return torch.sum((confmat - expected_freqs) ** 2 / expected_freqs)


def _drop_empty_rows_and_cols(confmat: Tensor) -> Tensor:
    """Drop all-zero rows and columns (boolean selects: read on the host)."""
    confmat = confmat[confmat.sum(dim=1) != 0]
    return confmat[:, confmat.sum(dim=0) != 0]


def _compute_phi_squared_corrected(phi_squared: Tensor, num_rows: int, num_cols: int, confmat_sum: Tensor) -> Tensor:
    """Bias-corrected phi squared, at least 0 (NaN stays NaN, as ``jnp.maximum`` keeps it)."""
    return torch.clamp(phi_squared - ((num_rows - 1) * (num_cols - 1)) / (confmat_sum - 1), min=0.0)


def _compute_rows_and_cols_corrected(num_rows: int, num_cols: int, confmat_sum: Tensor) -> Tuple[Tensor, Tensor]:
    """Bias-corrected row and column counts."""
    rows_corrected = num_rows - (num_rows - 1) ** 2 / (confmat_sum - 1)
    cols_corrected = num_cols - (num_cols - 1) ** 2 / (confmat_sum - 1)
    return rows_corrected, cols_corrected


def _compute_bias_corrected_values(
    phi_squared: Tensor, num_rows: int, num_cols: int, confmat_sum: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Every bias-corrected quantity."""
    phi_squared_corrected = _compute_phi_squared_corrected(phi_squared, num_rows, num_cols, confmat_sum)
    rows_corrected, cols_corrected = _compute_rows_and_cols_corrected(num_rows, num_cols, confmat_sum)
    return phi_squared_corrected, rows_corrected, cols_corrected


def _handle_nan_in_data(
    preds: Tensor,
    target: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tuple[Tensor, Tensor]:
    """Replace NaNs (``nan_to_num``: infinities become the largest finite
    values, as in ``jnp``), or drop the rows holding one where either input
    is a float (a boolean select)."""
    if nan_strategy == "replace":
        return torch.nan_to_num(preds, nan=nan_replace_value), torch.nan_to_num(target, nan=nan_replace_value)
    if preds.is_floating_point() or target.is_floating_point():
        rows_contain_nan = torch.isnan(preds.to(torch.float32)) | torch.isnan(target.to(torch.float32))
        return preds[~rows_contain_nan], target[~rows_contain_nan]
    return preds, target


def _unable_to_use_bias_correction_warning(metric_name: str) -> None:
    """Warn about a degenerate bias correction."""
    rank_zero_warn(
        f"Unable to compute {metric_name} using bias correction. Please consider to set `bias_correction=False`."
    )


def _nominal_confmat(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """The shared update: argmax 2-D inputs (``torch.argmax``: the first
    maximum, a NaN first, as ``jnp.argmax``), handle NaNs, count the
    ``(C, C)`` int32 table. On concrete inputs a label outside
    ``0..num_classes-1`` raises, as in JAX; the count would drop it."""
    from torchmetrics_tpu_torch.functional.classification.confusion_matrix import _multiclass_confusion_matrix_update

    preds = torch.argmax(preds, dim=1) if preds.ndim == 2 else preds
    target = torch.argmax(target, dim=1) if target.ndim == 2 else target
    preds, target = _handle_nan_in_data(preds, target, nan_strategy, nan_replace_value)
    if _is_concrete(preds) and _is_concrete(target):
        max_label = int(torch.maximum(preds.max(), target.max()))
        min_label = int(torch.minimum(preds.min(), target.min()))
        if max_label >= num_classes or min_label < 0:
            raise ValueError(
                f"Detected label values in [{min_label}, {max_label}] but `num_classes`={num_classes}; nominal"
                " metrics expect labels in 0..num_classes-1. Relabel the data or pass a larger `num_classes`."
            )
    return _multiclass_confusion_matrix_update(preds.to(torch.int32), target.to(torch.int32), num_classes)


def _relabel_nominal(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, int]:
    """Map the values of both variables onto ``0..K-1`` by their rank in the
    sorted union (``unique`` + ``searchsorted``, as in JAX)."""
    vals = torch.unique(torch.cat([preds.reshape(-1), target.reshape(-1)]))
    preds, target = preds.to(vals.dtype).contiguous(), target.to(vals.dtype).contiguous()
    return torch.searchsorted(vals, preds), torch.searchsorted(vals, target), int(vals.shape[0])
