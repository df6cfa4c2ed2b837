# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Nominal association: Cramér's V, Pearson's contingency coefficient,
Theil's U, Tschuprow's T and Fleiss' kappa (counterpart of
``torchmetrics_tpu/functional/nominal/metrics.py``).

Each statistic is float32 arithmetic on the int32 contingency table; the
``*_matrix`` forms loop over pairs of columns on the host, as JAX's do.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.nominal.utils import (
    _compute_bias_corrected_values,
    _compute_chi_squared,
    _drop_empty_rows_and_cols,
    _handle_nan_in_data,
    _nominal_confmat,
    _nominal_input_validation,
    _relabel_nominal,
    _unable_to_use_bias_correction_warning,
)
from torchmetrics_tpu_torch.utilities.data import _jnp_dtype, _to_tensor, _to_tensors

Tensor = torch.Tensor


def _prepare_nominal(
    preds: Tensor, target: Tensor, nan_strategy: str, nan_replace_value: Optional[float]
) -> Tuple[Tensor, Tensor, int]:
    """Argmax 2-D inputs (their width is the class count); else handle NaNs
    in the labels and relabel the union of both variables' values onto
    ``0..K-1``, so any category ids fit the table."""
    if preds.ndim == 2 or target.ndim == 2:
        num_classes = preds.shape[1] if preds.ndim == 2 else target.shape[1]
        preds = torch.argmax(preds, dim=1) if preds.ndim == 2 else preds
        target = torch.argmax(target, dim=1) if target.ndim == 2 else target
        return preds, target, num_classes
    preds, target = _handle_nan_in_data(preds, target, nan_strategy, nan_replace_value)
    return _relabel_nominal(preds, target)


def _nominal_inputs(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Tensors beside each other, 64-bit narrowed as ``jnp.asarray`` narrows them."""
    preds, target = _to_tensors(preds, target)
    return _jnp_dtype(preds), _jnp_dtype(target)


def _pairs_matrix(matrix: Tensor, stat, symmetric: bool) -> Tensor:
    """The ``(V, V)`` float32 matrix of ``stat`` over pairs of columns, ones on the diagonal."""
    matrix = _jnp_dtype(_to_tensor(matrix))
    num_variables = matrix.shape[1]
    out = torch.ones((num_variables, num_variables), dtype=torch.float32, device=matrix.device)
    for i in range(num_variables):
        for j in range(i + 1 if symmetric else 0, num_variables):
            if i == j:
                continue
            v = stat(matrix[:, i], matrix[:, j])
            out[i, j] = v
            if symmetric:
                out[j, i] = v
    return out


# ------------------------------------------------------------------ Cramér's V
def _cramers_v_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """The contingency table."""
    return _nominal_confmat(preds, target, num_classes, nan_strategy, nan_replace_value)


def _cramers_v_compute(confmat: Tensor, bias_correction: bool) -> Tensor:
    """Cramér's V from the table; NaN, with a warning, where the bias
    correction degenerates (read on the host, as in JAX)."""
    confmat = _drop_empty_rows_and_cols(confmat)
    cm_sum = confmat.sum()
    chi_squared = _compute_chi_squared(confmat, bias_correction)
    phi_squared = chi_squared / cm_sum
    num_rows, num_cols = confmat.shape
    if bias_correction:
        phi_squared_corrected, rows_corrected, cols_corrected = _compute_bias_corrected_values(
            phi_squared, num_rows, num_cols, cm_sum
        )
        if bool(torch.minimum(rows_corrected, cols_corrected) == 1):
            _unable_to_use_bias_correction_warning(metric_name="Cramer's V")
            return torch.tensor(float("nan"), device=confmat.device)
        cramers_v_value = torch.sqrt(phi_squared_corrected / torch.minimum(rows_corrected - 1, cols_corrected - 1))
    else:
        cramers_v_value = torch.sqrt(phi_squared / min(num_rows - 1, num_cols - 1))
    return torch.clamp(cramers_v_value, 0.0, 1.0)


def cramers_v(
    preds: Tensor,
    target: Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Cramér's V between two categorical variables."""
    preds, target = _nominal_inputs(preds, target)
    _nominal_input_validation(nan_strategy, nan_replace_value)
    preds, target, num_classes = _prepare_nominal(preds, target, nan_strategy, nan_replace_value)
    confmat = _cramers_v_update(preds, target, num_classes, nan_strategy, nan_replace_value)
    return _cramers_v_compute(confmat, bias_correction)


def cramers_v_matrix(
    matrix: Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Cramér's V between every pair of columns."""
    return _pairs_matrix(
        matrix, lambda a, b: cramers_v(a, b, bias_correction, nan_strategy, nan_replace_value), symmetric=True
    )


# ---------------------------------------------- Pearson's contingency coefficient
def _pearsons_contingency_coefficient_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """The contingency table."""
    return _nominal_confmat(preds, target, num_classes, nan_strategy, nan_replace_value)


def _pearsons_contingency_coefficient_compute(confmat: Tensor) -> Tensor:
    """``sqrt(phi² / (1 + phi²))``."""
    confmat = _drop_empty_rows_and_cols(confmat)
    cm_sum = confmat.sum()
    chi_squared = _compute_chi_squared(confmat, bias_correction=False)
    phi_squared = chi_squared / cm_sum
    value = torch.sqrt(phi_squared / (1 + phi_squared))
    return torch.clamp(value, 0.0, 1.0)


def pearsons_contingency_coefficient(
    preds: Tensor,
    target: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Pearson's contingency coefficient between two categorical variables."""
    preds, target = _nominal_inputs(preds, target)
    _nominal_input_validation(nan_strategy, nan_replace_value)
    preds, target, num_classes = _prepare_nominal(preds, target, nan_strategy, nan_replace_value)
    confmat = _pearsons_contingency_coefficient_update(preds, target, num_classes, nan_strategy, nan_replace_value)
    return _pearsons_contingency_coefficient_compute(confmat)


def pearsons_contingency_coefficient_matrix(
    matrix: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Pearson's contingency coefficient between every pair of columns."""
    return _pairs_matrix(
        matrix, lambda a, b: pearsons_contingency_coefficient(a, b, nan_strategy, nan_replace_value), symmetric=True
    )


# ------------------------------------------------------------------- Theil's U
def _conditional_entropy_compute(confmat: Tensor) -> Tensor:
    """H(X|Y) from the table."""
    confmat = _drop_empty_rows_and_cols(confmat)
    total_occurrences = confmat.sum()
    p_xy_m = confmat / total_occurrences
    p_y = confmat.sum(dim=1) / total_occurrences
    p_y_m = p_y[:, None].expand(p_xy_m.shape)
    positive = p_xy_m > 0
    ratio = torch.where(positive, p_y_m / torch.where(positive, p_xy_m, torch.ones_like(p_xy_m)), torch.ones_like(p_xy_m))
    terms = p_xy_m * torch.log(ratio)
    return torch.where(positive, terms, torch.zeros_like(terms)).sum()


def _theils_u_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """The contingency table."""
    return _nominal_confmat(preds, target, num_classes, nan_strategy, nan_replace_value)


def _theils_u_compute(confmat: Tensor) -> Tensor:
    """``U = (H(X) - H(X|Y)) / H(X)``; 0 where H(X) is 0."""
    confmat = _drop_empty_rows_and_cols(confmat)
    s_xy = _conditional_entropy_compute(confmat)
    total_occurrences = confmat.sum()
    p_x = confmat.sum(dim=0) / total_occurrences
    positive = p_x > 0
    s_x = -torch.where(positive, p_x * torch.log(torch.where(positive, p_x, torch.ones_like(p_x))), torch.zeros_like(p_x)).sum()
    zero = s_x == 0
    return torch.where(zero, torch.zeros_like(s_x), (s_x - s_xy) / torch.where(zero, torch.ones_like(s_x), s_x))


def theils_u(
    preds: Tensor,
    target: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Theil's U (the uncertainty coefficient) of two categorical variables."""
    preds, target = _nominal_inputs(preds, target)
    _nominal_input_validation(nan_strategy, nan_replace_value)
    preds, target, num_classes = _prepare_nominal(preds, target, nan_strategy, nan_replace_value)
    confmat = _theils_u_update(preds, target, num_classes, nan_strategy, nan_replace_value)
    return _theils_u_compute(confmat)


def theils_u_matrix(
    matrix: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Theil's U between every ordered pair of columns (not symmetric)."""
    return _pairs_matrix(matrix, lambda a, b: theils_u(a, b, nan_strategy, nan_replace_value), symmetric=False)


# ---------------------------------------------------------------- Tschuprow's T
def _tschuprows_t_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """The contingency table."""
    return _nominal_confmat(preds, target, num_classes, nan_strategy, nan_replace_value)


def _tschuprows_t_compute(confmat: Tensor, bias_correction: bool) -> Tensor:
    """Tschuprow's T from the table; NaN, with a warning, where the bias
    correction degenerates."""
    confmat = _drop_empty_rows_and_cols(confmat)
    cm_sum = confmat.sum()
    chi_squared = _compute_chi_squared(confmat, bias_correction)
    phi_squared = chi_squared / cm_sum
    num_rows, num_cols = confmat.shape
    if bias_correction:
        phi_squared_corrected, rows_corrected, cols_corrected = _compute_bias_corrected_values(
            phi_squared, num_rows, num_cols, cm_sum
        )
        if bool(torch.minimum(rows_corrected, cols_corrected) == 1):
            _unable_to_use_bias_correction_warning(metric_name="Tschuprow's T")
            return torch.tensor(float("nan"), device=confmat.device)
        value = torch.sqrt(phi_squared_corrected / torch.sqrt((rows_corrected - 1) * (cols_corrected - 1)))
    else:
        dof = torch.tensor((num_rows - 1) * (num_cols - 1), dtype=torch.float32, device=confmat.device)
        value = torch.sqrt(phi_squared / torch.sqrt(dof))
    return torch.clamp(value, 0.0, 1.0)


def tschuprows_t(
    preds: Tensor,
    target: Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Tschuprow's T between two categorical variables."""
    preds, target = _nominal_inputs(preds, target)
    _nominal_input_validation(nan_strategy, nan_replace_value)
    preds, target, num_classes = _prepare_nominal(preds, target, nan_strategy, nan_replace_value)
    confmat = _tschuprows_t_update(preds, target, num_classes, nan_strategy, nan_replace_value)
    return _tschuprows_t_compute(confmat, bias_correction)


def tschuprows_t_matrix(
    matrix: Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Tschuprow's T between every pair of columns."""
    return _pairs_matrix(
        matrix, lambda a, b: tschuprows_t(a, b, bias_correction, nan_strategy, nan_replace_value), symmetric=True
    )


# ---------------------------------------------------------------- Fleiss' kappa
def _fleiss_kappa_update(ratings: Tensor, mode: str = "counts") -> Tensor:
    """Ratings as an ``(n_samples, n_categories)`` int32 count table: in
    ``"probs"`` mode each rater's argmax category counted."""
    if mode == "probs":
        if ratings.ndim != 3 or not ratings.is_floating_point():
            raise ValueError(
                "If argument ``mode`` is 'probs', ratings must have 3 dimensions with the format"
                " [n_samples, n_categories, n_raters] and be floating point."
            )
        n_categories = ratings.shape[1]
        rater_choice = torch.argmax(ratings, dim=1)  # (n_samples, n_raters)
        categories = torch.arange(n_categories, device=ratings.device)
        return (rater_choice[..., None] == categories).sum(dim=1, dtype=torch.int32)
    if mode == "counts" and (ratings.ndim != 2 or ratings.is_floating_point()):
        raise ValueError(
            "If argument ``mode`` is `counts`, ratings must have 2 dimensions with the format"
            " [n_samples, n_categories] and be none floating point."
        )
    return _jnp_dtype(ratings)


def _fleiss_kappa_compute(counts: Tensor) -> Tensor:
    """Fleiss' kappa from the count table (integer sums in ``counts``' dtype,
    as ``jnp`` keeps them; the rest float32)."""
    total = counts.shape[0]
    num_raters = counts.sum(dim=1, dtype=counts.dtype).max()
    p_i = counts.sum(dim=0, dtype=counts.dtype) / (total * num_raters)
    p_j = ((counts**2).sum(dim=1, dtype=counts.dtype) - num_raters) / (num_raters * (num_raters - 1))
    p_bar = p_j.mean()
    pe_bar = (p_i**2).sum()
    return (p_bar - pe_bar) / (1 - pe_bar + 1e-5)


def fleiss_kappa(ratings: Tensor, mode: str = "counts") -> Tensor:
    """Fleiss' kappa, the agreement of several raters."""
    if mode not in ("counts", "probs"):
        raise ValueError("Argument ``mode`` must be one of ['counts', 'probs'].")
    counts = _fleiss_kappa_update(_jnp_dtype(_to_tensor(ratings)), mode)
    return _fleiss_kappa_compute(counts)
