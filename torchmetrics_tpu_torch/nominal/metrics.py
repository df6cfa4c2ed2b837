# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Nominal module metrics (counterpart of ``torchmetrics_tpu/nominal/metrics.py``).

States: ``confmat``, a ``(C, C)`` float32 table that adds the int32 counts
of each batch (float32, as in JAX, so checkpoints cross), ``"sum"``-reduced;
``FleissKappa`` a ``cat`` list of int32 count tables.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.nominal.metrics import (
    _cramers_v_compute,
    _cramers_v_update,
    _fleiss_kappa_compute,
    _fleiss_kappa_update,
    _pearsons_contingency_coefficient_compute,
    _pearsons_contingency_coefficient_update,
    _theils_u_compute,
    _theils_u_update,
    _tschuprows_t_compute,
    _tschuprows_t_update,
)
from torchmetrics_tpu_torch.functional.nominal.utils import _nominal_input_validation
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import _jnp_dtype, _to_tensor, dim_zero_cat

Tensor = torch.Tensor


class _ConfmatNominalMetric(Metric):
    """The contingency-table state shared by the nominal metrics."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    _update_fn = None

    def __init__(
        self,
        num_classes: int,
        nan_strategy: str = "replace",
        nan_replace_value: Optional[float] = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(num_classes, int) or num_classes < 1:
            raise ValueError(f"Expected argument `num_classes` to be a positive integer, but got {num_classes}")
        _nominal_input_validation(nan_strategy, nan_replace_value)
        self.num_classes = num_classes
        self.nan_strategy = nan_strategy
        self.nan_replace_value = nan_replace_value
        self.add_state("confmat", torch.zeros((num_classes, num_classes)), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Fold the batch's contingency table into the state."""
        preds, target = self._inputs(preds, target)
        confmat = type(self)._update_fn(
            _jnp_dtype(preds), _jnp_dtype(target), self.num_classes, self.nan_strategy, self.nan_replace_value
        )
        self.confmat = self.confmat + confmat


class CramersV(_ConfmatNominalMetric):
    """Cramér's V."""

    _update_fn = staticmethod(_cramers_v_update)

    def __init__(self, num_classes: int, bias_correction: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes=num_classes, **kwargs)
        self.bias_correction = bias_correction

    def compute(self) -> Tensor:
        return _cramers_v_compute(self.confmat, self.bias_correction)


class PearsonsContingencyCoefficient(_ConfmatNominalMetric):
    """Pearson's contingency coefficient."""

    _update_fn = staticmethod(_pearsons_contingency_coefficient_update)

    def compute(self) -> Tensor:
        return _pearsons_contingency_coefficient_compute(self.confmat)


class TheilsU(_ConfmatNominalMetric):
    """Theil's U."""

    _update_fn = staticmethod(_theils_u_update)

    def compute(self) -> Tensor:
        return _theils_u_compute(self.confmat)


class TschuprowsT(_ConfmatNominalMetric):
    """Tschuprow's T."""

    _update_fn = staticmethod(_tschuprows_t_update)

    def __init__(self, num_classes: int, bias_correction: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes=num_classes, **kwargs)
        self.bias_correction = bias_correction

    def compute(self) -> Tensor:
        return _tschuprows_t_compute(self.confmat, self.bias_correction)


class FleissKappa(Metric):
    """Fleiss' kappa over every batch's ratings."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, mode: str = "counts", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if mode not in ("counts", "probs"):
            raise ValueError("Argument ``mode`` must be one of ['counts', 'probs'].")
        self.mode = mode
        self.add_state("counts", [], dist_reduce_fx="cat")

    def update(self, ratings: Tensor) -> None:
        """Append the batch's count table."""
        self.counts.append(_fleiss_kappa_update(_jnp_dtype(_to_tensor(ratings, self._device)), self.mode))

    def compute(self) -> Tensor:
        """Fleiss' kappa over the whole stream."""
        return _fleiss_kappa_compute(dim_zero_cat(self.counts))
