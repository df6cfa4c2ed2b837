# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""RetrievalMetric base (counterpart of ``torchmetrics_tpu/retrieval/base.py``).

``compute`` packs the queries into a dense ``(Q, Lmax)`` grid on the host
(numpy, queries in sorted-index order, each query's documents in arrival
order), moves it to the metric's device and runs the metric's row kernel
over every row at once (``functional/retrieval/metrics.py``), where JAX
``vmap``s a one-row kernel. The list states gather across ranks unreduced
(``dist_reduce_fx=None``), as in JAX.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.checks import _check_retrieval_inputs
from torchmetrics_tpu_torch.utilities.compute import _mean_last_in_xla_order
from torchmetrics_tpu_torch.utilities.data import _to_tensor, dim_zero_cat

Tensor = torch.Tensor


def _retrieval_aggregate(values: Tensor, aggregation: Union[str, Callable] = "mean", dim: Optional[int] = None) -> Tensor:
    """Aggregate per-query values; ``"median"`` takes the lower of the two
    middle values on an even count (``torch.median``'s rule, as JAX's). The
    mean of per-k curves over the queries adds each column in XLA's CPU
    order (``_mean_last_in_xla_order``): equal on every device, and JAX's
    bits up to 64 queries, so a recall at a fixed precision picks the same
    k where a precision lies at the threshold."""
    if aggregation == "mean":
        if dim == 0 and values.ndim == 2:  # the curves: one column per k, each summed alike
            return _mean_last_in_xla_order(values.T)
        return values.mean() if dim is None else values.mean(dim=dim)
    if aggregation == "median":
        v, axis = (values.reshape(-1), 0) if dim is None else (values, dim)
        k = max((v.shape[axis] - 1) // 2, 0)
        return torch.sort(v, dim=axis).values.select(axis, k)
    if aggregation == "min":
        return values.min() if dim is None else values.min(dim=dim).values
    if aggregation == "max":
        return values.max() if dim is None else values.max(dim=dim).values
    return aggregation(values, dim=dim)


def _pack_queries(indexes: Tensor, preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The flat ``(index, pred, target)`` stream as a dense ``(Q, Lmax)``
    grid on ``preds``' device: padded slots ``valid=False``, ``preds=-inf``,
    ``target=0``. The packing runs on the host in numpy, as JAX's does."""
    idx = indexes.cpu().numpy()
    order = np.argsort(idx, kind="stable")
    idx_sorted = idx[order]
    uniq, row = np.unique(idx_sorted, return_inverse=True)
    counts = np.bincount(row)
    q, lmax = len(uniq), int(counts.max()) if len(counts) else 0
    col = np.arange(len(idx_sorted)) - np.concatenate([[0], np.cumsum(counts)[:-1]])[row]

    preds_grid = np.full((q, lmax), -np.inf, dtype=np.float32)
    target_grid = np.zeros((q, lmax), dtype=np.float32)
    valid_grid = np.zeros((q, lmax), dtype=bool)
    preds_grid[row, col] = preds.cpu().numpy()[order]
    target_grid[row, col] = target.cpu().numpy()[order]
    valid_grid[row, col] = True
    device = preds.device
    return (
        torch.from_numpy(preds_grid).to(device),
        torch.from_numpy(target_grid).to(device),
        torch.from_numpy(valid_grid).to(device),
    )


class RetrievalMetric(Metric, ABC):
    """Base of the retrieval metrics.

    States: ``indexes`` (int32), ``preds`` (float32) and ``target`` lists,
    gathered across ranks unreduced. ``compute`` groups the documents by
    query and evaluates :meth:`_metric_rows` over the grid.
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        aggregation: Union[str, Callable] = "mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.allow_non_binary_target = False
        empty_target_action_options = ("error", "skip", "neg", "pos")
        if empty_target_action not in empty_target_action_options:
            raise ValueError(f"Argument `empty_target_action` received a wrong value `{empty_target_action}`.")
        self.empty_target_action = empty_target_action
        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError("Argument `ignore_index` must be an integer or None.")
        self.ignore_index = ignore_index
        if not (aggregation in ("mean", "median", "min", "max") or callable(aggregation)):
            raise ValueError(
                "Argument `aggregation` must be one of `mean`, `median`, `min`, `max` or a custom callable function"
                f"which takes tensor of values, but got {aggregation}."
            )
        self.aggregation = aggregation
        self.add_state("indexes", default=[], dist_reduce_fx=None)
        self.add_state("preds", default=[], dist_reduce_fx=None)
        self.add_state("target", default=[], dist_reduce_fx=None)

    def update(self, preds: Tensor, target: Tensor, indexes: Tensor) -> None:
        """Append the batch's flattened ``(indexes, preds, target)``."""
        if indexes is None:
            raise ValueError("Argument `indexes` cannot be None")
        indexes, preds, target = _check_retrieval_inputs(
            _to_tensor(indexes, self._device),
            _to_tensor(preds, self._device),
            _to_tensor(target, self._device),
            allow_non_binary_target=self.allow_non_binary_target,
            ignore_index=self.ignore_index,
        )
        self.indexes.append(indexes)
        self.preds.append(preds)
        self.target.append(target)

    def _apply_empty_action(self, values: Tensor, mask: Tensor, missing: str = "positive") -> Tensor:
        """The empty-target policy on per-query values, ``(Q,)`` or ``(Q, K)``;
        ``mask`` marks the queries that have the required kind of target."""
        if self.empty_target_action == "error" and bool((~mask).any()):
            raise ValueError(f"`compute` method was provided with a query with no {missing} target.")
        m = mask if values.ndim == 1 else mask[:, None]
        if self.empty_target_action == "pos":
            return torch.where(m, values, torch.ones_like(values))
        if self.empty_target_action == "neg":
            return torch.where(m, values, torch.zeros_like(values))
        if self.empty_target_action == "skip":
            return values[mask]
        return values

    def _grids(self) -> Tuple[Tensor, Tensor, Tensor]:
        return _pack_queries(dim_zero_cat(self.indexes), dim_zero_cat(self.preds), dim_zero_cat(self.target))

    def _aggregate(self, values: Tensor, mask: Tensor, missing: str = "positive") -> Tensor:
        values = self._apply_empty_action(values, mask, missing)
        if values.numel() == 0:
            return torch.tensor(0.0, device=values.device)
        return _retrieval_aggregate(values, self.aggregation)

    def compute(self) -> Tensor:
        """Group by query, evaluate the row kernel, apply the policy, aggregate."""
        preds_grid, target_grid, valid_grid = self._grids()
        values = self._metric_rows(preds_grid, target_grid, valid_grid)  # (Q,)
        return self._aggregate(values, ((target_grid > 0) & valid_grid).any(-1))

    @abstractmethod
    def _metric_rows(self, preds: Tensor, target: Tensor, valid: Tensor) -> Tensor:
        """The metric of every row of a ``(Q, L)`` masked grid, ``(Q,)``."""
