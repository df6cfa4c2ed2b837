# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Retrieval module metrics (counterpart of ``torchmetrics_tpu/retrieval/metrics.py``)."""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.retrieval.metrics import (
    _auroc_kernel,
    _average_precision_kernel,
    _fall_out_kernel,
    _hit_rate_kernel,
    _ndcg_kernel,
    _precision_kernel,
    _precision_recall_curve_kernel,
    _r_precision_kernel,
    _recall_kernel,
    _reciprocal_rank_kernel,
    _validate_top_k,
    retrieval_auroc,
)
from torchmetrics_tpu_torch.retrieval.base import RetrievalMetric, _retrieval_aggregate
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

Tensor = torch.Tensor


class _TopKRetrievalMetric(RetrievalMetric):
    """A retrieval metric with an optional ``top_k`` cut."""

    def __init__(self, top_k: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if top_k is not None:
            _validate_top_k(top_k)
        self.top_k = top_k


class RetrievalMAP(_TopKRetrievalMetric):
    """Mean average precision."""

    def _metric_rows(self, preds: Tensor, target: Tensor, valid: Tensor) -> Tensor:
        return _average_precision_kernel(preds, target, valid, self.top_k)


class RetrievalMRR(_TopKRetrievalMetric):
    """Mean reciprocal rank."""

    def _metric_rows(self, preds: Tensor, target: Tensor, valid: Tensor) -> Tensor:
        return _reciprocal_rank_kernel(preds, target, valid, self.top_k)


class RetrievalPrecision(_TopKRetrievalMetric):
    """Precision@k."""

    def __init__(self, top_k: Optional[int] = None, adaptive_k: bool = False, **kwargs: Any) -> None:
        super().__init__(top_k=top_k, **kwargs)
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.adaptive_k = adaptive_k

    def _metric_rows(self, preds: Tensor, target: Tensor, valid: Tensor) -> Tensor:
        return _precision_kernel(preds, target, valid, self.top_k, self.adaptive_k)


class RetrievalRecall(_TopKRetrievalMetric):
    """Recall@k."""

    def _metric_rows(self, preds: Tensor, target: Tensor, valid: Tensor) -> Tensor:
        return _recall_kernel(preds, target, valid, self.top_k)


class RetrievalHitRate(_TopKRetrievalMetric):
    """HitRate@k."""

    def _metric_rows(self, preds: Tensor, target: Tensor, valid: Tensor) -> Tensor:
        return _hit_rate_kernel(preds, target, valid, self.top_k)


class RetrievalFallOut(_TopKRetrievalMetric):
    """Fall-out@k; the empty-target policy applies to queries with no
    NEGATIVE target."""

    higher_is_better = False

    def _metric_rows(self, preds: Tensor, target: Tensor, valid: Tensor) -> Tensor:
        return _fall_out_kernel(preds, target, valid, self.top_k)

    def compute(self) -> Tensor:
        """As the base's, keyed on the queries with a negative target."""
        preds_grid, target_grid, valid_grid = self._grids()
        values = self._metric_rows(preds_grid, target_grid, valid_grid)
        return self._aggregate(values, ((target_grid == 0) & valid_grid).any(-1), missing="negative")


class RetrievalRPrecision(RetrievalMetric):
    """R-precision."""

    def _metric_rows(self, preds: Tensor, target: Tensor, valid: Tensor) -> Tensor:
        return _r_precision_kernel(preds, target, valid)


class RetrievalNormalizedDCG(_TopKRetrievalMetric):
    """Normalized DCG; graded relevance targets are allowed."""

    def __init__(self, top_k: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(top_k=top_k, **kwargs)
        self.allow_non_binary_target = True

    def _metric_rows(self, preds: Tensor, target: Tensor, valid: Tensor) -> Tensor:
        return _ndcg_kernel(preds, target, valid, self.top_k)


class RetrievalAUROC(_TopKRetrievalMetric):
    """Mean AUROC over the queries; with ``max_fpr``, the partial AUC of
    each query's exact binary curve, one query at a time in a host loop,
    as JAX computes it."""

    def __init__(self, top_k: Optional[int] = None, max_fpr: Optional[float] = None, **kwargs: Any) -> None:
        super().__init__(top_k=top_k, **kwargs)
        if max_fpr is not None and not (isinstance(max_fpr, float) and 0 < max_fpr <= 1):
            raise ValueError(f"Argument `max_fpr` should be a float in range (0, 1], but got: {max_fpr}")
        self.max_fpr = max_fpr

    def _metric_rows(self, preds: Tensor, target: Tensor, valid: Tensor) -> Tensor:
        return _auroc_kernel(preds, target, valid, self.top_k)

    def compute(self) -> Tensor:
        if self.max_fpr is None:
            return super().compute()
        indexes = dim_zero_cat(self.indexes).cpu().numpy()
        preds = dim_zero_cat(self.preds).cpu().numpy()
        target = dim_zero_cat(self.target).cpu().numpy()
        values, has_pos = [], []
        for q in np.unique(indexes):
            m = indexes == q
            has_pos.append(bool(target[m].sum() > 0))
            query_preds = torch.as_tensor(preds[m], device=self._device)
            query_target = torch.as_tensor(target[m], device=self._device)
            values.append(float(retrieval_auroc(query_preds, query_target, self.top_k, self.max_fpr)))
        values_t = torch.tensor(values, dtype=torch.float32, device=self._device)
        return self._aggregate(values_t, torch.tensor(has_pos, dtype=torch.bool, device=self._device))


class RetrievalPrecisionRecallCurve(RetrievalMetric):
    """Precision and recall at k = 1..max_k, averaged over the queries."""

    def __init__(self, max_k: Optional[int] = None, adaptive_k: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if (max_k is not None) and not (isinstance(max_k, int) and max_k > 0):
            raise ValueError("`max_k` has to be a positive integer or None")
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.max_k = max_k
        self.adaptive_k = adaptive_k

    def _metric_rows(self, preds: Tensor, target: Tensor, valid: Tensor) -> Tensor:  # pragma: no cover - unused
        raise NotImplementedError

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        """The mean (or other aggregate) per-k curves over the queries."""
        preds_grid, target_grid, valid_grid = self._grids()
        max_k = self.max_k or preds_grid.shape[1]
        prec, rec, _ = _precision_recall_curve_kernel(preds_grid, target_grid, valid_grid, max_k, self.adaptive_k)
        has_pos = ((target_grid > 0) & valid_grid).any(-1)
        prec = self._apply_empty_action(prec, has_pos)
        rec = self._apply_empty_action(rec, has_pos)
        zeros = torch.zeros(max_k, device=prec.device)
        precision = _retrieval_aggregate(prec, self.aggregation, dim=0) if prec.numel() else zeros
        recall = _retrieval_aggregate(rec, self.aggregation, dim=0) if rec.numel() else zeros
        return precision, recall, torch.arange(1, max_k + 1, dtype=torch.int32, device=prec.device)


def _retrieval_recall_at_fixed_precision(
    precision: Tensor, recall: Tensor, top_k: Tensor, min_precision: float
) -> Tuple[Tensor, Tensor]:
    """The largest recall whose precision reaches ``min_precision``, and its
    k (the largest such k on a tie; ``len(top_k)`` when the recall is 0).
    Chosen on the host, as in JAX."""
    p, r, k = precision.cpu().numpy(), recall.cpu().numpy(), top_k.cpu().numpy()
    if (p >= min_precision).any():
        max_recall, best_k = max((rr, kk) for pp, rr, kk in zip(p, r, k) if pp >= min_precision)
    else:
        max_recall, best_k = 0.0, len(k)
    if max_recall == 0.0:
        best_k = len(k)
    device = precision.device
    return (
        torch.tensor(max_recall, dtype=torch.float32, device=device),
        torch.tensor(int(best_k), dtype=torch.int32, device=device),
    )


class RetrievalRecallAtFixedPrecision(RetrievalPrecisionRecallCurve):
    """The highest recall@k at a minimum precision, and its k."""

    def __init__(self, min_precision: float = 0.0, max_k: Optional[int] = None, adaptive_k: bool = False, **kwargs: Any) -> None:
        super().__init__(max_k=max_k, adaptive_k=adaptive_k, **kwargs)
        if not (isinstance(min_precision, float) and 0.0 <= min_precision <= 1.0):
            raise ValueError("`min_precision` has to be a positive float between 0 and 1")
        self.min_precision = min_precision

    def compute(self) -> Tuple[Tensor, Tensor]:  # type: ignore[override]
        precision, recall, top_k = super().compute()
        return _retrieval_recall_at_fixed_precision(precision, recall, top_k, self.min_precision)
