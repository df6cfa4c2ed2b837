# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Spearman rank correlation (counterpart of ``torchmetrics_tpu/functional/regression/spearman.py``).

Ranks start at 1 and ties take the mean of their ranks: a stable sort, a
segment id that grows where the sorted value changes, and a segment mean
scattered back. The sort puts NaN last, as ``jnp.argsort`` does, and NaN is
never equal to itself, so every NaN is a segment of its own; ``-0.0`` and
``0.0`` tie. Ties average their ranks, so the order inside a tie does not
change a rank.
"""
from __future__ import annotations

from typing import Tuple

import torch

from torchmetrics_tpu_torch.functional.regression.utils import _check_data_shape_to_num_outputs, _jnp_dtype
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.data import _to_tensors

Tensor = torch.Tensor


def _tie_segments(sorted_vals: Tensor) -> Tensor:
    """Segment id of each sorted value (int32): a new segment where the value changes."""
    changed = (sorted_vals[1:] != sorted_vals[:-1]).to(torch.int32)
    return torch.cumsum(torch.cat([torch.zeros(1, dtype=torch.int32, device=sorted_vals.device), changed]), 0, dtype=torch.int32)


def _rank_data(data: Tensor) -> Tensor:
    """Rank 1-D data from 1; ties get the mean of their ranks."""
    n = data.shape[0]
    order = torch.argsort(data, stable=True)
    seg = _tie_segments(data[order]).long()
    ranks_sorted = torch.arange(1, n + 1, dtype=data.dtype, device=data.device)
    seg_sum = torch.zeros(n, dtype=data.dtype, device=data.device).index_add_(0, seg, ranks_sorted)
    seg_cnt = torch.zeros(n, dtype=data.dtype, device=data.device).index_add_(0, seg, torch.ones_like(ranks_sorted))
    mean_rank_sorted = (seg_sum / torch.clamp(seg_cnt, min=1))[seg]
    return torch.zeros_like(data).scatter_(0, order, mean_rank_sorted)


def _rank_columns(data: Tensor) -> Tensor:
    if data.ndim == 1:
        return _rank_data(data)
    return torch.stack([_rank_data(data[:, i]) for i in range(data.shape[1])], dim=1)


def _spearman_corrcoef_update(preds: Tensor, target: Tensor, num_outputs: int) -> Tuple[Tensor, Tensor]:
    """Validate; the inputs pass through (a cat-state update)."""
    if not (preds.is_floating_point() and target.is_floating_point()):
        raise TypeError(
            "Expected `preds` and `target` both to be floating point tensors, but got"
            f" {str(preds.dtype).removeprefix('torch.')} and {str(target.dtype).removeprefix('torch.')}"
        )
    _check_same_shape(preds, target)
    _check_data_shape_to_num_outputs(preds, target, num_outputs)
    return preds, target


def _spearman_corrcoef_compute(preds: Tensor, target: Tensor, eps: float = 1e-6) -> Tensor:
    """Rank every column, then Pearson on the ranks."""
    preds = _rank_columns(preds)
    target = _rank_columns(target)

    preds_diff = preds - preds.mean(dim=0)
    target_diff = target - target.mean(dim=0)

    cov = (preds_diff * target_diff).mean(dim=0)
    preds_std = torch.sqrt((preds_diff * preds_diff).mean(dim=0))
    target_std = torch.sqrt((target_diff * target_diff).mean(dim=0))

    corrcoef = cov / (preds_std * target_std + eps)
    return torch.clamp(corrcoef, -1.0, 1.0)


def spearman_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Compute Spearman's rank correlation coefficient."""
    preds, target = _to_tensors(preds, target)
    preds, target = _jnp_dtype(preds), _jnp_dtype(target)
    num_outputs = 1 if preds.ndim == 1 else preds.shape[-1]
    preds, target = _spearman_corrcoef_update(preds, target, num_outputs)
    return _spearman_corrcoef_compute(preds.to(torch.float32), target.to(torch.float32))
