# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Pearson correlation coefficient (counterpart of
``torchmetrics_tpu/functional/regression/pearson.py``).

The streaming statistics (means, the sums of squared deviations and of
co-deviations, and the float count) fold a batch with one branch-free
expression: the first batch is the case ``num_prior == 0`` of the merge, so
nothing reads the count on the host and a CUDA graph captures the update.
:func:`_final_aggregation` merges per-shard statistics stacked along a
leading axis (after a replica gather or sharded folds) with the
parallel-variance formula, pairwise in shard order.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from torchmetrics_tpu_torch.functional.regression.utils import _check_data_shape_to_num_outputs, _float32_pair, _jnp_add
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape, _is_concrete
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor


def _pearson_corrcoef_update(
    preds: Tensor,
    target: Tensor,
    mean_x: Tensor,
    mean_y: Tensor,
    var_x: Tensor,
    var_y: Tensor,
    corr_xy: Tensor,
    num_prior: Tensor,
    num_outputs: int,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Fold a batch into the streaming statistics."""
    _check_same_shape(preds, target)
    _check_data_shape_to_num_outputs(preds, target, num_outputs)
    num_obs = preds.shape[0]

    total = num_prior + num_obs
    mx_new = _jnp_add(num_prior * mean_x, torch.sum(preds, dim=0)) / total
    my_new = _jnp_add(num_prior * mean_y, torch.sum(target, dim=0)) / total
    var_x = _jnp_add(var_x, torch.sum((preds - mx_new) * (preds - mean_x), dim=0))
    var_y = _jnp_add(var_y, torch.sum((target - my_new) * (target - mean_y), dim=0))
    corr_xy = _jnp_add(corr_xy, torch.sum((preds - mx_new) * (target - mean_y), dim=0))
    return mx_new, my_new, var_x, var_y, corr_xy, total


def _pearson_corrcoef_compute(var_x: Tensor, var_y: Tensor, corr_xy: Tensor, nb: Tensor) -> Tensor:
    """Pearson r from the accumulated statistics, clipped to [-1, 1]; warns
    (reading the device, eagerly only) where a variance is near zero."""
    var_x = var_x / (nb - 1)
    var_y = var_y / (nb - 1)
    corr_xy = corr_xy / (nb - 1)

    bound = math.sqrt(torch.finfo(var_x.dtype).eps)
    if _is_concrete(var_x) and (bool(torch.any(var_x < bound)) or bool(torch.any(var_y < bound))):
        rank_zero_warn(
            "The variance of predictions or target is close to zero. This can cause instability in Pearson correlation"
            "coefficient, leading to wrong results. Consider re-scaling the input if possible or computing using a"
            f"larger dtype (currently using {str(var_x.dtype).removeprefix('torch.')}).",
            UserWarning,
        )
    corrcoef = (corr_xy / torch.sqrt(var_x * var_y)).squeeze()
    return torch.clamp(corrcoef, -1.0, 1.0)


def _final_aggregation(
    means_x: Tensor,
    means_y: Tensor,
    vars_x: Tensor,
    vars_y: Tensor,
    corrs_xy: Tensor,
    nbs: Tensor,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Merge per-shard ``(mean, var, cov, n)`` statistics (leading shard axis)
    into global ones with the parallel-variance formula, shard by shard."""

    def merge(a, b):
        mx1, my1, vx1, vy1, cxy1, n1 = a
        mx2, my2, vx2, vy2, cxy2, n2 = b
        nb = n1 + n2
        safe_nb = torch.where(nb == 0, torch.ones_like(nb), nb)
        mean_x = (n1 * mx1 + n2 * mx2) / safe_nb
        mean_y = (n1 * my1 + n2 * my2) / safe_nb
        # var_x
        element_x1 = (n1 + 1) * mean_x - n1 * mx1
        vx1_adj = vx1 + (element_x1 - mx1) * (element_x1 - mean_x) - (element_x1 - mean_x) ** 2
        element_x2 = (n2 + 1) * mean_x - n2 * mx2
        vx2_adj = vx2 + (element_x2 - mx2) * (element_x2 - mean_x) - (element_x2 - mean_x) ** 2
        var_x = vx1_adj + vx2_adj
        # var_y
        element_y1 = (n1 + 1) * mean_y - n1 * my1
        vy1_adj = vy1 + (element_y1 - my1) * (element_y1 - mean_y) - (element_y1 - mean_y) ** 2
        element_y2 = (n2 + 1) * mean_y - n2 * my2
        vy2_adj = vy2 + (element_y2 - my2) * (element_y2 - mean_y) - (element_y2 - mean_y) ** 2
        var_y = vy1_adj + vy2_adj
        # corr_xy
        cxy1_adj = cxy1 + (element_x1 - mx1) * (element_y1 - mean_y) - (element_x1 - mean_x) * (element_y1 - mean_y)
        cxy2_adj = cxy2 + (element_x2 - mx2) * (element_y2 - mean_y) - (element_x2 - mean_x) * (element_y2 - mean_y)
        corr_xy = cxy1_adj + cxy2_adj
        return mean_x, mean_y, var_x, var_y, corr_xy, nb

    state = (means_x[0], means_y[0], vars_x[0], vars_y[0], corrs_xy[0], nbs[0])
    for i in range(1, means_x.shape[0]):
        state = merge(state, (means_x[i], means_y[i], vars_x[i], vars_y[i], corrs_xy[i], nbs[i]))
    return state


def _zero_statistics(preds: Tensor) -> Tuple[Tensor, ...]:
    d = preds.shape[1] if preds.ndim == 2 else 1
    return tuple(torch.zeros(d, dtype=preds.dtype, device=preds.device) for _ in range(6))


def pearson_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Compute the Pearson correlation coefficient."""
    preds, target = _float32_pair(preds, target)
    d = preds.shape[1] if preds.ndim == 2 else 1
    _, _, var_x, var_y, corr_xy, nb = _pearson_corrcoef_update(preds, target, *_zero_statistics(preds), num_outputs=d)
    return _pearson_corrcoef_compute(var_x, var_y, corr_xy, nb)
