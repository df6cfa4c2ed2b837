# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Critical success index (counterpart of ``torchmetrics_tpu/functional/regression/csi.py``).

Hits, misses and false alarms are int32 counts, as in the JAX package."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.regression.utils import _jnp_dtype
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.compute import _safe_divide
from torchmetrics_tpu_torch.utilities.data import _to_tensors

Tensor = torch.Tensor


def _count(mask: Tensor, sum_dims: Optional[Tuple[int, ...]]) -> Tensor:
    """``jnp.sum(mask, axis=sum_dims)`` as int32. An empty ``sum_dims`` (the
    kept dim is the only one) reduces nothing, as ``jnp.sum(axis=())`` does;
    ``torch.sum(dim=())`` would reduce every dim."""
    if sum_dims is None:
        return mask.sum(dtype=torch.int32)
    if not sum_dims:
        return mask.to(torch.int32)
    return mask.sum(dim=sum_dims, dtype=torch.int32)


def _critical_success_index_update(
    preds: Tensor, target: Tensor, threshold: float, keep_sequence_dim: Optional[int] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """Binarize at ``threshold`` and count hits, misses and false alarms
    (over everything, or per index of ``keep_sequence_dim``)."""
    _check_same_shape(preds, target)
    if keep_sequence_dim is None:
        sum_dims = None
    elif not 0 <= keep_sequence_dim < preds.ndim:
        raise ValueError(f"Expected keep_sequence dim to be in range [0, {preds.ndim}] but got {keep_sequence_dim}")
    else:
        sum_dims = tuple(i for i in range(preds.ndim) if i != keep_sequence_dim)

    preds_bin = preds >= threshold
    target_bin = target >= threshold
    hits = _count(preds_bin & target_bin, sum_dims)
    misses = _count((preds_bin ^ target_bin) & target_bin, sum_dims)
    false_alarms = _count((preds_bin ^ target_bin) & preds_bin, sum_dims)
    return hits, misses, false_alarms


def _critical_success_index_compute(hits: Tensor, misses: Tensor, false_alarms: Tensor) -> Tensor:
    """CSI = hits / (hits + misses + false alarms), 0 where nothing was counted."""
    return _safe_divide(hits, hits + misses + false_alarms)


def critical_success_index(
    preds: Tensor, target: Tensor, threshold: float, keep_sequence_dim: Optional[int] = None
) -> Tensor:
    """Compute the critical success index."""
    preds, target = _to_tensors(preds, target)
    hits, misses, false_alarms = _critical_success_index_update(
        _jnp_dtype(preds), _jnp_dtype(target), threshold, keep_sequence_dim
    )
    return _critical_success_index_compute(hits, misses, false_alarms)
