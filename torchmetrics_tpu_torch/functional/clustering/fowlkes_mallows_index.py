# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Fowlkes-Mallows index (counterpart of ``torchmetrics_tpu/functional/clustering/fowlkes_mallows_index.py``)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.clustering.utils import calculate_contingency_matrix, check_cluster_labels
from torchmetrics_tpu_torch.utilities.data import _jnp_dtype, _to_tensors

Tensor = torch.Tensor


def _fowlkes_mallows_index_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    """The int32 contingency matrix and the sample count."""
    check_cluster_labels(preds, target)
    return calculate_contingency_matrix(preds, target), preds.shape[0]


def _fowlkes_mallows_index_compute(contingency: Tensor, n: int) -> Tensor:
    """FMI from the contingency matrix.

    Squared marginal sums overflow int32 past about 46k samples, so the
    reduction runs on the host in int64, as in JAX.
    """
    cont = np.asarray(contingency.cpu()).astype(np.int64)
    tk = float((cont**2).sum() - n)
    if np.isclose(tk, 0):
        return torch.tensor(0.0, device=contingency.device)
    pk = float((cont.sum(axis=0).astype(np.int64) ** 2).sum() - n)
    qk = float((cont.sum(axis=1).astype(np.int64) ** 2).sum() - n)
    return torch.tensor(np.sqrt(tk / pk) * np.sqrt(tk / qk), dtype=torch.float32, device=contingency.device)


def fowlkes_mallows_index(preds: Tensor, target: Tensor) -> Tensor:
    """Fowlkes-Mallows index between two clusterings."""
    preds, target = map(_jnp_dtype, _to_tensors(preds, target))
    contingency, n = _fowlkes_mallows_index_update(preds, target)
    return _fowlkes_mallows_index_compute(contingency, n)
