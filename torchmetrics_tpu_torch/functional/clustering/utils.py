# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Clustering helpers (counterpart of ``torchmetrics_tpu/functional/clustering/utils.py``).

The contingency matrix is one int32 count over ``row * n_cols + col`` after
relabelling both clusterings with ``unique`` (the capture-safe
``_bincount``, so the counts equal ``jnp.bincount``'s bit for bit); the
per-cluster statistics are one-hot segment reductions. Relabelling sizes
its outputs by the number of distinct labels, and the validations read
values, so these read the host, as the JAX package's do (eager by design).
The pair-confusion counts grow as n² and are taken on the host in int64,
as in JAX.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.utilities.data import _bincount

Tensor = torch.Tensor


def _dtype_name(x: Tensor) -> str:
    """``x``'s dtype as the JAX package prints it (``int32``, not ``torch.int32``)."""
    return str(x.dtype).replace("torch.", "")


def _f32(x: Tensor) -> Tensor:
    """Integer counts as float32, the dtype ``jnp`` computes their logs and ratios in."""
    return x if x.is_floating_point() else x.to(torch.float32)


def is_nonnegative(x: Tensor, atol: float = 1e-5) -> bool:
    """True if all elements are nonnegative within tolerance (a host read)."""
    return bool(torch.all(x >= -atol))


def _validate_average_method_arg(average_method: str = "arithmetic") -> None:
    """Validate the generalized-mean method."""
    if average_method not in ("min", "geometric", "arithmetic", "max"):
        raise ValueError(
            "Expected argument `average_method` to be one of `min`, `geometric`, `arithmetic`, `max`,"
            f" but got {average_method}"
        )


def calculate_entropy(x: Tensor) -> Tensor:
    """Entropy of a label tensor, in log form for roundoff; float32."""
    if x.numel() == 0:
        return torch.tensor(1.0, device=x.device)
    classes, inverse = torch.unique(x, return_inverse=True)
    p = _bincount(inverse.reshape(-1), int(classes.numel()))
    p = p[p > 0]
    if p.numel() == 1:
        return torch.tensor(0.0, device=x.device)
    p = _f32(p)
    n = _f32(p.sum())
    return -torch.sum((p / n) * (torch.log(p) - torch.log(n)))


def calculate_generalized_mean(x: Tensor, p: Union[int, float, str]) -> Tensor:
    """Generalized (power) mean."""
    if x.is_complex() or not is_nonnegative(x):
        raise ValueError("`x` must contain positive real numbers")
    if isinstance(p, str):
        if p == "min":
            return x.min()
        if p == "geometric":
            return torch.exp(torch.mean(torch.log(x)))
        if p == "arithmetic":
            return x.mean()
        if p == "max":
            return x.max()
        raise ValueError("'method' must be 'min', 'geometric', 'arirthmetic', or 'max'")
    return torch.mean(x**p) ** (1.0 / p)


def calculate_contingency_matrix(preds: Tensor, target: Tensor, eps: Optional[float] = None) -> Tensor:
    """``(n_preds_classes, n_target_classes)`` int32 contingency matrix
    (float32 with ``eps`` added), one count over ``row * n_cols + col``."""
    preds_classes, preds_idx = torch.unique(preds.reshape(-1), return_inverse=True)
    target_classes, target_idx = torch.unique(target.reshape(-1), return_inverse=True)
    n_rows = int(preds_classes.shape[0])
    n_cols = int(target_classes.shape[0])
    linear = preds_idx.reshape(-1) * n_cols + target_idx.reshape(-1)
    contingency = _bincount(linear, n_rows * n_cols).reshape(n_rows, n_cols)
    if eps is not None:
        contingency = contingency + eps
    return contingency


def _is_real_discrete_label(x: Tensor) -> bool:
    """True for 1D integer label tensors, or float ones holding whole numbers."""
    if x.ndim != 1:
        raise ValueError(f"Expected arguments to be 1-d tensors but got {x.ndim}-d tensors.")
    if not (x.is_floating_point() or x.is_complex() or x.dtype == torch.bool):
        return True
    return bool(torch.all(torch.floor(x) == x))


def check_cluster_labels(preds: Tensor, target: Tensor) -> None:
    """Validate shapes and dtypes of cluster labels."""
    if preds.shape != target.shape:
        raise ValueError(
            f"Expected preds and target to have the same shape, got {tuple(preds.shape)} and {tuple(target.shape)}."
        )
    if not (_is_real_discrete_label(preds) and _is_real_discrete_label(target)):
        raise ValueError(f"Expected real, discrete values but received {_dtype_name(preds)} for"
                         f" predictions and {_dtype_name(target)} for target labels instead.")


def _validate_intrinsic_cluster_data(data: Tensor, labels: Tensor) -> None:
    """Validate the ``(data, labels)`` inputs of the intrinsic metrics."""
    if data.ndim != 2:
        raise ValueError(f"Expected 2D data, got {data.ndim}D data instead")
    if not data.is_floating_point():
        raise ValueError(f"Expected floating point data, got {_dtype_name(data)} data instead")
    if labels.ndim != 1:
        raise ValueError(f"Expected 1D labels, got {labels.ndim}D labels instead")


def _validate_intrinsic_labels_to_samples(num_labels: int, num_samples: int) -> None:
    """Require ``1 < num_labels < num_samples``."""
    if not 1 < num_labels < num_samples:
        raise ValueError(
            "Number of detected clusters must be greater than one and less than the number of samples."
            f"Got {num_labels} clusters and {num_samples} samples."
        )


def calculate_pair_cluster_confusion_matrix(
    preds: Optional[Tensor] = None,
    target: Optional[Tensor] = None,
    contingency: Optional[Tensor] = None,
) -> np.ndarray:
    """2x2 pair confusion matrix between two clusterings, float64 on the host.

    Pair counts scale as n² and overflow int32 beyond about 46k samples, so
    they are taken on the host in int64, as the JAX package takes them.
    """
    if preds is None and target is None and contingency is None:
        raise ValueError("Must provide either `preds` and `target` or `contingency`.")
    if preds is not None and target is not None and contingency is not None:
        raise ValueError("Must provide either `preds` and `target` or `contingency`, not both.")
    if preds is not None and target is not None:
        contingency = calculate_contingency_matrix(preds, target)
    if contingency is None:
        raise ValueError("Must provide `contingency` if `preds` and `target` are not provided.")

    cont = np.asarray(contingency.cpu() if isinstance(contingency, Tensor) else contingency).astype(np.int64)
    num_samples = cont.sum()
    sum_c = cont.sum(axis=1)
    sum_k = cont.sum(axis=0)
    sum_squared = (cont**2).sum()

    c11 = sum_squared - num_samples
    c01 = (cont * sum_k[None, :]).sum() - sum_squared
    c10 = (cont.T * sum_c[None, :]).sum() - sum_squared
    c00 = num_samples**2 - c11 - c10 - c01 - num_samples
    return np.array([[c00, c01], [c10, c11]], dtype=np.float64)


def _cluster_stats(data: Tensor, labels: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Zero-indexed labels, per-cluster counts and centroids by one-hot segment means.

    The centroids are ``onehot.T @ data``: a float32 product runs in float32
    on the card too, since the port never turns TF32 on
    (``torch.backends.cuda.matmul.allow_tf32`` stays ``False``); its sums
    run in another order than XLA's, so the tests state a tolerance.
    """
    unique_labels, inverse = torch.unique(labels, return_inverse=True)
    num_labels = int(unique_labels.shape[0])
    inverse = inverse.reshape(-1)
    onehot = torch.nn.functional.one_hot(inverse, num_labels).to(data.dtype)  # (N, K)
    counts = onehot.sum(dim=0)  # (K,)
    centroids = (onehot.T @ data) / counts[:, None]  # (K, d)
    return inverse, counts, centroids
