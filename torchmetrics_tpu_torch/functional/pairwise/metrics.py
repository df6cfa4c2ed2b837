# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Pairwise similarities and distances (counterpart of
``torchmetrics_tpu/functional/pairwise/metrics.py``).

Cosine, linear and euclidean take one matrix product (``_safe_matmul``, a
plain ``torch.matmul``: the JAX function's product is a plain ``jnp``
product, no TPU kernel), in float32 with TF32 off, as the port always
leaves it. Manhattan and Minkowski keep JAX's broadcast ``(N, M, d)``
reduction. The euclidean distance expands ``‖x‖² + ‖y‖² - 2⟨x, y⟩``, which
cancels where x and y are close: its error is bounded relative to
``‖x‖² + ‖y‖²``, not to the distance (the tests state the budget).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.utilities.compute import _safe_matmul
from torchmetrics_tpu_torch.utilities.data import _jnp_dtype, _to_tensor

Tensor = torch.Tensor


def _check_input(
    x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None
) -> Tuple[Tensor, Tensor, bool]:
    """Validate ``[N, d]`` / ``[M, d]`` inputs; without ``y`` the matrix is
    ``x`` against itself, its diagonal zeroed unless asked otherwise."""
    if x.ndim != 2:
        raise ValueError(f"Expected argument `x` to be a 2D tensor of shape `[N, d]` but got {tuple(x.shape)}")
    if y is not None:
        if y.ndim != 2 or y.shape[1] != x.shape[1]:
            raise ValueError(
                "Expected argument `y` to be a 2D tensor of shape `[M, d]` where"
                " `d` should be same as the last dimension of `x`"
            )
        zero_diagonal = False if zero_diagonal is None else zero_diagonal
    else:
        y = x
        zero_diagonal = True if zero_diagonal is None else zero_diagonal
    return x, y, zero_diagonal


def _reduce_distance_matrix(distmat: Tensor, reduction: Optional[str] = None) -> Tensor:
    """Reduce along the last dim."""
    if reduction == "mean":
        return distmat.mean(dim=-1)
    if reduction == "sum":
        return distmat.sum(dim=-1)
    if reduction is None or reduction == "none":
        return distmat
    raise ValueError(f"Expected reduction to be one of `['mean', 'sum', None]` but got {reduction}")


def _zero_diagonal(distance: Tensor, zero_diagonal: bool) -> Tensor:
    if zero_diagonal:
        distance = distance.clone()
        distance.diagonal().zero_()
    return distance


def _inputs(x: Tensor, y: Optional[Tensor]) -> Tuple[Tensor, Optional[Tensor]]:
    """``x`` as a tensor (numpy goes to the card, see ``_to_tensor``), ``y``
    beside it; 64-bit types narrow as ``jnp.asarray`` narrows them."""
    x = _jnp_dtype(_to_tensor(x))
    return x, None if y is None else _jnp_dtype(_to_tensor(y, x.device))


def _pairwise_cosine_similarity_update(
    x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Normalized rows, one product."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    y = y / torch.linalg.vector_norm(y, dim=1, keepdim=True)
    return _zero_diagonal(_safe_matmul(x, y), zero_diagonal)


def pairwise_cosine_similarity(
    x: Tensor,
    y: Optional[Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """Pairwise cosine similarity of the rows of ``x`` and ``y``."""
    x, y = _inputs(x, y)
    return _reduce_distance_matrix(_pairwise_cosine_similarity_update(x, y, zero_diagonal), reduction)


def _pairwise_euclidean_distance_update(
    x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """``sqrt(max(‖x‖² + ‖y‖² - 2⟨x, y⟩, 0))``."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    x_norm = (x * x).sum(dim=1, keepdim=True)
    y_norm = (y * y).sum(dim=1)
    distance = x_norm + y_norm[None, :] - 2 * _safe_matmul(x, y)
    distance = _zero_diagonal(distance, zero_diagonal)
    return torch.sqrt(torch.clamp(distance, min=0.0))


def pairwise_euclidean_distance(
    x: Tensor,
    y: Optional[Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """Pairwise euclidean distance of the rows of ``x`` and ``y``."""
    x, y = _inputs(x, y)
    return _reduce_distance_matrix(_pairwise_euclidean_distance_update(x, y, zero_diagonal), reduction)


def _pairwise_linear_similarity_update(
    x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Inner products."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    return _zero_diagonal(_safe_matmul(x, y), zero_diagonal)


def pairwise_linear_similarity(
    x: Tensor,
    y: Optional[Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """Pairwise inner products of the rows of ``x`` and ``y``."""
    x, y = _inputs(x, y)
    return _reduce_distance_matrix(_pairwise_linear_similarity_update(x, y, zero_diagonal), reduction)


def _pairwise_manhattan_distance_update(
    x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Broadcast ``|x - y|`` sums over an ``(N, M, d)`` difference."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    distance = torch.abs(x[:, None, :] - y[None, :, :]).sum(dim=-1)
    return _zero_diagonal(distance, zero_diagonal)


def pairwise_manhattan_distance(
    x: Tensor,
    y: Optional[Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """Pairwise manhattan distance of the rows of ``x`` and ``y``."""
    x, y = _inputs(x, y)
    return _reduce_distance_matrix(_pairwise_manhattan_distance_update(x, y, zero_diagonal), reduction)


def _pairwise_minkowski_distance_update(
    x: Tensor, y: Optional[Tensor] = None, exponent: float = 2, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Broadcast p-norm over an ``(N, M, d)`` difference."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    if not (isinstance(exponent, (float, int)) and exponent >= 1):
        raise ValueError(f"Argument `exponent` must be a float larger than 1, but got {exponent}")
    distance = (torch.abs(x[:, None, :] - y[None, :, :]) ** exponent).sum(dim=-1) ** (1.0 / exponent)
    return _zero_diagonal(distance, zero_diagonal)


def pairwise_minkowski_distance(
    x: Tensor,
    y: Optional[Tensor] = None,
    exponent: float = 2,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """Pairwise minkowski distance of the rows of ``x`` and ``y``."""
    x, y = _inputs(x, y)
    return _reduce_distance_matrix(_pairwise_minkowski_distance_update(x, y, exponent, zero_diagonal), reduction)
