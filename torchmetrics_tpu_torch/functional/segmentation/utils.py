# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Segmentation helpers (counterpart of ``torchmetrics_tpu/functional/segmentation/utils.py``)."""
from __future__ import annotations

from typing import Tuple

import torch

from torchmetrics_tpu_torch.utilities.checks import _is_concrete
from torchmetrics_tpu_torch.utilities.data import to_onehot

Tensor = torch.Tensor


def _ignore_background(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Drop the background class (channel 0) where there is more than one channel."""
    preds = preds[:, 1:] if preds.shape[1] > 1 else preds
    target = target[:, 1:] if target.shape[1] > 1 else target
    return preds, target


def _segmentation_format(preds: Tensor, target: Tensor, num_classes: int, input_format: str) -> Tuple[Tensor, Tensor]:
    """Index labels to an int32 one-hot with the class axis at 1.

    On concrete inputs an index outside ``[0, num_classes)`` raises JAX's
    ``ValueError`` (one read of the extremes on the host). Where the values
    cannot be read (a CUDA graph being captured) the check is skipped, as
    JAX skips it under ``jit``, and such a label one-hots to a row of zeros,
    as ``jax.nn.one_hot`` makes it (:func:`to_onehot`; torch's ``one_hot``
    would raise).
    """
    if input_format == "index":
        if _is_concrete(preds) and _is_concrete(target):
            max_label = int(torch.maximum(preds.max(), target.max()))
            min_label = int(torch.minimum(preds.min(), target.min()))
            if max_label >= num_classes or min_label < 0:
                raise ValueError(
                    f"Detected index labels in [{min_label}, {max_label}] outside the valid range"
                    f" 0..{num_classes - 1} implied by `num_classes`={num_classes}."
                )
        preds = to_onehot(preds, num_classes)
        target = to_onehot(target, num_classes)
    return preds, target


def _spatial_sum(x: Tensor, dims: Tuple[int, ...]) -> Tensor:
    """``jnp.sum(x, axis=dims)`` in ``jnp``'s dtype: an integer or bool
    input sums to int32 (exact, so equal on every device), a float one in
    its own dtype. ``dims`` is never empty here (C3: torch's ``sum(dim=())``
    would reduce every axis)."""
    if not dims:
        raise ValueError("a segmentation map has at least one spatial axis")
    if x.is_floating_point():
        return x.sum(dim=dims)
    return x.sum(dim=dims, dtype=torch.int32)
