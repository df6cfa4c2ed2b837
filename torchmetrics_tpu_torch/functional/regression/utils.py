# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Shared helpers of the regression metrics (counterpart of
``torchmetrics_tpu/functional/regression/utils.py``).

Input dtypes follow the JAX package, which runs with 64-bit types off:
``jnp.asarray`` makes a float64 input float32 and an int64 one int32, and
``jnp.asarray(x, dtype=jnp.float32)`` makes anything float32.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

# the regression modules import these two from here
from torchmetrics_tpu_torch.utilities.data import _jnp_add, _jnp_dtype, _to_tensors  # noqa: F401

Tensor = torch.Tensor


def _float32_pair(preds: Any, target: Any) -> Tuple[Tensor, Tensor]:
    """A functional's two inputs as float32 tensors: tensors stay where they
    lie, anything else goes to the card (a CPU caller passes CPU tensors)."""
    preds, target = _to_tensors(preds, target)
    return preds.to(torch.float32), target.to(torch.float32)


def _check_data_shape_to_num_outputs(
    preds: Tensor, target: Tensor, num_outputs: int, allow_1d_reshape: bool = False
) -> None:
    """Check shapes are consistent with ``num_outputs``."""
    if preds.ndim > 2 or target.ndim > 2:
        raise ValueError(
            f"Expected both predictions and target to be either 1- or 2-dimensional tensors,"
            f" but got {target.ndim} and {preds.ndim}."
        )
    cond1 = False
    if not allow_1d_reshape:
        cond1 = num_outputs == 1 and not (preds.ndim == 1 or preds.shape[1] == 1)
    cond2 = num_outputs > 1 and (preds.ndim < 2 or preds.shape[1] != num_outputs)
    if cond1 or cond2:
        raise ValueError(
            f"Expected argument `num_outputs` to match the second dimension of input, but got {num_outputs}"
            f" and {tuple(preds.shape)}"
        )
