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

from torchmetrics_tpu_torch.utilities.data import _to_tensors

Tensor = torch.Tensor

_NARROWED = {torch.float64: torch.float32, torch.int64: torch.int32}


def _jnp_dtype(x: Tensor) -> Tensor:
    """``x`` in the dtype ``jnp.asarray`` gives it: float64 as float32, int64 as int32."""
    narrowed = _NARROWED.get(x.dtype)
    return x if narrowed is None else x.to(narrowed)


def _jnp_add(a: Tensor, b: Tensor) -> Tensor:
    """``a + b`` in the dtype ``jnp`` gives it, by the dtype lattice alone.

    Torch lets a 0-d operand lose to a dimensioned one of the same kind, so a
    ``(1,)`` bfloat16 state plus a 0-d float32 batch sum stays bfloat16;
    ``jnp`` widens it to float32 (a state narrowed by ``set_dtype``).
    """
    common = torch.promote_types(a.dtype, b.dtype)
    return a.to(common) + b.to(common)


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
