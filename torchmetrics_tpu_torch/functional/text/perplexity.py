# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Perplexity (counterpart of ``torchmetrics_tpu/functional/text/perplexity.py``).

The one text metric whose hot path belongs on the card: each token's
-log p(target) over a ``(B, T, V)`` logits tensor, which K8
(:func:`~torchmetrics_tpu_torch.ops.token_nll`) computes in one read of the
logits without writing a ``(B*T, V)`` log-softmax. The per-token values add
in XLA's order (``_sum_in_xla_order``), the same on the card and the CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.ops import token_nll
from torchmetrics_tpu_torch.utilities.compute import _sum_in_xla_order
from torchmetrics_tpu_torch.utilities.data import _float32_inputs

Tensor = torch.Tensor


def _name(dtype: torch.dtype) -> str:
    """A dtype as numpy and JAX name it (``int32``, not ``torch.int32``)."""
    return str(dtype).removeprefix("torch.")


def _check_shape_and_type_consistency(preds: Tensor, target: Tensor) -> None:
    """Validate ``[B, T, V]`` logits against ``[B, T]`` targets."""
    if preds.ndim != 3:
        raise ValueError(
            "Input tensor `preds` is expected to have 3 dimensions, [batch_size, seq_len, vocab_size],"
            f" but got {preds.ndim}."
        )
    if target.ndim != 2:
        raise ValueError(
            f"Input tensor `target` is expected to have 2 dimensions, [batch_size, seq_len], but got {target.ndim}."
        )
    if preds.shape[:2] != target.shape:
        raise ValueError(
            "Input tensors `preds` and `target` are expected to have equaling first two dimensions,"
            f" [batch_size, seq_len], but got {tuple(preds.shape[:2])} and {tuple(target.shape)}."
        )
    if not preds.dtype.is_floating_point:
        raise TypeError(f"Input tensor `preds` is expected to be of floating point type but got {_name(preds.dtype)}.")
    if target.dtype.is_floating_point or target.dtype.is_complex or target.dtype == torch.bool:
        raise TypeError(f"Input tensor `target` is expected to be of integer type but got {_name(target.dtype)}.")


def _perplexity_update(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """Summed -log p(target) in the logits' type (float32, or the 16-bit type,
    whose per-token values add in float32 and round once, as XLA's reduction
    of a 16-bit array does) and the int32 count of scored tokens."""
    _check_shape_and_type_consistency(preds, target)
    preds = _float32_inputs(preds)
    nll, valid = token_nll(preds.reshape(-1, preds.shape[-1]), target.reshape(-1), ignore_index)
    total = _sum_in_xla_order(nll.to(torch.float32)).to(nll.dtype)
    return total, valid.sum(dtype=torch.int32)


def _perplexity_compute(total: Tensor, count: Tensor) -> Tensor:
    """exp(mean -log p)."""
    return torch.exp(total / count)


def perplexity(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tensor:
    """Perplexity of a language model over ``[B, T, V]`` logits and ``[B, T]`` targets."""
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    total, count = _perplexity_update(preds, target, ignore_index)
    return _perplexity_compute(total, count)
