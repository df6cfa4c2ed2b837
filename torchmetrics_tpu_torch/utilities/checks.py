# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Input validation helpers (counterpart of ``torchmetrics_tpu/utilities/checks.py``).

Shape and dtype checks always run. Value checks read the data back to the
host, so they run only where :func:`_is_concrete` holds, as the JAX package
runs them only outside ``jit``: eagerly always, and never while a CUDA graph
is being captured (the fused plan's step), where a host read would end the
capture. Pass ``validate_args=False`` to keep an eager CUDA update free of
host syncs too.

A step whose result would depend on values through its shapes (the
aggregators' NaN dropping) asks :func:`_in_fused_step` as well: a fused
plan's step keeps every shape fixed on every device, as JAX's ``jit`` does,
while its raise-only value checks still run eagerly on the CPU.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Iterator, Optional, Tuple

import torch

from torchmetrics_tpu_torch.utilities.data import _jnp_dtype

_FUSED_STEP = threading.local()


def _is_concrete(x: Any) -> bool:
    """True when ``x``'s values can be read on the host now: false for a CUDA
    tensor while the current stream is capturing a CUDA graph, and for any
    tensor under a ``torch.func`` transform (the sliced plan's per-row
    ``vmap``), the counterparts of a tracer under ``jit`` and ``vmap``."""
    if not isinstance(x, torch.Tensor):
        return True
    if torch._C._functorch.maybe_current_level() is not None:
        return False
    return not (x.is_cuda and torch.cuda.is_current_stream_capturing())


@contextmanager
def _fused_step() -> Iterator[None]:
    """Mark this thread as running a member's update inside a fused plan's step."""
    depth = getattr(_FUSED_STEP, "depth", 0)
    _FUSED_STEP.depth = depth + 1
    try:
        yield
    finally:
        _FUSED_STEP.depth = depth


def _in_fused_step() -> bool:
    """True while a fused plan's step runs a member's update (captured on the
    card, eager on the CPU): its shapes may not depend on values."""
    return getattr(_FUSED_STEP, "depth", 0) > 0


def _check_binary_target(target: torch.Tensor, ignore_index: Optional[int] = None) -> None:
    """Raise unless every target is 0, 1 or ``ignore_index`` (reads values back to the host)."""
    ok = (target == 0) | (target == 1)
    if ignore_index is not None:
        ok = ok | (target == ignore_index)
    if not bool(torch.all(ok)):
        raise RuntimeError(
            f"Detected the following values in `target`: {torch.unique(target)} but expected only"
            f" the following values {[0, 1] + ([ignore_index] if ignore_index is not None else [])}."
        )


def _check_same_shape(preds: torch.Tensor, target: torch.Tensor) -> None:
    """Raise if shapes differ."""
    if preds.shape != target.shape:
        raise RuntimeError(
            "Predictions and targets are expected to have the same shape,"
            f" but got {tuple(preds.shape)} and {tuple(target.shape)}."
        )


def _check_for_empty_tensors(preds: torch.Tensor, target: torch.Tensor) -> bool:
    """True when BOTH inputs are empty."""
    return preds.numel() == 0 and target.numel() == 0


def _input_squeeze(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop singleton axes, keeping the batch axis when it is 1."""
    if preds.shape[0] == 1:
        return preds.squeeze().unsqueeze(0), target.squeeze().unsqueeze(0)
    return preds.squeeze(), target.squeeze()


def is_overridden(method_name: str, instance: object, parent: type) -> bool:
    """True when ``instance``'s class overrides ``parent.method_name``."""
    instance_attr = getattr(type(instance), method_name, None)
    parent_attr = getattr(parent, method_name, None)
    if instance_attr is None or parent_attr is None:
        return False
    return instance_attr is not parent_attr


def _check_retrieval_target_and_prediction_types(
    preds: torch.Tensor, target: torch.Tensor, allow_non_binary_target: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float preds; a bool, integer or float target whose values lie in
    [0, 1] unless ``allow_non_binary_target`` (fractional relevance passes,
    as in JAX). The range is read on the host only where the target is
    concrete. Both come back flat: preds float32, the target float32 unless
    non-binary targets are allowed, then in its own dtype, 64-bit narrowed."""
    if not preds.is_floating_point():
        raise ValueError("`preds` must be a array of floats")
    if target.is_complex():
        raise ValueError("`target` must be a array of booleans, integers or floats")
    if (
        not allow_non_binary_target
        and _is_concrete(target)
        and target.numel()
        and bool((target.max() > 1) | (target.min() < 0))
    ):
        raise ValueError("`target` must contain `binary` values")
    target = target.reshape(-1)
    return preds.reshape(-1).to(torch.float32), _jnp_dtype(target) if allow_non_binary_target else target.to(torch.float32)


def _check_retrieval_functional_inputs(
    preds: torch.Tensor, target: torch.Tensor, allow_non_binary_target: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check and flatten one query's inputs."""
    if preds.shape != target.shape or preds.ndim == 0 or preds.numel() == 0:
        raise ValueError("`preds` and `target` must be non-empty and of the same shape")
    return _check_retrieval_target_and_prediction_types(preds, target, allow_non_binary_target)


def _check_retrieval_inputs(
    indexes: torch.Tensor,
    preds: torch.Tensor,
    target: torch.Tensor,
    allow_non_binary_target: bool = False,
    ignore_index: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Check and flatten a retrieval module's batch. Rows whose target is
    ``ignore_index`` go first (a boolean select, which reads the mask's count
    on the host), then an empty batch raises: an all-ignored batch is an
    error, as in JAX. ``indexes`` come back int32, as JAX's with 64-bit
    types off."""
    if indexes.shape != preds.shape or preds.shape != target.shape or indexes.ndim == 0:
        raise ValueError("`indexes`, `preds` and `target` must be non-empty and of the same shape")
    if indexes.is_floating_point() or indexes.is_complex() or indexes.dtype == torch.bool:
        raise ValueError("`indexes` must be a array of integers")
    if ignore_index is not None:
        valid = target != ignore_index
        # metriclint: disable=ML011 -- ignored rows leave the batch, a size set by the values as in JAX; without ignore_index the update captures
        indexes, preds, target = indexes[valid], preds[valid], target[valid]
    if preds.numel() == 0:
        raise ValueError("`indexes`, `preds` and `target` must be non-empty and of the same shape")
    preds, target = _check_retrieval_target_and_prediction_types(preds, target, allow_non_binary_target)
    return indexes.reshape(-1).to(torch.int32), preds, target


def _allclose_recursive(res1: Any, res2: Any, atol: float = 1e-6) -> bool:
    if isinstance(res1, (list, tuple)):
        return all(_allclose_recursive(r1, r2, atol) for r1, r2 in zip(res1, res2))
    if isinstance(res1, dict):
        return all(_allclose_recursive(res1[k], res2[k], atol) for k in res1)
    return bool(torch.allclose(torch.as_tensor(res1), torch.as_tensor(res2).to(torch.as_tensor(res1).device), atol=atol))


def check_forward_full_state_property(
    metric_class: Any,
    init_args: Optional[dict] = None,
    input_args: Optional[dict] = None,
    num_update_to_compare: Any = (10, 100, 1000),
    reps: int = 5,
) -> None:
    """Compare ``forward`` with ``full_state_update=True`` and ``False`` on
    ``metric_class``: raise if the values differ, else print the time of each
    over ``num_update_to_compare`` calls (synchronized on the card)."""
    import time

    init_args = init_args or {}
    input_args = input_args or {}

    class FullState(metric_class):  # type: ignore[misc, valid-type]
        full_state_update = True

    class PartState(metric_class):  # type: ignore[misc, valid-type]
        full_state_update = False

    fs, ps = FullState(**init_args), PartState(**init_args)
    res1 = fs(**input_args)
    res2 = ps(**input_args)
    if not _allclose_recursive(res1, res2):
        raise RuntimeError(
            "The metric does not give the same result with `full_state_update=False`; it must keep the default."
        )
    for metric, name in [(fs, "full"), (ps, "partial")]:
        for num in num_update_to_compare:
            metric.reset()
            start = time.perf_counter()
            for _ in range(num):
                metric(**input_args)
            metric.compute()
            if metric.device.type == "cuda":
                torch.cuda.synchronize(metric.device)
            print(f"{name} state `forward` x{num}: {time.perf_counter() - start:.4f}s")
