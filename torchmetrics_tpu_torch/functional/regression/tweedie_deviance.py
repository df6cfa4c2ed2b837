# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Tweedie deviance score (counterpart of
``torchmetrics_tpu/functional/regression/tweedie_deviance.py``).

The domain check of each power regime reads the inputs on the host, so it
runs only where :func:`_is_concrete` holds: eagerly, and never while a CUDA
graph is captured, as the JAX package runs it only outside ``jit``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from torchmetrics_tpu_torch.functional.regression.utils import _float32_pair
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape, _is_concrete
from torchmetrics_tpu_torch.utilities.compute import _safe_xlogy

Tensor = torch.Tensor


def _tweedie_deviance_domain_check(preds: Tensor, targets: Tensor, power: float) -> None:
    """Raise where the inputs leave the domain of ``power`` (reads the device)."""
    if not (_is_concrete(preds) and _is_concrete(targets)):
        return
    if power == 1 and (bool(torch.any(preds <= 0)) or bool(torch.any(targets < 0))):
        raise ValueError(f"For power={power}, 'preds' has to be strictly positive and 'targets' cannot be negative.")
    if power == 2 and (bool(torch.any(preds <= 0)) or bool(torch.any(targets <= 0))):
        raise ValueError(f"For power={power}, both 'preds' and 'targets' have to be strictly positive.")
    if power < 0 and bool(torch.any(preds <= 0)):
        raise ValueError(f"For power={power}, 'preds' has to be strictly positive.")
    if 1 < power < 2 and (bool(torch.any(preds <= 0)) or bool(torch.any(targets < 0))):
        raise ValueError(f"For power={power}, 'preds' has to be strictly positive and 'targets' cannot be negative.")
    if power > 2 and (bool(torch.any(preds <= 0)) or bool(torch.any(targets <= 0))):
        raise ValueError(f"For power={power}, both 'preds' and 'targets' have to be strictly positive.")


def _tweedie_deviance_score_update(preds: Tensor, targets: Tensor, power: float = 0.0) -> Tuple[Tensor, Tensor]:
    """Sum of the per-element deviance (0-d) and the number of elements (int32, 0-d)."""
    _check_same_shape(preds, targets)
    if 0 < power < 1:
        raise ValueError(f"Deviance Score is not defined for power={power}.")
    _tweedie_deviance_domain_check(preds, targets, power)

    if power == 0:
        deviance_score = torch.square(targets - preds)
    elif power == 1:
        deviance_score = 2 * (_safe_xlogy(targets, targets / preds) + preds - targets)
    elif power == 2:
        deviance_score = 2 * (torch.log(preds / targets) + (targets / preds) - 1)
    else:
        term_1 = torch.pow(torch.clamp(targets, min=0.0), 2 - power) / ((1 - power) * (2 - power))
        term_2 = targets * torch.pow(preds, 1 - power) / (1 - power)
        term_3 = torch.pow(preds, 2 - power) / (2 - power)
        deviance_score = 2 * (term_1 - term_2 + term_3)
    count = torch.full((), deviance_score.numel(), dtype=torch.int32, device=deviance_score.device)
    return torch.sum(deviance_score), count


def _tweedie_deviance_score_compute(sum_deviance_score: Tensor, num_observations: Tensor) -> Tensor:
    """Mean deviance."""
    return sum_deviance_score / num_observations


def tweedie_deviance_score(preds: Tensor, targets: Tensor, power: float = 0.0) -> Tensor:
    """Compute the Tweedie deviance score."""
    preds, targets = _float32_pair(preds, targets)
    sum_deviance_score, num_observations = _tweedie_deviance_score_update(preds, targets, power)
    return _tweedie_deviance_score_compute(sum_deviance_score, num_observations)
