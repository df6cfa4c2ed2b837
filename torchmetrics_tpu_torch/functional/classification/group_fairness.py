# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Group fairness (counterpart of
``torchmetrics_tpu/functional/classification/group_fairness.py``).

Group membership is a one-hot ``(N, G)`` mask and each of the per-group
tp/fp/tn/fn counts one masked int32 column sum, so the counts stay on the
device and a CUDA graph captures them (``validate_args=False``). What reads
the host is what does so in JAX: the functionals' group count
(``unique(groups)``), the groups check of ``validate_args``, and the result
dicts, whose keys name the argmin and argmax groups.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
)
from torchmetrics_tpu_torch.utilities.checks import _is_concrete
from torchmetrics_tpu_torch.utilities.compute import _safe_divide
from torchmetrics_tpu_torch.utilities.data import _to_tensor, _to_tensors
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor


def _groups_validation(groups: Tensor, num_groups: int) -> None:
    """Validate the groups tensor (reads its maximum on the host; skipped while capturing)."""
    if not _is_concrete(groups):
        return
    if int(groups.max()) >= num_groups:
        raise ValueError(
            f"The largest number in the groups tensor is {int(groups.max())}, which is larger than the specified"
            f"number of groups {num_groups}. The group identifiers should be ``0, 1, ..., (num_groups - 1)``."
        )
    if groups.is_floating_point() or groups.is_complex() or groups.dtype == torch.bool:
        raise ValueError(f"Expected dtype of argument groups to be int, not {str(groups.dtype).replace('torch.', '')}.")


def _groups_format(groups: Tensor) -> Tensor:
    """Reshape groups to correspond to preds and target."""
    return groups.reshape(groups.shape[0], -1)


def _binary_groups_stat_counts(
    preds: Tensor,
    target: Tensor,
    groups: Tensor,
    num_groups: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-group ``(tp, fp, tn, fn)``, each an int32 ``(num_groups,)`` tensor."""
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, "global", ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, "global", ignore_index)
        _groups_validation(groups, num_groups)
    preds, target = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    g = _groups_format(groups).reshape(-1)
    p, t = preds.reshape(-1), target.reshape(-1)
    member = (g[:, None] == torch.arange(num_groups, device=g.device)[None, :]) & (t >= 0)[:, None]  # (N, G)

    def count(cell: Tensor) -> Tensor:
        return (member & cell[:, None]).sum(0, dtype=torch.int32)

    return count((p == 1) & (t == 1)), count((p == 1) & (t == 0)), count((p == 0) & (t == 0)), count((p == 0) & (t == 1))


def _groups_reduce(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Dict[str, Tensor]:
    """Each group's tp/fp/tn/fn rates, keyed ``group_{i}``."""
    stats = torch.stack([tp, fp, tn, fn], dim=1)
    rates = stats / torch.clamp(stats.sum(1, keepdim=True, dtype=stats.dtype), min=1)
    return {f"group_{group}": rates[group] for group in range(stats.shape[0])}


def binary_groups_stat_rates(
    preds: Tensor,
    target: Tensor,
    groups: Tensor,
    num_groups: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, Tensor]:
    """True/false positive/negative rates by group."""
    preds, target = _to_tensors(preds, target)
    groups = _to_tensor(groups, preds.device)
    return _groups_reduce(*_binary_groups_stat_counts(preds, target, groups, num_groups, threshold, ignore_index, validate_args))


def _ratio_of_extremes(prefix: str, rates: Tensor) -> Dict[str, Tensor]:
    """``{f"{prefix}_{argmin}_{argmax}": rates[argmin] / rates[argmax]}`` (two host reads)."""
    lo, hi = int(torch.argmin(rates)), int(torch.argmax(rates))
    return {f"{prefix}_{lo}_{hi}": _safe_divide(rates[lo], rates[hi])}


def _compute_binary_demographic_parity(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Dict[str, Tensor]:
    """Demographic parity: the lowest positivity rate over the highest."""
    return _ratio_of_extremes("DP", _safe_divide(tp + fp, tp + fp + tn + fn))


def _compute_binary_equal_opportunity(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Dict[str, Tensor]:
    """Equal opportunity: the lowest true positive rate over the highest."""
    return _ratio_of_extremes("EO", _safe_divide(tp, tp + fn))


def _num_groups(groups: Tensor) -> int:
    """The number of distinct group ids (a host read), as the JAX functionals count them."""
    return int(torch.unique(groups).numel())


def demographic_parity(
    preds: Tensor,
    groups: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, Tensor]:
    """Demographic parity ratio."""
    return binary_fairness(preds, None, groups, "demographic_parity", threshold, ignore_index, validate_args)


def equal_opportunity(
    preds: Tensor,
    target: Tensor,
    groups: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, Tensor]:
    """Equal opportunity ratio."""
    return binary_fairness(preds, target, groups, "equal_opportunity", threshold, ignore_index, validate_args)


def _check_fairness_task(task: str) -> None:
    if task not in ("demographic_parity", "equal_opportunity", "all"):
        raise ValueError(
            f"Expected argument `task` to either be ``demographic_parity``,"
            f"``equal_opportunity`` or ``all`` but got {task}."
        )


def _fairness_target(task: str, preds: Tensor, target: Optional[Tensor]) -> Tensor:
    """The target a fairness task scores against: all zeros for demographic
    parity (which needs none), else the given one."""
    if task == "demographic_parity":
        return torch.zeros(preds.shape, dtype=torch.int32, device=preds.device)
    if target is None:
        raise ValueError(f"The task {task} requires a target.")
    return _to_tensor(target, preds.device)


def _fairness_ratios(task: str, tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Dict[str, Tensor]:
    """The ratios ``task`` asks for, from the per-group counts."""
    out: Dict[str, Tensor] = {}
    if task in ("demographic_parity", "all"):
        out.update(_compute_binary_demographic_parity(tp, fp, tn, fn))
    if task in ("equal_opportunity", "all"):
        out.update(_compute_binary_equal_opportunity(tp, fp, tn, fn))
    return out


def binary_fairness(
    preds: Tensor,
    target: Optional[Tensor],
    groups: Tensor,
    task: str = "all",
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, Tensor]:
    """Demographic parity and/or equal opportunity."""
    _check_fairness_task(task)
    if task == "demographic_parity" and target is not None:
        rank_zero_warn("The task demographic_parity does not require a target.", UserWarning)
    preds = _to_tensor(preds)
    groups = _to_tensor(groups, preds.device)
    target = _fairness_target(task, preds, target)
    counts = _binary_groups_stat_counts(preds, target, groups, _num_groups(groups), threshold, ignore_index, validate_args)
    return _fairness_ratios(task, *counts)
