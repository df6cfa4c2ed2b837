# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Permutation invariant training (counterpart of ``torchmetrics_tpu/functional/audio/pit.py``).

The pairwise metric matrix is one batched metric call over every
(target, pred) speaker pair; the exhaustive search gathers over the table
of permutations and takes ``argmax``/``argmin``, the first index of a tie,
as ``jnp``'s do. From 3 speakers (where scipy is importable) the best
permutation is scipy's ``linear_sum_assignment`` on the host, as in JAX.
"""
from __future__ import annotations

from itertools import permutations
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.utilities.data import _to_tensors

Tensor = torch.Tensor

_ps_dict: Dict[Tuple[int, str], Tensor] = {}


def _gen_permutations(spk_num: int, device: torch.device) -> Tensor:
    """``(perm_num, spk_num)`` int64: every speaker permutation, cached per device."""
    key = (spk_num, str(device))
    if key not in _ps_dict:
        _ps_dict[key] = torch.tensor(list(permutations(range(spk_num))), dtype=torch.int64, device=device)
    return _ps_dict[key]


def _best(metric_of_ps: Tensor, eval_func: str) -> Tuple[Tensor, Tensor]:
    if eval_func == "max":
        return torch.max(metric_of_ps, dim=1).values, torch.argmax(metric_of_ps, dim=1)
    return torch.min(metric_of_ps, dim=1).values, torch.argmin(metric_of_ps, dim=1)


def _find_best_perm_by_exhaustive_method(metric_mtx: Tensor, eval_func: str) -> Tuple[Tensor, Tensor]:
    """Best permutation by evaluating every permutation."""
    spk_num = metric_mtx.shape[1]
    ps = _gen_permutations(spk_num, metric_mtx.device)  # ps[p, j] = the pred index for target j
    metric_of_ps = torch.mean(metric_mtx[:, torch.arange(spk_num, device=ps.device)[None, :], ps], dim=-1)
    best_metric, best_indexes = _best(metric_of_ps, eval_func)
    return best_metric, ps[best_indexes].to(torch.int32)


def _find_best_perm_by_linear_sum_assignment(metric_mtx: Tensor, eval_func: str) -> Tuple[Tensor, Tensor]:
    """The Hungarian assignment on the host."""
    from scipy.optimize import linear_sum_assignment

    mmtx = metric_mtx.detach().cpu().numpy()
    best_perm = torch.tensor(
        np.array([linear_sum_assignment(pwm, eval_func == "max")[1] for pwm in mmtx]), dtype=torch.int32,
        device=metric_mtx.device,
    )
    best_metric = torch.mean(torch.gather(metric_mtx, 2, best_perm[:, :, None].to(torch.int64))[..., 0], dim=-1)
    return best_metric, best_perm


def permutation_invariant_training(
    preds: Tensor,
    target: Tensor,
    metric_func: Callable,
    mode: str = "speaker-wise",
    eval_func: str = "max",
    **kwargs: Any,
) -> Tuple[Tensor, Tensor]:
    """``(best_metric, best_perm)`` of ``(batch, spk, ...)`` inputs; ``best_perm`` int32."""
    preds, target = _to_tensors(preds, target)
    if preds.shape[0:2] != target.shape[0:2]:
        raise RuntimeError(
            "Predictions and targets are expected to have the same shape at the batch and speaker dimensions"
        )
    if eval_func not in ["max", "min"]:
        raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
    if mode not in ["speaker-wise", "permutation-wise"]:
        raise ValueError(f'mode can only be "speaker-wise" or "permutation-wise" but got {mode}')
    if target.ndim < 2:
        raise ValueError(
            f"Inputs must be of shape [batch, spk, ...], got {tuple(target.shape)} and {tuple(preds.shape)} instead"
        )

    batch_size, spk_num = target.shape[0:2]

    if mode == "permutation-wise":
        perms = _gen_permutations(spk_num, preds.device)  # (perm_num, spk_num)
        perm_num = perms.shape[0]
        ppreds = preds[:, perms.reshape(-1), ...].reshape(batch_size * perm_num, *preds.shape[1:])
        ptarget = torch.repeat_interleave(target, perm_num, dim=0)
        metric_of_ps = metric_func(ppreds, ptarget, **kwargs)
        metric_of_ps = torch.mean(metric_of_ps.reshape(batch_size, perm_num, -1), dim=-1)
        best_metric, best_indexes = _best(metric_of_ps, eval_func)
        return best_metric, perms[best_indexes].to(torch.int32)

    # speaker-wise: one batched metric call over all (target, pred) pairs
    rest = preds.shape[2:]
    preds_pairs = preds[:, None, ...].expand(batch_size, spk_num, spk_num, *rest)
    target_pairs = target[:, :, None, ...].expand(batch_size, spk_num, spk_num, *rest)
    metric_mtx = metric_func(
        preds_pairs.reshape(batch_size * spk_num * spk_num, *rest),
        target_pairs.reshape(batch_size * spk_num * spk_num, *rest),
        **kwargs,
    ).reshape(batch_size, spk_num, spk_num)

    try:
        import scipy.optimize  # noqa: F401

        has_scipy = True
    except ImportError:  # pragma: no cover
        has_scipy = False
    if spk_num < 3 or not has_scipy:
        return _find_best_perm_by_exhaustive_method(metric_mtx, eval_func)
    return _find_best_perm_by_linear_sum_assignment(metric_mtx, eval_func)


def pit_permutate(preds: Tensor, perm: Tensor) -> Tensor:
    """Rearrange predictions by the best permutation."""
    preds, perm = _to_tensors(preds, perm)
    index = perm.to(torch.int64).reshape(*perm.shape, *([1] * (preds.ndim - 2))).expand(*perm.shape, *preds.shape[2:])
    return torch.gather(preds, 1, index)
