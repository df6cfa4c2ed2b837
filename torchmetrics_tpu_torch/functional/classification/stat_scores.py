# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""stat_scores: the root state machine of the classification suite
(counterpart of ``torchmetrics_tpu/functional/classification/stat_scores.py``).

Binary, multiclass and multilabel. Ignored positions are masked
arithmetically, as in the JAX package, so shapes never depend on the data. The multiclass
confusion-matrix branch runs in the hand kernel K2
(:func:`~torchmetrics_tpu_torch.ops.stat_counts`), which takes the float
scores and writes tp/fp/tn/fn in one launch, the argmax fused in; the micro
fast path and the one-hot path (``top_k > 1`` or samplewise) are plain
PyTorch, as they are plain ``jnp`` in JAX, and so are the multilabel counts
(elementwise compares and sums). Every count is int32, as in JAX.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.ops import stat_counts
from torchmetrics_tpu_torch.utilities.checks import _check_binary_target, _check_same_shape, _is_concrete
from torchmetrics_tpu_torch.utilities.compute import normalize_logits_if_needed
from torchmetrics_tpu_torch.utilities.data import _float32_inputs, _to_tensors, select_topk
from torchmetrics_tpu_torch.utilities.enums import ClassificationTask

Tensor = torch.Tensor
_I32 = torch.int32

# ---------------------------------------------------------------------- binary


def _binary_stat_scores_arg_validation(
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    zero_division: float = 0,
) -> None:
    """Validate non-tensor args."""
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")
    allowed_multidim_average = ("global", "samplewise")
    if multidim_average not in allowed_multidim_average:
        raise ValueError(
            f"Expected argument `multidim_average` to be one of {allowed_multidim_average}, but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")
    if zero_division not in [0, 1]:
        raise ValueError(f"Expected argument `zero_division` to be 0 or 1, but got {zero_division}.")


def _binary_stat_scores_tensor_validation(
    preds: Tensor,
    target: Tensor,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    """Validate tensor shapes/values (reads values back to the host)."""
    _check_same_shape(preds, target)
    if multidim_average != "global" and preds.ndim < 2:
        raise ValueError("Expected input to be at least 2D when multidim_average is set to `samplewise`")
    if _is_concrete(target):
        _check_binary_target(target, ignore_index)
    if not preds.is_floating_point() and _is_concrete(preds) and not bool(torch.all((preds == 0) | (preds == 1))):
        raise RuntimeError(
            "Detected non-floating point predictions that are not binary. If you want to"
            " use logits or probabilities, please pass a float tensor."
        )


def _binary_stat_scores_format(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """Flatten to ``(N, X)`` and threshold probabilities; ignored targets become -1."""
    if preds.is_floating_point():
        preds = normalize_logits_if_needed(preds, "sigmoid")
        preds = (preds > threshold).to(_I32)
    preds = preds.reshape(preds.shape[0], -1).to(_I32)
    target = target.reshape(target.shape[0], -1).to(_I32)
    if ignore_index is not None:
        target = torch.where(target == ignore_index, torch.full_like(target, -1), target)
    return preds, target


def _binary_stat_scores_update(
    preds: Tensor,
    target: Tensor,
    multidim_average: str = "global",
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Count tp/fp/tn/fn (int32) with masked arithmetic."""
    valid = target >= 0
    dims: Union[Tuple[int, ...], int] = tuple(range(target.ndim)) if multidim_average == "global" else 1
    tp = ((target == preds) & (target == 1) & valid).sum(dims, dtype=_I32)
    fn = ((target != preds) & (target == 1) & valid).sum(dims, dtype=_I32)
    fp = ((target != preds) & (target == 0) & valid).sum(dims, dtype=_I32)
    tn = ((target == preds) & (target == 0) & valid).sum(dims, dtype=_I32)
    return tp, fp, tn, fn


def _binary_stat_scores_compute(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, multidim_average: str = "global") -> Tensor:
    """Stack into ``[tp, fp, tn, fn, sup]``."""
    return torch.stack([tp, fp, tn, fn, tp + fn], dim=0 if multidim_average == "global" else -1).squeeze()


def binary_stat_scores(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Compute tp/fp/tn/fn/support for binary tasks."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, multidim_average, ignore_index)
    preds, target = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    tp, fp, tn, fn = _binary_stat_scores_update(preds, target, multidim_average)
    return _binary_stat_scores_compute(tp, fp, tn, fn, multidim_average)


# ------------------------------------------------------------------ multiclass


def _multiclass_stat_scores_arg_validation(
    num_classes: int,
    top_k: int = 1,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    zero_division: float = 0,
) -> None:
    """Validate non-tensor args."""
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    if not isinstance(top_k, int) or top_k < 1:
        raise ValueError(f"Expected argument `top_k` to be an integer larger than or equal to 1, but got {top_k}")
    if top_k > num_classes:
        raise ValueError(
            f"Expected argument `top_k` to be smaller or equal to `num_classes` but got {top_k} and {num_classes}"
        )
    allowed_average = ("micro", "macro", "weighted", "none", None)
    if average not in allowed_average:
        raise ValueError(f"Expected argument `average` to be one of {allowed_average}, but got {average}")
    allowed_multidim_average = ("global", "samplewise")
    if multidim_average not in allowed_multidim_average:
        raise ValueError(
            f"Expected argument `multidim_average` to be one of {allowed_multidim_average}, but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")
    if zero_division not in [0, 1]:
        raise ValueError(f"Expected argument `zero_division` to be 0 or 1, but got {zero_division}.")


def _multiclass_stat_scores_tensor_validation(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    """Validate tensor shapes/values (reads values back to the host)."""
    if preds.ndim == target.ndim + 1:
        if not preds.is_floating_point():
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if preds.shape[1] != num_classes:
            raise ValueError(
                "If `preds` have one dimension more than `target`, `preds.shape[1]` should be"
                " equal to number of classes."
            )
        if preds.shape[2:] != target.shape[1:]:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should be"
                " (N, C, ...), and the shape of `target` should be (N, ...)."
            )
        if multidim_average != "global" and preds.ndim < 3:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should "
                " at least 3D when multidim_average is set to `samplewise`"
            )
    elif preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError(
                "The `preds` and `target` should have the same shape,"
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
            )
        if multidim_average != "global" and preds.ndim < 2:
            raise ValueError(
                "When `preds` and `target` have the same shape, the shape of `preds` should "
                " at least 2D when multidim_average is set to `samplewise`"
            )
    else:
        raise ValueError(
            "Either `preds` and `target` both should have the (same) shape (N, ...), or `target` should be (N, ...)"
            " and `preds` should be (N, C, ...)."
        )
    if not _is_concrete(target):
        return
    check_value = num_classes if ignore_index is None else num_classes + 1
    checks = ((target, "target"),) + (((preds, "preds"),) if not preds.is_floating_point() else ())
    for t, name in checks:
        unique_values = torch.unique(t)
        if len(unique_values) > check_value:
            raise RuntimeError(
                f"Detected more unique values in `{name}` than expected. Expected only {check_value} but found"
                f" {len(unique_values)} in `{name}`. Found values: {unique_values}."
            )
        in_range = (t >= 0) & (t < num_classes)
        if ignore_index is not None:
            in_range = in_range | (t == ignore_index)
        if not bool(torch.all(in_range)):
            raise RuntimeError(
                f"Detected values in `{name}` outside the expected range [0, {num_classes - 1}]"
                + (f" (or ignore_index={ignore_index})" if ignore_index is not None else "")
                + f". Found values: {unique_values}."
            )


def _multiclass_stat_scores_format(
    preds: Tensor,
    target: Tensor,
    top_k: int = 1,
    average: Optional[str] = "micro",
    multidim_average: str = "global",
) -> Tuple[Tensor, Tensor]:
    """Argmax probabilities (first maximum wins, as ``jnp.argmax``) and flatten extra dims.

    Where the update's confusion-matrix branch will count them (``top_k == 1``,
    ``multidim_average == "global"``, ``average != "micro"``), float scores
    stay un-argmaxed: ``(M, C)`` float32 scores and an ``(M,)`` target go to K2,
    which fuses the argmax (float64 scores become float32, as ``jnp.asarray``
    makes them with 64-bit types off). The defaults argmax, as the JAX function does.
    """
    if preds.ndim == target.ndim + 1 and top_k == 1:
        if multidim_average == "global" and average != "micro":
            scores = torch.movedim(preds, 1, -1).reshape(-1, preds.shape[1])
            return scores.to(torch.float32), target.reshape(-1)
        preds = torch.argmax(preds, dim=1)
    preds = preds.reshape(*preds.shape[:2], -1) if top_k != 1 else preds.reshape(preds.shape[0], -1)
    target = target.reshape(target.shape[0], -1)
    return preds, target


def _multiclass_stat_scores_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    top_k: int = 1,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """tp/fp/tn/fn (int32): one-hot path, micro fast path, or K2 (label
    pairs, or ``(M, C)`` scores with an ``(M,)`` target from the format)."""
    if multidim_average == "samplewise" or top_k != 1:
        ignore_mask = (target == ignore_index) if ignore_index is not None else None
        if top_k > 1:
            preds_oh = torch.movedim(select_topk(preds, topk=top_k, dim=1), 1, -1)
        else:
            preds_clipped = preds.to(torch.int64).clamp(0, num_classes - 1)
            preds_oh = torch.nn.functional.one_hot(preds_clipped, num_classes).to(_I32)
            if ignore_mask is not None and not (0 <= ignore_index <= num_classes - 1):
                # positions where *preds* equal an out-of-range ignore_index one-hot nowhere
                preds_oh = torch.where((preds == ignore_index)[..., None], torch.zeros_like(preds_oh), preds_oh)
        target_clipped = target.to(torch.int64).clamp(0, num_classes - 1)
        target_oh = torch.nn.functional.one_hot(target_clipped, num_classes).to(_I32)
        if ignore_mask is not None:
            # ignored positions match neither the ==1 nor the ==0 comparisons
            target_oh = torch.where(ignore_mask[..., None], torch.full_like(target_oh, -1), target_oh)
        sum_dims = (0, 1) if multidim_average == "global" else (1,)
        tp = ((target_oh == preds_oh) & (target_oh == 1)).sum(sum_dims, dtype=_I32)
        fn = ((target_oh != preds_oh) & (target_oh == 1)).sum(sum_dims, dtype=_I32)
        fp = ((target_oh != preds_oh) & (target_oh == 0)).sum(sum_dims, dtype=_I32)
        tn = ((target_oh == preds_oh) & (target_oh == 0)).sum(sum_dims, dtype=_I32)
        return tp, fp, tn, fn
    if average == "micro":
        preds = preds.reshape(-1)
        target = target.reshape(-1)
        valid = target != ignore_index if ignore_index is not None else torch.ones_like(target, dtype=torch.bool)
        tp = ((preds == target) & valid).sum(dtype=_I32)
        fp = ((preds != target) & valid).sum(dtype=_I32)
        fn = fp
        tn = num_classes * valid.sum(dtype=_I32) - (fp + fn + tp)
        return tp, fp, tn, fn
    if preds.ndim != target.ndim + 1:
        preds, target = preds.reshape(-1), target.reshape(-1)
    tp, fp, tn, fn = stat_counts(preds, target, num_classes, ignore_index)
    return tp, fp, tn, fn


def _multiclass_stat_scores_compute(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
) -> Tensor:
    """Stack stats + support and apply the average strategy."""
    res = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    sum_dim = 0 if multidim_average == "global" else 1
    if average == "micro":
        return res.sum(sum_dim, dtype=res.dtype) if res.ndim > 1 else res
    if average == "macro":
        return res.to(torch.float32).mean(sum_dim)
    if average == "weighted":
        weight = (tp + fn).to(torch.float32)
        if multidim_average == "global":
            return (res * (weight / weight.sum()).reshape(*weight.shape, 1)).sum(sum_dim)
        return (res * (weight / weight.sum(-1, keepdim=True)).reshape(*weight.shape, 1)).sum(sum_dim)
    if average is None or average == "none":
        return res
    return None


def multiclass_stat_scores(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Compute tp/fp/tn/fn/support for multiclass tasks."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    preds, target = _multiclass_stat_scores_format(preds, target, top_k, average, multidim_average)
    tp, fp, tn, fn = _multiclass_stat_scores_update(preds, target, num_classes, top_k, average, multidim_average, ignore_index)
    return _multiclass_stat_scores_compute(tp, fp, tn, fn, average, multidim_average)


# ------------------------------------------------------------------ multilabel


def _multilabel_stat_scores_arg_validation(
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    zero_division: float = 0,
) -> None:
    """Validate non-tensor args."""
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float, but got {threshold}.")
    allowed_average = ("micro", "macro", "weighted", "none", None)
    if average not in allowed_average:
        raise ValueError(f"Expected argument `average` to be one of {allowed_average}, but got {average}")
    allowed_multidim_average = ("global", "samplewise")
    if multidim_average not in allowed_multidim_average:
        raise ValueError(
            f"Expected argument `multidim_average` to be one of {allowed_multidim_average}, but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")
    if zero_division not in [0, 1]:
        raise ValueError(f"Expected argument `zero_division` to be 0 or 1, but got {zero_division}.")


def _multilabel_stat_scores_tensor_validation(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    """Validate tensor shapes/values (reads values back to the host)."""
    _check_same_shape(preds, target)
    if preds.ndim < 2:
        raise ValueError(f"Expected both `preds` and `target` to be at least 2D, but got {preds.ndim}D")
    if preds.shape[1] != num_labels:
        raise ValueError(
            f"Expected both `preds` and `target` to have second dimension equal to `num_labels`={num_labels},"
            f" but got {preds.shape[1]}"
        )
    if multidim_average != "global" and preds.ndim < 3:
        raise ValueError("Expected input to be at least 3D when multidim_average is set to `samplewise`")
    if _is_concrete(target):
        _check_binary_target(target, ignore_index)


def _multilabel_stat_scores_format(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """Threshold probabilities (sigmoid first where some value lies outside
    [0, 1]) and flatten to ``(N, L, X)`` int32; ignored targets become -1."""
    if preds.is_floating_point():
        preds = normalize_logits_if_needed(_float32_inputs(preds), "sigmoid")
        preds = preds > threshold
    preds = preds.reshape(*preds.shape[:2], -1).to(_I32)
    target = target.reshape(*target.shape[:2], -1).to(_I32)
    if ignore_index is not None:
        target = torch.where(target == ignore_index, torch.full_like(target, -1), target)
    return preds, target


def _multilabel_stat_scores_update(
    preds: Tensor,
    target: Tensor,
    multidim_average: str = "global",
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-label int32 counts with masked arithmetic: ``(L,)`` global, ``(N, L)`` samplewise."""
    valid = target >= 0
    sum_dims = (0, -1) if multidim_average == "global" else (-1,)
    tp = ((target == preds) & (target == 1) & valid).sum(sum_dims, dtype=_I32)
    fn = ((target != preds) & (target == 1) & valid).sum(sum_dims, dtype=_I32)
    fp = ((target != preds) & (target == 0) & valid).sum(sum_dims, dtype=_I32)
    tn = ((target == preds) & (target == 0) & valid).sum(sum_dims, dtype=_I32)
    return tp, fp, tn, fn


#: stack stats + support and apply the average strategy, as for multiclass
_multilabel_stat_scores_compute = _multiclass_stat_scores_compute


def multilabel_stat_scores(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Compute tp/fp/tn/fn/support for multilabel tasks."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    tp, fp, tn, fn = _multilabel_stat_scores_update(preds, target, multidim_average)
    return _multilabel_stat_scores_compute(tp, fp, tn, fn, average, multidim_average)


# ------------------------------------------------------------------- dispatch


def stat_scores(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: str = "global",
    top_k: int = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching stat_scores."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_stat_scores(preds, target, threshold, multidim_average, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        if not isinstance(top_k, int):
            raise ValueError(f"`top_k` is expected to be `int` but `{type(top_k)} was passed.`")
        return multiclass_stat_scores(preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args)
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_stat_scores(preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args)
    raise ValueError(f"Not handled value: {task}")
