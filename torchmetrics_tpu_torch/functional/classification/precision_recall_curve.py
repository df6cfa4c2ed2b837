# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Precision-recall curve kernels, binned mode (counterpart of
``torchmetrics_tpu/functional/classification/precision_recall_curve.py``).

With ``thresholds`` given, the state is the static ``(T, 2, 2)`` /
``(T, C, 2, 2)`` int32 multi-threshold confusion tensor. The hand kernel K1
(:func:`~torchmetrics_tpu_torch.ops.binned_curve_state`) writes it in one
launch: the histogram of ``(#{thresholds <= p}, class, target)`` and its
prefix sum over the bins, the JAX package's bucketize formulation. An
integer ``thresholds`` builds the grid with :func:`_linspace_like_jax`, so
both packages bin against the same float32 values.

The exact mode (``thresholds=None``) is not ported yet (ROADMAP A4a).
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.ops import binned_curve_state
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.compute import _linspace_like_jax, _safe_divide, normalize_logits_if_needed
from torchmetrics_tpu_torch.utilities.data import _to_tensors

Tensor = torch.Tensor
ThresholdsArg = Optional[Union[int, List[float], Tensor, np.ndarray]]
Affine = Optional[Tuple[float, float]]

_EXACT_MODE_MESSAGE = (
    "thresholds=None (the exact, unbinned curve) is not ported to the PyTorch package yet (ROADMAP A4a);"
    " pass thresholds=<int|list|tensor> for the binned curve"
)


def _require_binned(thresholds: ThresholdsArg) -> None:
    if thresholds is None:
        raise NotImplementedError(_EXACT_MODE_MESSAGE)


def _adjust_threshold_arg(thresholds: ThresholdsArg = None, device: Union[str, torch.device, None] = None) -> Optional[Tensor]:
    """Convert an int/list/array threshold arg to a float32 tensor on ``device``.

    An int ``T`` is the grid ``jnp.linspace(0, 1, T)`` bit for bit. Arrays
    become float32, as the JAX package (64-bit types off) makes them.
    """
    if isinstance(thresholds, int):
        return _linspace_like_jax(0.0, 1.0, thresholds, device=device)
    if isinstance(thresholds, list):
        return torch.tensor(thresholds, dtype=torch.float32, device=device)
    if isinstance(thresholds, Tensor):
        out = thresholds.to(device) if device is not None else thresholds
        return out.to(torch.float32) if out.dtype == torch.float64 else out
    if thresholds is not None:
        arr = np.asarray(thresholds)
        return torch.tensor(arr.astype(np.float32) if arr.dtype == np.float64 else arr, device=device)
    return None


def _float32_inputs(preds: Tensor) -> Tensor:
    """float64 predictions become float32, as ``jnp.asarray`` makes them with 64-bit types off."""
    return preds.to(torch.float32) if preds.dtype == torch.float64 else preds


def _thresholds_ascend(thresholds: Optional[Tensor]) -> bool:
    """Whether ``thresholds`` already ascend (any NaN last), so K1 can take
    them unsorted. Reads one flag back to the host: asked once, where a
    metric fixes its grid, never per batch."""
    if thresholds is None or thresholds.numel() < 2:
        return True
    lo, hi = thresholds[:-1], thresholds[1:]
    return bool(torch.all((lo <= hi) | torch.isnan(hi)))


def _uniform_bin_margin_ok(thr: np.ndarray) -> bool:
    """True when the 3-compare affine bin index is provably exact for the
    grid ``thr`` (sorted, float64 here): a copy of the JAX package's
    ``_uniform_bin_margin_ok``, which the port may not import.

    The affine index computes ``k = trunc((p - lo) * scale)`` in float32 and
    corrects it with three ordered compares, so it is exact iff the true
    count ``s(p) = #{t: thr[t] <= p}`` always lies in ``[k, k+3]``. With a
    relative error budget of ``2^-20`` on the affine map, sufficient
    conditions, checkable per grid point:

    - upper: ``thr[k+3] >= lo + (k+1)(1+2^-20)/scale`` for every k;
    - lower: ``thr[k-1] <= lo + k(1-2^-20)/scale`` for every k.

    A ``linspace`` grid passes with huge slack; an irregular grid fails and
    takes the binary search.
    """
    len_t = thr.shape[0]
    if len_t < 2:
        return False
    lo, hi = float(thr[0]), float(thr[-1])
    if not np.isfinite(thr).all() or hi <= lo:
        return False
    eps = 2.0**-20
    scale = (len_t - 1) / (hi - lo)
    k = np.arange(0, len_t - 3, dtype=np.float64)
    if len(k) and not np.all(thr[3:] >= lo + (k + 1) * (1 + eps) / scale):
        return False
    k = np.arange(1, len_t, dtype=np.float64)
    return bool(np.all(thr[:-1] <= lo + k * (1 - eps) / scale))


def _uniform_grid(thresholds: ThresholdsArg) -> Affine:
    """``(lo, scale)`` of K1's affine bin index where it is exact on this grid
    (sorted, and :func:`_uniform_bin_margin_ok`), else ``None``: K1 then
    searches the thresholds. ``scale`` is ``(T - 1) / (hi - lo)`` in float64;
    the kernel takes it in float32, as JAX's ``_threshold_bins`` does.

    Reads the grid on the host (an int builds it there): asked once, where a
    metric fixes its grid, never per batch.
    """
    if thresholds is None:
        return None
    if isinstance(thresholds, int):
        thresholds = _linspace_like_jax(0.0, 1.0, thresholds)
    if isinstance(thresholds, Tensor):
        thresholds = thresholds.detach().cpu().numpy()
    thr = np.asarray(thresholds, dtype=np.float64)
    if thr.ndim != 1 or thr.size == 0 or np.any(np.diff(thr) < 0) or not _uniform_bin_margin_ok(thr):
        return None
    return float(thr[0]), (thr.shape[0] - 1) / float(thr[-1] - thr[0])


def _binned_curve_state(
    preds: Tensor,
    target: Tensor,
    thresholds: Tensor,
    labels: bool = False,
    ascending: bool = False,
    affine: Affine = None,
) -> Tensor:
    """The ``(T, ..., 2, 2)`` int32 binned confusion state from flat probabilities.

    ``[t, ..., y, p]`` counts entries with ``target == y`` and
    ``(pred >= thresholds[t]) == p``, skipping entries whose target is
    negative. ``preds`` is ``(N,)`` or ``(N, C)``. With ``labels`` the target
    is ``(N,)`` class indices and ``y`` is the one-hot of the clipped label
    (the multiclass path, without building the one-hot); otherwise it has
    ``preds``' shape and ``y = clip(target, 0, 1)``.

    JAX's ``_binned_curve_state(preds, target_bin, valid, thresholds)`` takes
    an explicit ``valid`` mask; every caller there passes ``target >= 0``,
    which the port reads from the target itself.

    The kernel needs ascending thresholds. Unless the caller says they
    already ascend (``ascending``, see :func:`_thresholds_ascend`), they are
    sorted first and the state's threshold axis is put back in the caller's
    order after; each count depends only on its own threshold's value, so
    the result is the same for any order. ``affine`` (from
    :func:`_uniform_grid`, for an ascending grid) lets the kernel bin in O(1).
    """
    len_t = thresholds.shape[0]
    inner = tuple(preds.shape[1:])
    p = preds.reshape(preds.shape[0], -1).to(torch.float32)
    tgt = target.reshape(-1) if labels else target.reshape(p.shape)
    thr = thresholds.to(torch.float32)
    order = None
    if not ascending:
        thr, order = torch.sort(thr, stable=True)
        affine = None
    state = binned_curve_state(p, thr, tgt, labels, affine)  # (T, K, 2, 2): [t, k, target, pred]
    if order is not None:
        state = torch.empty_like(state).index_copy_(0, order, state)
    return state.reshape((len_t,) + inner + (2, 2))


# ---------------------------------------------------------------------- binary


def _binary_precision_recall_curve_arg_validation(thresholds: ThresholdsArg = None, ignore_index: Optional[int] = None) -> None:
    """Validate non-tensor args."""
    if thresholds is not None and not isinstance(thresholds, (list, int, np.ndarray, Tensor)):
        raise ValueError(
            "Expected argument `thresholds` to either be an integer, list of floats or"
            f" tensor of floats, but got {thresholds}"
        )
    if isinstance(thresholds, int) and thresholds < 2:
        raise ValueError(f"If argument `thresholds` is an integer, expected it to be larger than 1, but got {thresholds}")
    if isinstance(thresholds, list) and not all(isinstance(t, float) and 0 <= t <= 1 for t in thresholds):
        raise ValueError(
            "If argument `thresholds` is a list, expected all elements to be floats in the [0,1] range,"
            f" but got {thresholds}"
        )
    if isinstance(thresholds, (np.ndarray, Tensor)) and thresholds.ndim != 1:
        raise ValueError("If argument `thresholds` is an tensor, expected the tensor to be 1d")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _binary_precision_recall_curve_tensor_validation(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> None:
    """Validate tensor inputs (reads values back to the host)."""
    _check_same_shape(preds, target)
    if not preds.is_floating_point():
        raise ValueError(f"Expected argument `preds` to be an floating tensor, but got tensor with dtype {preds.dtype}")
    ok = (target == 0) | (target == 1)
    if ignore_index is not None:
        ok = ok | (target == ignore_index)
    if not bool(torch.all(ok)):
        raise RuntimeError(
            f"Detected the following values in `target`: {torch.unique(target)} but expected only"
            f" the following values {[0, 1] + ([ignore_index] if ignore_index is not None else [])}."
        )


def _binary_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """Flatten + sigmoid; ignored targets become -1."""
    _require_binned(thresholds)
    preds = normalize_logits_if_needed(_float32_inputs(preds).reshape(-1), "sigmoid")
    target = target.reshape(-1).to(torch.int32)
    if ignore_index is not None:
        target = torch.where(target == ignore_index, torch.full_like(target, -1), target)
    return preds, target, _adjust_threshold_arg(thresholds, preds.device)


def _binary_precision_recall_curve_update(
    preds: Tensor, target: Tensor, thresholds: Optional[Tensor], ascending: bool = False, affine: Affine = None
) -> Tensor:
    """Binned: the (T, 2, 2) state from one K1 launch. ``ascending``: the
    thresholds are known to ascend, so they are not sorted again; ``affine``:
    see :func:`_uniform_grid`."""
    _require_binned(thresholds)
    return _binned_curve_state(preds, target, thresholds, ascending=ascending, affine=affine)


def _binary_precision_recall_curve_compute(state: Tensor, thresholds: Optional[Tensor], pos_label: int = 1) -> Tuple[Tensor, Tensor, Tensor]:
    """Final curve from the binned state."""
    _require_binned(thresholds)
    tps = state[:, 1, 1]
    fps = state[:, 0, 1]
    fns = state[:, 1, 0]
    precision = _safe_divide(tps, tps + fps)
    recall = _safe_divide(tps, tps + fns)
    precision = torch.cat([precision, torch.ones(1, dtype=precision.dtype, device=precision.device)])
    recall = torch.cat([recall, torch.zeros(1, dtype=recall.dtype, device=recall.device)])
    return precision, recall, thresholds


def binary_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Binary precision-recall curve (binned)."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    ascending = isinstance(thresholds, int)  # the linspace grid
    affine = _uniform_grid(thresholds) if ascending else None
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds, ascending, affine)
    return _binary_precision_recall_curve_compute(state, thresholds)


# ------------------------------------------------------------------ multiclass


def _multiclass_precision_recall_curve_arg_validation(
    num_classes: int,
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    average: Optional[str] = None,
) -> None:
    """Validate non-tensor args."""
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    if average not in (None, "micro", "macro"):
        raise ValueError(f"Expected argument `average` to be one of None, 'micro' or 'macro', but got {average}")
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)


def _multiclass_precision_recall_curve_tensor_validation(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    """Validate tensor inputs (reads values back to the host)."""
    if not preds.ndim == target.ndim + 1:
        raise ValueError(
            f"Expected `preds` to have one more dimension than `target` but got {preds.ndim} and {target.ndim}"
        )
    if not preds.is_floating_point():
        raise ValueError(f"Expected `preds` to be a float tensor, but got {preds.dtype}")
    if preds.shape[1] != num_classes:
        raise ValueError(
            f"Expected `preds.shape[1]` to be equal to the number of classes but got {preds.shape[1]} and {num_classes}."
        )
    if preds.shape[0] != target.shape[0] or preds.shape[2:] != target.shape[1:]:
        raise ValueError("Expected the shape of `preds` should be (N, C, ...) and the shape of `target` should be (N, ...).")
    ok = (target >= 0) & (target < num_classes)
    if ignore_index is not None:
        ok = ok | (target == ignore_index)
    if not bool(torch.all(ok)):
        raise RuntimeError(
            f"Detected values in `target` outside the expected range [0, {num_classes - 1}]"
            + (f" (or ignore_index={ignore_index})" if ignore_index is not None else "")
            + f". Found values: {torch.unique(target)}."
        )


def _multiclass_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    average: Optional[str] = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """To ``(M, C)`` probs + ``(M,)`` int32 target with ignored = -1."""
    _require_binned(thresholds)
    preds = torch.movedim(_float32_inputs(preds), 1, -1).reshape(-1, num_classes)
    target = target.reshape(-1).to(torch.int32)
    preds = normalize_logits_if_needed(preds, "softmax")
    if ignore_index is not None:
        target = torch.where(target == ignore_index, torch.full_like(target, -1), target)
    if average == "micro":
        # one-vs-rest flattening: ignored samples propagate -1 to every class slot
        valid = target >= 0
        target_oh = torch.nn.functional.one_hot(target.to(torch.int64).clamp(0, num_classes - 1), num_classes).to(torch.int32)
        target_oh = torch.where(valid[:, None], target_oh, torch.full_like(target_oh, -1))
        preds = preds.reshape(-1)
        target = target_oh.reshape(-1)
    return preds, target, _adjust_threshold_arg(thresholds, preds.device)


def _multiclass_precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Optional[Tensor],
    average: Optional[str] = None,
    ascending: bool = False,
    affine: Affine = None,
) -> Tensor:
    """Binned: the (T, C, 2, 2) confusion tensor from one K1 launch (labels
    mode). ``ascending`` and ``affine`` as in :func:`_binary_precision_recall_curve_update`."""
    _require_binned(thresholds)
    if average == "micro":
        return _binary_precision_recall_curve_update(preds, target, thresholds, ascending, affine)
    return _binned_curve_state(preds, target, thresholds, labels=True, ascending=ascending, affine=affine)


def _multiclass_precision_recall_curve_compute(
    state: Tensor,
    num_classes: int,
    thresholds: Optional[Tensor],
    average: Optional[str] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Final per-class curves from the binned state."""
    if average == "micro":
        return _binary_precision_recall_curve_compute(state, thresholds)
    _require_binned(thresholds)
    tps = state[:, :, 1, 1]
    fps = state[:, :, 0, 1]
    fns = state[:, :, 1, 0]
    precision = _safe_divide(tps, tps + fps)
    recall = _safe_divide(tps, tps + fns)
    precision = torch.cat([precision, torch.ones((1, num_classes), dtype=precision.dtype, device=precision.device)])
    recall = torch.cat([recall, torch.zeros((1, num_classes), dtype=recall.dtype, device=recall.device)])
    return precision.T, recall.T, thresholds


def multiclass_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: ThresholdsArg = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Multiclass precision-recall curve (binned)."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index, average)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    ascending = isinstance(thresholds, int)  # the linspace grid
    affine = _uniform_grid(thresholds) if ascending else None
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index, average
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, average, ascending, affine)
    return _multiclass_precision_recall_curve_compute(state, num_classes, thresholds, average)

