# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Precision-recall curve kernels (counterpart of
``torchmetrics_tpu/functional/classification/precision_recall_curve.py``).

- **Binned mode** (``thresholds`` given): the state is the static
  ``(T, 2, 2)`` / ``(T, C, 2, 2)`` int32 multi-threshold confusion tensor.
  The hand kernel K1 (:func:`~torchmetrics_tpu_torch.ops.binned_curve_state`)
  writes it in one launch: the histogram of ``(#{thresholds <= p}, column,
  target)`` and its prefix sum over the bins, the JAX package's bucketize
  formulation; labels mode for multiclass, matrix mode for binary, micro and
  multilabel. An integer ``thresholds`` builds the grid with
  :func:`_linspace_like_jax`, so both packages bin against the same float32
  values.
- **Exact mode** (``thresholds=None``): the update only keeps the formatted
  predictions and targets; compute builds the unique-threshold curve with
  the same static-shape program as JAX (:func:`_binary_clf_curve_padded`: a
  stable sort, int32 cumulative counts and a tie-group-end mask), batched
  over classes or labels in one sort. Only the user-facing curve tuples
  boolean-index on the host.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.ops import binned_curve_state, binned_curve_state_segmented
from torchmetrics_tpu_torch.utilities.checks import _check_binary_target, _check_same_shape, _is_concrete
from torchmetrics_tpu_torch.utilities.compute import _linspace_like_jax, _safe_divide, normalize_logits_if_needed
from torchmetrics_tpu_torch.utilities.data import _float32_inputs, _to_tensor, _to_tensors
from torchmetrics_tpu_torch.utilities.enums import _task_call
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor
ThresholdsArg = Optional[Union[int, List[float], Tensor, np.ndarray]]
Affine = Optional[Tuple[float, float]]
CurveState = Union[Tensor, Tuple[Tensor, Tensor]]


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


def _grid_hints(thresholds: ThresholdsArg) -> Tuple[bool, Affine]:
    """Whether the grid is known to ascend (an integer builds the linspace
    grid) and K1's O(1) bin index for it: see ``_uniform_grid``."""
    ascending = isinstance(thresholds, int)
    return ascending, _uniform_grid(thresholds) if ascending else None


def _binned_curve_state(
    preds: Tensor,
    target: Tensor,
    thresholds: Tensor,
    labels: bool = False,
    ascending: bool = False,
    affine: Affine = None,
    cells: Optional[Tensor] = None,
    num_cells: int = 0,
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

    ``cells`` (the sliced plan's K1s route): the ``(num_cells, T, ..., 2, 2)``
    state of each cohort cell, ``cells`` giving the cell of each row of
    ``preds`` (``-1``: dropped).
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
    if cells is not None:
        state = binned_curve_state_segmented(p, thr, tgt, labels, cells, num_cells, affine)  # (cells, T, K, 2, 2)
        if order is not None:
            state = torch.empty_like(state).index_copy_(1, order, state)
        return state.reshape((num_cells, len_t) + inner + (2, 2))
    state = binned_curve_state(p, thr, tgt, labels, affine)  # (T, K, 2, 2): [t, k, target, pred]
    if order is not None:
        state = torch.empty_like(state).index_copy_(0, order, state)
    return state.reshape((len_t,) + inner + (2, 2))


# ------------------------------------------------------------------ exact curve

# Sort codes of the exact curve (see _sort_codes): every NaN ties at the top,
# and an ignored entry sorts just below it, after every valid +inf key.
_NAN_CODE = {torch.float32: 0x7FC00000, torch.float64: 0x7FF8000000000000}
_INF_CODE = {torch.float32: 0x7F800000, torch.float64: 0x7FF0000000000000}
_INT_VIEW = {torch.float32: torch.int32, torch.float64: torch.int64}


def _sort_codes(x: Tensor, valid: Optional[Tensor] = None) -> Tensor:
    """Integer codes whose ascending order is ``x``'s under JAX's sort order.

    JAX's sort canonicalizes floats first: ``-0`` ties ``+0`` and every NaN
    ties at the top. The codes do the same with integer bits, so the order
    is the same on the CPU and on the card whatever either does with NaN or
    signed zeros in a float sort: a non-negative float's bits ascend with
    its value, a negative float's with its value once the magnitude bits are
    flipped. With ``valid`` given, invalid entries take the code just above
    ``+inf``'s: that is where ``jnp.lexsort(((~valid), -key))`` puts the
    ignored entries of the curve, whose key is ``-inf``, after every valid
    entry of the same key and before any valid NaN.
    """
    dtype = x.dtype if x.dtype in _INT_VIEW else torch.float32
    x = torch.where(x == 0, 0.0, x).to(dtype)
    bits = x.view(_INT_VIEW[dtype])
    codes = torch.where(bits >= 0, bits, bits ^ torch.iinfo(bits.dtype).max)
    codes = torch.where(torch.isnan(x), _NAN_CODE[dtype], codes)
    if valid is not None:
        codes = torch.where(valid, codes, _INF_CODE[dtype] + 1)
    return codes


def _clf_curve_padded_rows(
    preds: Tensor, target: Tensor, pos_label: Union[int, Tensor] = 1
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """:func:`_binary_clf_curve_padded` of every row of ``preds`` (R, N), in one sort.

    ``target`` is (R, N), or (N,) shared by every row (the multiclass
    one-vs-rest case, never materialized per row); ``pos_label`` an int or
    an (R, 1) tensor of per-row positive labels. One stable sort of integer
    codes along the rows (:func:`_sort_codes`) gives JAX's order: key
    descending, valid before invalid among equal keys, input order last.
    """
    valid = target >= 0
    # rows contiguous first (preds is often a transpose): the elementwise ops
    # keep their input's layout, and the sort and gathers then read rows
    key = torch.where(valid, preds.contiguous(), float("-inf"))
    order = torch.sort(_sort_codes(-key, valid), dim=-1, stable=True).indices
    k_sorted = key.gather(-1, order)
    t_sorted = target[order] if target.ndim == 1 else target.gather(-1, order)
    v_sorted = t_sorted >= 0
    y_sorted = (t_sorted == pos_label) & v_sorted
    tps = torch.cumsum(y_sorted, -1, dtype=torch.int32)
    fps = torch.cumsum(v_sorted, -1, dtype=torch.int32) - tps
    nxt = torch.cat([k_sorted[..., 1:], torch.full_like(k_sorted[..., :1], float("-inf"))], -1)
    nxt_v = torch.cat([v_sorted[..., 1:], torch.zeros_like(v_sorted[..., :1])], -1)
    is_end = (k_sorted != nxt) | ~nxt_v  # every NaN is a group of its own
    return fps, tps, k_sorted, is_end & v_sorted


def _binary_clf_curve_padded(preds: Tensor, target: Tensor, pos_label: int = 1) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Static-shape unique-threshold fps/tps curve, on the tensors' device.

    Returns ``(fps, tps, thresholds, mask)``, each ``(N,)`` in
    descending-threshold order: int32 counts, the sorted keys, and
    ``mask[i]`` true iff position ``i`` is the last member of its tie group
    among valid entries (it survives unique-threshold compaction). Entries
    with ``target < 0`` sort to the end with key ``-inf`` and carry no
    weight. A tie group of ``+0`` and ``-0`` keeps its input order, so the
    threshold it reports is its last member's, sign and all.
    """
    preds = _float32_inputs(preds).reshape(1, -1)
    fps, tps, thres, mask = _clf_curve_padded_rows(preds, target.reshape(1, -1), pos_label)
    return fps[0], tps[0], thres[0], mask[0]


def _binary_clf_curve_host(preds: Tensor, target: Tensor, pos_label: int = 1) -> Tuple[Tensor, Tensor, Tensor]:
    """Unique-threshold fps/tps curve: the padded program and a boolean index (a host sync).

    Assumes the ignored entries were filtered out. float64 predictions keep
    float64 thresholds and int64 counts: a float32 curve would merge
    thresholds closer than float32's epsilon (the JAX package keeps a NumPy
    path for this). That branch is reached only by calling this function
    with float64; the public paths turn float64 into float32 first.
    """
    preds = _to_tensor(preds).reshape(-1)
    target = _to_tensor(target, preds.device).reshape(-1)
    if preds.dtype == torch.float64:
        order = torch.sort(_sort_codes(-preds), stable=True).indices
        p_sorted = preds[order]
        tps = torch.cumsum(target[order] == pos_label, 0, dtype=torch.int64)
        fps = torch.arange(1, preds.numel() + 1, dtype=torch.int64, device=preds.device) - tps
        is_end = torch.cat([p_sorted[1:] != p_sorted[:-1], torch.ones(min(1, preds.numel()), dtype=torch.bool, device=preds.device)])
        return fps[is_end], tps[is_end], p_sorted[is_end]
    fps, tps, thres, mask = _binary_clf_curve_padded(preds, target, pos_label)
    return fps[mask], tps[mask], thres[mask]


def _exact_stream(state: Tuple[Tensor, Tensor]) -> Tuple[Tensor, Tensor]:
    """The exact state's valid entries (target >= 0; a boolean index, a host sync)."""
    preds, target = state
    keep = target >= 0
    return preds[keep], target[keep]


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
    if _is_concrete(target):
        _check_binary_target(target, ignore_index)


def _binary_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    rows: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """Flatten + sigmoid; ignored targets become -1. ``rows``: the sigmoid is
    decided per batch row (see ``normalize_logits_if_needed``)."""
    preds = normalize_logits_if_needed(_float32_inputs(preds).reshape(-1), "sigmoid", rows)
    target = target.reshape(-1).to(torch.int32)
    if ignore_index is not None:
        target = torch.where(target == ignore_index, torch.full_like(target, -1), target)
    return preds, target, _adjust_threshold_arg(thresholds, preds.device)


def _binary_precision_recall_curve_update(
    preds: Tensor, target: Tensor, thresholds: Optional[Tensor], ascending: bool = False, affine: Affine = None
) -> CurveState:
    """Binned: the (T, 2, 2) state from one K1 launch. ``ascending``: the
    thresholds are known to ascend, so they are not sorted again; ``affine``:
    see :func:`_uniform_grid`. Exact: the batch itself, to be appended."""
    if thresholds is None:
        return preds, target
    return _binned_curve_state(preds, target, thresholds, ascending=ascending, affine=affine)


def _binned_precision_recall(state: Tensor) -> Tuple[Tensor, Tensor]:
    """Precision and recall at every threshold of a binned ``(T, ..., 2, 2)`` state, the
    closing (1, 0) point appended along the threshold axis."""
    tps = state[..., 1, 1]
    fps = state[..., 0, 1]
    fns = state[..., 1, 0]
    precision = _safe_divide(tps, tps + fps)
    recall = _safe_divide(tps, tps + fns)
    precision = torch.cat([precision, torch.ones_like(precision[:1])])
    recall = torch.cat([recall, torch.zeros_like(recall[:1])])
    return precision, recall


def _binary_precision_recall_curve_compute(state: CurveState, thresholds: Optional[Tensor], pos_label: int = 1) -> Tuple[Tensor, Tensor, Tensor]:
    """Final curve from the binned state, or from the exact stream.

    The exact branch divides the int counts in float64 and rounds to
    float32 once, as the JAX package's NumPy division does.
    """
    if thresholds is not None and not isinstance(state, tuple):
        precision, recall = _binned_precision_recall(state)
        return precision, recall, thresholds
    fps, tps, thresh = _binary_clf_curve_host(*_exact_stream(state), pos_label=pos_label)
    tps, fps = tps.to(torch.float64), fps.to(torch.float64)
    denom = tps + fps
    precision = torch.where(denom > 0, tps / torch.where(denom > 0, denom, torch.ones_like(denom)), torch.zeros_like(denom))
    if bool(tps[-1] <= 0):
        rank_zero_warn(
            "No positive samples found in target, recall is undefined. Setting recall to one for all thresholds.",
            UserWarning,
        )
        recall = torch.ones_like(precision)
    else:
        recall = tps / tps[-1]
    precision = torch.cat([precision.flip(0), torch.ones_like(precision[:1])])
    recall = torch.cat([recall.flip(0), torch.zeros_like(recall[:1])])
    return precision.to(torch.float32), recall.to(torch.float32), _float32_inputs(thresh.flip(0))


def binary_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Binary precision-recall curve."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    ascending, affine = _grid_hints(thresholds)
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
    if not _is_concrete(target):
        return
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
    rows: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """To ``(M, C)`` probs + ``(M,)`` int32 target with ignored = -1. ``rows``:
    the softmax is decided per batch row (see ``normalize_logits_if_needed``)."""
    preds = torch.movedim(_float32_inputs(preds), 1, -1).reshape(-1, num_classes)
    target = target.reshape(-1).to(torch.int32)
    preds = normalize_logits_if_needed(preds, "softmax", rows)
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
) -> CurveState:
    """Binned: the (T, C, 2, 2) confusion tensor from one K1 launch (labels
    mode). ``ascending`` and ``affine`` as in :func:`_binary_precision_recall_curve_update`.
    Exact: the batch itself."""
    if thresholds is None:
        return preds, target
    if average == "micro":
        return _binary_precision_recall_curve_update(preds, target, thresholds, ascending, affine)
    return _binned_curve_state(preds, target, thresholds, labels=True, ascending=ascending, affine=affine)


def _per_column_curves(compute, preds: Tensor, target: Tensor, pos_labels) -> Tuple[List[Tensor], List[Tensor], List[Tensor]]:
    """``compute((preds[:, i], target_i), None, pos_label)`` for every column ``i``
    (``target_i`` the shared 1-D target, or column ``i`` of a 2-D one), as three lists."""
    curves = [
        compute((preds[:, i], target if target.ndim == 1 else target[:, i]), None, pos_label=pos_label)
        for i, pos_label in enumerate(pos_labels)
    ]
    return tuple(list(part) for part in zip(*curves))  # type: ignore[return-value]


def _multiclass_precision_recall_curve_compute(
    state: CurveState,
    num_classes: int,
    thresholds: Optional[Tensor],
    average: Optional[str] = None,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    """Final per-class curves from the binned state, or one-vs-rest curves of the exact stream."""
    if average == "micro":
        return _binary_precision_recall_curve_compute(state, thresholds)
    if thresholds is not None and not isinstance(state, tuple):
        precision, recall = _binned_precision_recall(state)
        return precision.T, recall.T, thresholds
    preds, target = _exact_stream(state)
    return _per_column_curves(_binary_precision_recall_curve_compute, preds, target, range(num_classes))


def multiclass_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: ThresholdsArg = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    """Multiclass precision-recall curve."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index, average)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    ascending, affine = _grid_hints(thresholds)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index, average
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, average, ascending, affine)
    return _multiclass_precision_recall_curve_compute(state, num_classes, thresholds, average)


# ------------------------------------------------------------------ multilabel


def _multilabel_precision_recall_curve_arg_validation(
    num_labels: int, thresholds: ThresholdsArg = None, ignore_index: Optional[int] = None
) -> None:
    """Validate non-tensor args."""
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)


def _multilabel_precision_recall_curve_tensor_validation(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> None:
    """Validate tensor inputs (reads values back to the host)."""
    _check_same_shape(preds, target)
    if not preds.is_floating_point():
        raise ValueError(f"Expected `preds` to be a float tensor, but got {preds.dtype}")
    if preds.ndim < 2 or preds.shape[1] != num_labels:
        raise ValueError(f"Expected both `preds` and `target` to have 2nd dimension equal to `num_labels`={num_labels}")
    if _is_concrete(target):
        _check_binary_target(target, ignore_index)


def _multilabel_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    rows: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """To ``(M, L)`` probs + ``(M, L)`` int32 targets with ignored = -1.
    ``rows``: the sigmoid is decided per batch row (see
    ``normalize_logits_if_needed``)."""
    preds = torch.movedim(_float32_inputs(preds), 1, -1).reshape(-1, num_labels)
    target = torch.movedim(target, 1, -1).reshape(-1, num_labels).to(torch.int32)
    preds = normalize_logits_if_needed(preds, "sigmoid", rows)
    if ignore_index is not None:
        target = torch.where(target == ignore_index, torch.full_like(target, -1), target)
    return preds, target, _adjust_threshold_arg(thresholds, preds.device)


def _multilabel_precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: Optional[Tensor],
    ascending: bool = False,
    affine: Affine = None,
) -> CurveState:
    """Binned: the (T, L, 2, 2) confusion tensor from one K1 launch in matrix
    mode (an (M, L) target, -1 masking an entry). Exact: the batch itself."""
    if thresholds is None:
        return preds, target
    return _binned_curve_state(preds, target, thresholds, ascending=ascending, affine=affine)


def _multilabel_precision_recall_curve_compute(
    state: CurveState,
    num_labels: int,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    """Final per-label curves from the binned state, or from the exact stream
    (each label's ignored entries dropped on their own)."""
    if thresholds is not None and not isinstance(state, tuple):
        precision, recall = _binned_precision_recall(state)
        return precision.T, recall.T, thresholds
    return _per_column_curves(_binary_precision_recall_curve_compute, *state, [1] * num_labels)


def multilabel_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: ThresholdsArg = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    """Multilabel precision-recall curve."""
    preds, target = _to_tensors(preds, target)
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    ascending, affine = _grid_hints(thresholds)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(preds, target, num_labels, thresholds, ignore_index)
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds, ascending, affine)
    return _multilabel_precision_recall_curve_compute(state, num_labels, thresholds, ignore_index)


def precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: ThresholdsArg = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Task-dispatching precision-recall curve."""
    return _task_call(
        task,
        num_classes,
        num_labels,
        lambda: binary_precision_recall_curve(preds, target, thresholds, ignore_index, validate_args),
        lambda: multiclass_precision_recall_curve(preds, target, num_classes, thresholds, average, ignore_index, validate_args),
        lambda: multilabel_precision_recall_curve(preds, target, num_labels, thresholds, ignore_index, validate_args),
    )
