# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Panoptic quality (counterpart of ``torchmetrics_tpu/functional/detection/panoptic_quality.py``).

Segment discovery has a data-dependent number of ``(category, instance)``
segments an image, so the per-sample matching is host numpy, copied from
the JAX package (vectorized ``np.unique``/bincount, no per-pixel Python
loop). It yields fixed-size per-category ``iou_sum``/``tp``/``fp``/``fn``
counts, which go to the inputs' device (numpy inputs: the card) as float32
and int32, as ``jnp.asarray`` makes them; the compute is PyTorch there.
"""
from __future__ import annotations

from typing import Any, Collection, Optional, Set, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.utilities.compute import _sum_last_in_xla_order
from torchmetrics_tpu_torch.utilities.data import resolve_device

Tensor = torch.Tensor


def _host(x: Any) -> np.ndarray:  # metriclint: disable=ML011 -- panoptic segments are matched on the host in numpy, as in JAX: the update is not capturable
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _device_of(x: Any) -> torch.device:
    """A tensor's device; anything else goes to the card."""
    if isinstance(x, torch.Tensor):
        return x.device
    return resolve_device("cuda", f"a {type(x).__name__} input", "Pass CPU tensors to run on the CPU.")


def _parse_categories(things: Collection[int], stuffs: Collection[int]) -> Tuple[Set[int], Set[int]]:
    """Validate and normalize category id sets."""
    things_parsed = set(things)
    stuffs_parsed = set(stuffs)
    if not all(isinstance(t, (int, np.integer)) for t in things_parsed):
        raise TypeError(f"Expected argument `things` to contain `int` categories, but got {things}")
    if not all(isinstance(s, (int, np.integer)) for s in stuffs_parsed):
        raise TypeError(f"Expected argument `stuffs` to contain `int` categories, but got {stuffs}")
    if things_parsed & stuffs_parsed:
        raise ValueError(
            f"Expected arguments `things` and `stuffs` to have distinct keys, but got {things} and {stuffs}"
        )
    if not (things_parsed | stuffs_parsed):
        raise ValueError("At least one of `things` and `stuffs` must be non-empty.")
    return things_parsed, stuffs_parsed


def _validate_inputs(preds, target) -> None:
    """Shape validation."""
    preds, target = _host(preds), _host(target)
    if preds.shape != target.shape:
        raise ValueError(
            f"Expected argument `preds` and `target` to have the same shape, but got {preds.shape} and {target.shape}"
        )
    if preds.ndim < 3:
        raise ValueError(
            "Expected argument `preds` to have at least one spatial dimension (B, *spatial_dims, 2),"
            f" got {preds.shape}"
        )
    if preds.shape[-1] != 2:
        raise ValueError(
            "Expected argument `preds` to have exactly 2 channels in the last dimension (category, instance),"
            f" got {preds.shape} instead"
        )


def _get_void_color(things: Set[int], stuffs: Set[int]) -> Tuple[int, int]:
    """An unused (category, instance) pair."""
    unused_category_id = 1 + max([0, *things, *stuffs])
    return unused_category_id, 0


def _get_category_id_to_continuous_id(things: Set[int], stuffs: Set[int]) -> dict:
    """Things first, then stuffs, numerically sorted."""
    thing_id_to_continuous_id = {t: i for i, t in enumerate(sorted(things))}
    stuff_id_to_continuous_id = {s: len(things) + i for i, s in enumerate(sorted(stuffs))}
    return {**thing_id_to_continuous_id, **stuff_id_to_continuous_id}


def _preprocess_inputs(
    things: Set[int],
    stuffs: Set[int],
    inputs,
    void_color: Tuple[int, int],
    allow_unknown_category: bool,
) -> np.ndarray:
    """Flatten spatial dims, zero stuff instance ids, map unknowns to void."""
    out = np.array(inputs, copy=True)
    out = out.reshape(out.shape[0], -1, 2)
    cats = out[:, :, 0]
    mask_stuffs = np.isin(cats, list(stuffs))
    mask_things = np.isin(cats, list(things))
    out[:, :, 1] = np.where(mask_stuffs, 0, out[:, :, 1])
    known = mask_things | mask_stuffs
    if not allow_unknown_category and not known.all():
        raise ValueError(f"Unknown categories found: {out[~known]}")
    out[:, :, 0] = np.where(known, out[:, :, 0], void_color[0])
    out[:, :, 1] = np.where(known, out[:, :, 1], void_color[1])
    return out


def _panoptic_quality_update_sample(
    preds: np.ndarray,  # (P, 2)
    target: np.ndarray,  # (P, 2)
    cat_id_to_continuous_id: dict,
    void_color: Tuple[int, int],
    stuffs_modified_metric: Optional[Set[int]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized per-sample segment matching.

    Segments are keyed by packing ``(category, instance)`` into one int64 via
    the sample's own compact color tables; all areas come from a single
    ``np.unique`` over the joint (pred, target) color pairs.
    """
    stuffs_modified_metric = stuffs_modified_metric or set()
    num_categories = len(cat_id_to_continuous_id)
    iou_sum = np.zeros(num_categories, dtype=np.float64)
    true_positives = np.zeros(num_categories, dtype=np.int64)
    false_positives = np.zeros(num_categories, dtype=np.int64)
    false_negatives = np.zeros(num_categories, dtype=np.int64)

    # compact per-sample color tables: colors -> ids
    pred_colors, pred_inv = np.unique(preds, axis=0, return_inverse=True)
    target_colors, target_inv = np.unique(target, axis=0, return_inverse=True)
    pred_inv, target_inv = pred_inv.ravel(), target_inv.ravel()
    n_pc, n_tc = len(pred_colors), len(target_colors)
    pred_areas = np.bincount(pred_inv, minlength=n_pc)
    target_areas = np.bincount(target_inv, minlength=n_tc)
    # joint (pred_color, target_color) intersection areas
    joint = pred_inv.astype(np.int64) * n_tc + target_inv
    pair_keys, pair_areas = np.unique(joint, return_counts=True)
    pair_p = pair_keys // n_tc
    pair_t = pair_keys % n_tc

    def _is_void(colors: np.ndarray) -> np.ndarray:
        return (colors[:, 0] == void_color[0]) & (colors[:, 1] == void_color[1])

    pred_is_void = _is_void(pred_colors)
    target_is_void = _is_void(target_colors)

    # void overlap per segment (for union correction and FN/FP filtering)
    pred_void_area = np.zeros(n_pc, dtype=np.int64)
    void_mask_t = target_is_void[pair_t]
    np.add.at(pred_void_area, pair_p[void_mask_t], pair_areas[void_mask_t])
    target_void_area = np.zeros(n_tc, dtype=np.int64)
    void_mask_p = pred_is_void[pair_p]
    np.add.at(target_void_area, pair_t[void_mask_p], pair_areas[void_mask_p])

    # candidate matches: same category, target not void
    same_cat = pred_colors[pair_p, 0] == target_colors[pair_t, 0]
    cand = same_cat & ~target_is_void[pair_t] & ~pred_is_void[pair_p]
    cp, ct, ca = pair_p[cand], pair_t[cand], pair_areas[cand]
    union = pred_areas[cp] - pred_void_area[cp] + target_areas[ct] - target_void_area[ct] - ca
    iou = ca / union

    cat_of_pair = target_colors[ct, 0]
    cont_ids = np.array([cat_id_to_continuous_id[int(c)] for c in cat_of_pair], dtype=np.int64) if len(ct) else np.zeros(0, np.int64)
    modified = (
        np.isin(cat_of_pair, list(stuffs_modified_metric)) if len(ct) else np.zeros(0, bool)
    )

    matched = ~modified & (iou > 0.5)
    np.add.at(iou_sum, cont_ids[matched], iou[matched])
    np.add.at(true_positives, cont_ids[matched], 1)
    mod_hit = modified & (iou > 0)
    np.add.at(iou_sum, cont_ids[mod_hit], iou[mod_hit])

    pred_segment_matched = np.zeros(n_pc, dtype=bool)
    pred_segment_matched[cp[matched]] = True
    target_segment_matched = np.zeros(n_tc, dtype=bool)
    target_segment_matched[ct[matched]] = True

    # false negatives: unmatched target segments not mostly void in the pred
    fn_mask = ~target_segment_matched & ~target_is_void & (target_void_area / target_areas <= 0.5)
    for idx in np.nonzero(fn_mask)[0]:
        cat = int(target_colors[idx, 0])
        if cat not in stuffs_modified_metric:
            false_negatives[cat_id_to_continuous_id[cat]] += 1
    # false positives: unmatched pred segments not mostly void in the target
    fp_mask = ~pred_segment_matched & ~pred_is_void & (pred_void_area / pred_areas <= 0.5)
    for idx in np.nonzero(fp_mask)[0]:
        cat = int(pred_colors[idx, 0])
        if cat not in stuffs_modified_metric:
            false_positives[cat_id_to_continuous_id[cat]] += 1
    # modified metric: tp counts the number of target segments per stuff class
    for idx in range(n_tc):
        cat = int(target_colors[idx, 0])
        if cat in stuffs_modified_metric and not target_is_void[idx]:
            true_positives[cat_id_to_continuous_id[cat]] += 1

    return iou_sum, true_positives, false_positives, false_negatives


def _panoptic_quality_update(
    preds: np.ndarray,
    target: np.ndarray,
    cat_id_to_continuous_id: dict,
    void_color: Tuple[int, int],
    modified_metric_stuffs: Optional[Set[int]] = None,
    device: Optional[torch.device] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Batch update: samples are matched independently, summed in float64
    and int64 on the host, then put on ``device`` as float32 and int32."""
    num_categories = len(cat_id_to_continuous_id)
    iou_sum = np.zeros(num_categories, dtype=np.float64)
    tp = np.zeros(num_categories, dtype=np.int64)
    fp = np.zeros(num_categories, dtype=np.int64)
    fn = np.zeros(num_categories, dtype=np.int64)
    for p, t in zip(preds, target):
        r = _panoptic_quality_update_sample(p, t, cat_id_to_continuous_id, void_color, modified_metric_stuffs)
        iou_sum += r[0]
        tp += r[1]
        fp += r[2]
        fn += r[3]
    return tuple(
        torch.from_numpy(x.astype(dtype)).to(device)
        for x, dtype in ((iou_sum, np.float32), (tp, np.int32), (fp, np.int32), (fn, np.int32))
    )


def _panoptic_quality_compute(
    iou_sum: Tensor, true_positives: Tensor, false_positives: Tensor, false_negatives: Tensor
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Per-class and averaged PQ/SQ/RQ, in ``iou_sum``'s dtype.

    JAX's dtypes: SQ is ``iou_sum``'s dtype; the denominator and RQ are
    weakly typed float32 (integers times a Python float), so they take
    SQ's dtype where they meet it, which keeps a ``set_dtype``-narrowed
    state's PQ narrow. The class means add in float32 in XLA's order (as
    XLA adds a narrow float's sum) and divide in the value's dtype.
    """
    sq = torch.where(true_positives > 0, iou_sum / torch.clamp(true_positives, min=1), 0.0)
    denominator = true_positives + 0.5 * false_positives + 0.5 * false_negatives
    rq = torch.where(denominator > 0, true_positives / torch.clamp(denominator, min=1e-12), 0.0)
    pq = sq * rq.to(sq.dtype)
    seen = denominator > 0
    n_seen = torch.clamp(seen.sum(), min=1)

    def mean(x: Tensor) -> Tensor:
        total = _sum_last_in_xla_order(torch.where(seen, x, 0.0).to(torch.float32)).to(x.dtype)
        return total / n_seen.to(x.dtype)

    return pq, sq, rq.to(sq.dtype), mean(pq), mean(sq), mean(rq).to(sq.dtype)


def _panoptic_quality(preds, target, things, stuffs, allow_unknown_preds_category, return_sq_and_rq,
                      return_per_class, modified: bool) -> Tensor:
    things_p, stuffs_p = _parse_categories(things, stuffs)
    _validate_inputs(preds, target)
    device = _device_of(preds)
    void_color = _get_void_color(things_p, stuffs_p)
    cat_map = _get_category_id_to_continuous_id(things_p, stuffs_p)
    preds_f = _preprocess_inputs(things_p, stuffs_p, _host(preds), void_color, allow_unknown_preds_category)
    target_f = _preprocess_inputs(things_p, stuffs_p, _host(target), void_color, True)
    iou_sum, tp, fp, fn = _panoptic_quality_update(
        preds_f, target_f, cat_map, void_color, modified_metric_stuffs=stuffs_p if modified else None, device=device
    )
    pq, sq, rq, pq_avg, sq_avg, rq_avg = _panoptic_quality_compute(iou_sum, tp, fp, fn)
    if return_per_class:
        if return_sq_and_rq:
            return torch.stack([pq, sq, rq], -1)
        return pq[None, :]
    if return_sq_and_rq:
        return torch.stack([pq_avg, sq_avg, rq_avg])
    return pq_avg


def panoptic_quality(
    preds,
    target,
    things: Collection[int],
    stuffs: Collection[int],
    allow_unknown_preds_category: bool = False,
    return_sq_and_rq: bool = False,
    return_per_class: bool = False,
) -> Tensor:
    """Panoptic quality over ``(B, *spatial, 2)`` maps of ``(category, instance)``."""
    return _panoptic_quality(preds, target, things, stuffs, allow_unknown_preds_category, return_sq_and_rq,
                             return_per_class, modified=False)


def modified_panoptic_quality(
    preds,
    target,
    things: Collection[int],
    stuffs: Collection[int],
    allow_unknown_preds_category: bool = False,
    return_sq_and_rq: bool = False,
    return_per_class: bool = False,
) -> Tensor:
    """Modified PQ: stuff classes match at IoU > 0 and count a true positive per target segment."""
    return _panoptic_quality(preds, target, things, stuffs, allow_unknown_preds_category, return_sq_and_rq,
                             return_per_class, modified=True)
