# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""COCO mean average precision (counterpart of ``torchmetrics_tpu/functional/detection/map.py``).

The JAX package's four stages, on the card unless the caller asks for the CPU:

- **packing**, host numpy as in JAX: each image's detections cut to the
  largest max-detections threshold in score order (a stable sort), padded
  into dense ``(N, D, ...)`` / ``(N, G, ...)`` buffers with validity masks;
- **IoU**: the batched ``(N, D, G)`` box IoU with crowd columns in PyTorch
  (masks: the host RLE codec);
- **matching**: K6 (:func:`~torchmetrics_tpu_torch.ops.coco_match`, the
  hand kernel of JAX's ``lax.scan`` over score-ordered detections), then
  the area-range post-step in PyTorch;
- **accumulation**: pycocotools' ``accumulate`` as plain PyTorch batched
  over the (area, threshold, max-detections) rows: one stable sort by
  (class, -score) as two stable sorts of integer codes, segmented prefix
  sums, a segmented reverse cumulative max and the 101-point table by
  scatter and forward fill; then pycocotools' ``summarize``.

The integer parts (the matches, the counts, the recall-grid slots) are
exact, so the precision, recall and score tables are the JAX package's bit
for bit given equal matches; the summary means add float32 cells in
another order (the tests state that budget).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _sort_codes
from torchmetrics_tpu_torch.functional.detection.helpers import box_area, box_convert
from torchmetrics_tpu_torch.ops.coco_match import coco_match
from torchmetrics_tpu_torch.utilities.data import resolve_device

Tensor = torch.Tensor

# COCO's defaults (pycocotools' Params)
DEFAULT_IOU_THRESHOLDS = tuple(np.linspace(0.5, 0.95, 10).tolist())
DEFAULT_REC_THRESHOLDS = tuple(np.linspace(0.0, 1.0, 101).tolist())
DEFAULT_MAX_DETECTIONS = (1, 10, 100)
DEFAULT_AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}

#: the summary keys over the area ranges and thresholds, in result order
_SUMMARY_KEYS = ("map", "map_50", "map_75", "map_small", "map_medium", "map_large", "mar_small", "mar_medium", "mar_large")


def _round_up(n: int, mult: int = 8) -> int:
    """Round a pad dimension up to a multiple (the JAX package's, which limits its recompiles)."""
    return max(mult, ((n + mult - 1) // mult) * mult)


def _pack_ragged(
    items: Sequence[np.ndarray], pad_to: int, width: Optional[int] = None, dtype=np.float32
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack variable-length per-image arrays into a padded dense buffer and its mask."""
    n = len(items)
    shape = (n, pad_to) if width is None else (n, pad_to, width)
    out = np.zeros(shape, dtype=dtype)
    valid = np.zeros((n, pad_to), dtype=bool)
    for i, item in enumerate(items):
        item = np.asarray(item, dtype=dtype)
        k = min(item.shape[0], pad_to)
        if k:
            out[i, :k] = item[:k]
            valid[i, :k] = True
    return out, valid


def _crowd_box_iou(det: Tensor, gt: Tensor, crowd: Tensor) -> Tensor:
    """Padded pairwise IoU with COCO crowd columns (union = the detection's
    area), batched over the leading axis: ``(N, D, 4)``, ``(N, G, 4)``,
    ``(N, G)`` -> ``(N, D, G)``."""
    lt = torch.maximum(det[..., :, None, :2], gt[..., None, :, :2])
    rb = torch.minimum(det[..., :, None, 2:], gt[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_d = box_area(det)[..., :, None]
    area_g = box_area(gt)[..., None, :]
    union = torch.where(crowd[..., None, :], area_d * torch.ones_like(inter), area_d + area_g - inter)
    return torch.where(union > 0, inter / union, 0.0)


def _bbox_iou_and_area(det_boxes: Tensor, gt_boxes: Tensor, gt_crowd: Tensor) -> Tuple[Tensor, Tensor]:
    """The batched ``(N, D, G)`` box IoU with crowd columns, and the ``(N, D)`` detection areas."""
    return _crowd_box_iou(det_boxes, gt_boxes, gt_crowd), box_area(det_boxes)


def _area_out(area: Tensor, area_rngs: Tensor) -> Tensor:
    """``(N, A, X)``: the area lies outside each range."""
    return (area[:, None, :] < area_rngs[None, :, 0:1]) | (area[:, None, :] > area_rngs[None, :, 1:2])


def _match(iou: Tensor, det_area: Tensor, det_labels: Tensor, det_valid: Tensor, gt_labels: Tensor, gt_valid: Tensor,
           gt_crowd: Tensor, gt_area: Tensor, iou_thrs: Tensor, area_rngs: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """``_match_one_image`` of every image: ``det_matched (N, A, T, D)``,
    ``det_ignored (N, A, T, D)``, ``gt_ignored (N, A, G)``. The greedy walk
    is K6; the ignore masks around it are PyTorch."""
    gt_ig = (gt_crowd[:, None, :] | _area_out(gt_area, area_rngs)) & gt_valid[:, None, :]
    det_matched, det_ig = coco_match(iou, det_labels, det_valid, gt_labels, gt_valid, gt_crowd, gt_ig, iou_thrs)
    # unmatched detections outside the area range are ignored too
    det_ig = det_ig | (~det_matched & _area_out(det_area, area_rngs)[:, :, None, :])
    return det_matched, det_ig, gt_ig


def _mean_valid(s: Tensor, dims: Union[int, Tuple[int, ...], None] = None) -> Tensor:
    """pycocotools' ``summarize``: the mean over the cells > -1 (over
    ``dims``, every dim by default), or -1 if there is none."""
    valid = s > -1
    dims = tuple(range(s.ndim)) if dims is None else dims
    if dims == ():
        # jnp.sum(axis=()) reduces nothing, where torch's sum(()) reduces every dim
        n, total = valid.to(torch.int64), torch.where(valid, s, 0.0)
    else:
        n = valid.sum(dims)
        total = torch.where(valid, s, 0.0).sum(dims)
    return torch.where(n > 0, total / n.clamp(min=1).to(s.dtype), -1.0)


def _rec_grid_dsigns(rec_thrs: np.ndarray) -> Optional[np.ndarray]:
    """Exact-comparison data for a uniform recall grid, or None.

    pycocotools compares float64 ``rc = tp/npig`` against ``linspace(0, 1, R)``
    with ``searchsorted(..., 'left')``; a float32 comparison flips slots
    whenever ``tp/npig`` lands within float32 noise of a grid point (7/20 vs
    0.35). For the uniform grid ``r_j ~ j/M`` (M = R - 1) the float64
    comparison reduces to integers: ``|j npig - M tp| >= 1`` decides outright,
    and at exact rational equality the tie resolves to the host-computable
    ``r_j <= f64(j) / f64(M)``. Returns that ``(R,) int32`` tie-sign array,
    or None when the grid is not uniform (callers compare in float32).
    """
    r = np.asarray(rec_thrs, np.float64)
    m = len(r) - 1
    if m < 1 or abs(r[0]) > 0 or abs(r[-1] - 1.0) > 0:
        return None
    if np.max(np.abs(r - np.arange(len(r)) / m)) > 1e-12:
        return None
    return (r <= np.arange(len(r), dtype=np.float64) / np.float64(m)).astype(np.int32)


def _segmented_cumsum(x: Tensor, seg_start: Tensor) -> Tensor:
    """Inclusive cumsum of integer ``x`` along the last axis, restarting at
    each ``seg_start``: the plain cumsum less the exclusive cumsum at the
    segment's first element (found by a running max of start positions, no
    host sync). Integer arithmetic, so exact."""
    cum = torch.cumsum(x, -1, dtype=torch.int32)
    pos = torch.arange(seg_start.shape[0], device=x.device)
    first_of = torch.cummax(torch.where(seg_start, pos, 0), 0).values
    return cum - (cum - x)[..., first_of]


def _segmented_reverse_cummax(x: Tensor, seg_id: Tensor, num_segments: int) -> Tensor:
    """``max(x[i:j])`` for each ``i``, ``j`` the end of ``i``'s segment, of
    non-negative float32 ``x`` along the last axis (``seg_id`` ascending).

    Exact: a non-negative float32's bits, read as an int32, ascend with its
    value, so ``(num_segments - seg_id) * 2**32 + bits`` in int64 orders
    first by segment (the earlier segment above every later one, so a
    reverse running max never carries a later segment's value into an
    earlier one) and then by value; the result's low 32 bits are the chosen
    float32's bits.
    """
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    key = (num_segments - seg_id).to(torch.int64) * (1 << 32) + bits
    run = torch.flip(torch.cummax(torch.flip(key, (-1,)), -1).values, (-1,))
    return (run & 0xFFFFFFFF).to(torch.int32).view(torch.float32)


def _accumulate(
    det_matched: Tensor,  # (N, A, T, D) bool
    det_ignored: Tensor,  # (N, A, T, D) bool
    gt_ignored: Tensor,  # (N, A, G) bool
    det_scores: Tensor,  # (N, D) float32
    det_class: Tensor,  # (N, D) int32 in [0, K] (K: invalid or padded)
    det_rank: Tensor,  # (N, D) int32: rank within (image, class) in score order
    gt_class: Tensor,  # (N, G) int32 in [0, K]
    rec_thrs: Tensor,  # (R,) float32
    num_k: int,
    max_dets: Tuple[int, ...],
    rec_dsign: Optional[Tensor] = None,  # (R,) int32 from _rec_grid_dsigns
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """pycocotools' ``accumulate`` (JAX's ``_accumulate_device``) batched over
    the A x T x M rows. Returns ``precision (T, R, K, A, M)``, ``recall
    (T, K, A, M)``, ``scores (T, R, K, A, M)``, ``npig (A, K)``; classes
    with ``npig == 0`` hold -1."""
    n_imgs, num_a, num_t, num_d = det_matched.shape
    dev = det_matched.device
    num_r = rec_thrs.shape[0]
    num_m = len(max_dets)
    # pycocotools' float64 eps as a float32 constant: absorbed whenever
    # tp + fp >= 1, yet it still guards the tp + fp == 0 division
    eps = torch.tensor(np.float32(np.spacing(np.float64(1))), device=dev)
    grid_m = num_r - 1

    # ---- one stable order: class ascending, score descending, position last
    # (jnp.lexsort((-scores, class)): two stable sorts of integer codes, so
    # -0 ties +0 as in JAX's sort, on every device)
    flat_class = det_class.reshape(-1)
    order = torch.sort(_sort_codes(-det_scores.reshape(-1)), stable=True).indices
    order = order[torch.sort(flat_class[order], stable=True).indices]
    cls_s = flat_class[order]  # (ND,) non-decreasing
    score_s = det_scores.reshape(-1)[order]
    rank_s = det_rank.reshape(-1)[order]
    change = cls_s[1:] != cls_s[:-1]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    seg_start = torch.cat([one, change])
    seg_id = torch.cumsum(seg_start, 0) - 1
    num_segments = int(cls_s.shape[0])  # an upper bound on the segment count, enough for the int64 keys

    # (A, T, ND) match and ignore flags in sorted order
    dtm_s = det_matched.permute(1, 2, 0, 3).reshape(num_a, num_t, -1)[:, :, order]
    dtig_s = det_ignored.permute(1, 2, 0, 3).reshape(num_a, num_t, -1)[:, :, order]
    real = cls_s < num_k  # padded and invalid detections carry class K

    # ---- npig per (area, class): the non-ignored ground truths (exact integers)
    flat_gt_class = gt_class.reshape(-1).to(torch.int64)
    npig = torch.zeros((num_a, num_k + 1), dtype=torch.int64, device=dev)
    npig.scatter_add_(1, flat_gt_class[None, :].expand(num_a, -1),
                      (~gt_ignored).permute(1, 0, 2).reshape(num_a, -1).to(torch.int64))
    npig = npig[:, :num_k].to(torch.int32)  # (A, K)

    mdets = torch.tensor(max_dets, dtype=torch.int32, device=dev)
    keep = real[None, :] & (rank_s[None, :] < mdets[:, None])  # (M, ND)

    def count_thrs_leq(tp_int: Tensor, npig_int: Tensor) -> Tensor:
        """``#{j: rec_thrs[j] <= tp / npig}`` with pycocotools' float64 semantics:
        exact integers and the tie signs on the uniform grid, a float32
        ``searchsorted`` on another grid."""
        npig_safe = torch.clamp(npig_int, min=1)
        if rec_dsign is None:
            rc = tp_int.to(torch.float32) / npig_safe.to(torch.float32)
            return torch.searchsorted(rec_thrs, rc.contiguous(), right=True).to(torch.int32)
        prod = grid_m * tp_int
        q = torch.div(prod, npig_safe, rounding_mode="floor")
        rem = prod - q * npig_safe
        cnt_strict = torch.clamp(torch.where(rem > 0, q + 1, q), max=num_r)
        eq_extra = torch.where((rem == 0) & (q <= grid_m), rec_dsign[torch.clamp(q, 0, grid_m).long()], 0)
        return (cnt_strict + eq_extra).to(torch.int32)

    # ---- every (area, threshold, max-det) row at once: (A, T, M, ND)
    live = ~dtig_s[:, :, None, :] & keep[None, None]
    tp = (dtm_s[:, :, None, :] & live).to(torch.int32)
    fp = (~dtm_s[:, :, None, :] & live).to(torch.int32)
    tp_cum = _segmented_cumsum(tp, seg_start)
    fp_cum = _segmented_cumsum(fp, seg_start)
    del tp, fp, live
    cls_clip = torch.clamp(cls_s, 0, num_k - 1).long()
    npig_here = npig[:, None, None, :][..., cls_clip]  # (A, 1, 1, ND)
    tp_f, fp_f = tp_cum.to(torch.float32), fp_cum.to(torch.float32)
    pr = tp_f / (tp_f + fp_f + eps)
    del fp_f, fp_cum
    pr_env = _segmented_reverse_cummax(pr, seg_id, num_segments)
    del pr

    # the span of recall-grid slots each position serves: [cnt_prev, cnt)
    cnt = count_thrs_leq(tp_cum, npig_here)
    cnt_prev = torch.where(seg_start, 0, torch.cat([torch.zeros_like(cnt[..., :1]), cnt[..., :-1]], -1))
    nonempty = (cnt > cnt_prev) & real
    k_idx = torch.where(nonempty, cls_s.to(torch.int64), num_k)
    j_idx = torch.where(nonempty, cnt_prev.to(torch.int64), num_r)
    del cnt

    # scatter the span starts and each class's terminator into a
    # (rows, K + 1, R + 1) table (the row K / column R slot takes the empty
    # positions and is cut off), then forward-fill along the grid
    rows = num_a * num_t * num_m
    cells = (num_k + 1) * (num_r + 1)
    flat_idx = (torch.arange(rows, device=dev).reshape(num_a, num_t, num_m, 1) * cells + k_idx * (num_r + 1) + j_idx)
    del k_idx, j_idx
    prec_tbl = torch.zeros(rows * cells, dtype=torch.float32, device=dev)
    score_tbl = torch.zeros(rows * cells, dtype=torch.float32, device=dev)
    wrote = torch.zeros(rows * cells, dtype=torch.bool, device=dev)
    flat_idx = flat_idx.reshape(-1)
    prec_tbl[flat_idx] = pr_env.reshape(-1)
    score_tbl[flat_idx] = score_s.expand(num_a, num_t, num_m, -1).reshape(-1)
    wrote[flat_idx] = True
    del flat_idx, pr_env

    # the terminator at each class's final slot count: 0.0 fills the tail.
    # A class with ground truths but no detections has an empty segment:
    # pycocotools gives it recall 0, hence the max with 0 (the initial value)
    end_tp = torch.zeros((num_a, num_t, num_m, num_k + 1), dtype=torch.int32, device=dev)
    end_tp.scatter_reduce_(-1, torch.clamp(cls_s, 0, num_k).long().expand(num_a, num_t, num_m, -1),
                           torch.where(real, tp_cum, 0), reduce="amax", include_self=True)
    end_tp = end_tp[..., :num_k]  # (A, T, M, K)
    del tp_cum
    npig_row = npig[:, None, None, :]  # (A, 1, 1, K)
    rc_end = torch.where(npig_row > 0, end_tp.to(torch.float32) / torch.clamp(npig_row, min=1).to(torch.float32), 0.0)
    cnt_end = count_thrs_leq(end_tp, npig_row).to(torch.int64)
    term_idx = (torch.arange(rows, device=dev).reshape(num_a, num_t, num_m, 1) * cells
                + torch.arange(num_k, device=dev) * (num_r + 1) + cnt_end).reshape(-1)
    prec_tbl[term_idx] = 0.0
    score_tbl[term_idx] = 0.0
    wrote[term_idx] = True

    shape = (num_a, num_t, num_m, num_k + 1, num_r + 1)
    prec_tbl, score_tbl, wrote = prec_tbl.reshape(shape), score_tbl.reshape(shape), wrote.reshape(shape)
    slot = torch.arange(num_r + 1, device=dev)
    last = torch.cummax(torch.where(wrote, slot, -1), -1).values  # the last written slot at or before each
    filled_p = torch.where(last >= 0, prec_tbl.gather(-1, last.clamp(min=0)), 0.0)[..., :num_k, :num_r]
    filled_s = torch.where(last >= 0, score_tbl.gather(-1, last.clamp(min=0)), 0.0)[..., :num_k, :num_r]
    ok = npig_row > 0  # (A, 1, 1, K)
    precision = torch.where(ok[..., None], filled_p, -1.0)  # (A, T, M, K, R)
    scores = torch.where(ok[..., None], filled_s, -1.0)
    recall = torch.where(ok, rc_end, -1.0)  # (A, T, M, K)
    return precision.permute(1, 4, 3, 0, 2), recall.permute(1, 3, 0, 2), scores.permute(1, 4, 3, 0, 2), npig


def _to_class_idx(labels: Tensor, valid: Tensor, classes: Tensor, num_k: int) -> Tensor:
    """Each label's index in the sorted ``classes``, or K where invalid or absent."""
    pos = torch.clamp(torch.searchsorted(classes, labels.contiguous()), 0, num_k - 1)
    return torch.where(valid & (classes[pos] == labels), pos, num_k).to(torch.int32)


def _match_and_accumulate(
    iou, det_area, det_labels, det_valid, gt_labels_pad, gt_valid, gt_crowd, gt_area,
    iou_thrs, area_rngs, det_scores, classes, rec_thrs, rec_dsign, *, num_k: int,
    max_dets: Tuple[int, ...], t50: Tuple[int, ...] = (), t75: Tuple[int, ...] = (),
    return_tables: bool = False,
) -> Dict[str, Tensor]:
    """Matching, accumulation and pycocotools' ``summarize`` (area 0 is
    "all", the last max-detections threshold) on the inputs' device."""
    det_matched, det_ignored, gt_ignored = _match(
        iou, det_area, det_labels, det_valid, gt_labels_pad, gt_valid, gt_crowd, gt_area, iou_thrs, area_rngs
    )
    det_class = _to_class_idx(det_labels, det_valid, classes, num_k)
    gt_class = _to_class_idx(gt_labels_pad, gt_valid, classes, num_k)
    # rank within (image, class) in the per-image score order: pycocotools'
    # per-image-class [:maxdet] cut as a static-shape mask
    num_d = det_labels.shape[1]
    same = (det_labels[:, :, None] == det_labels[:, None, :]) & det_valid[:, :, None] & det_valid[:, None, :]
    tri = torch.tril(torch.ones((num_d, num_d), dtype=torch.bool, device=iou.device), -1)
    det_rank = (same & tri).sum(-1, dtype=torch.int32)
    del same
    precision, recall, scores, _ = _accumulate(
        det_matched, det_ignored, gt_ignored, det_scores, det_class, det_rank, gt_class,
        rec_thrs, num_k, max_dets, rec_dsign,
    )
    neg1 = torch.tensor(-1.0, dtype=torch.float32, device=iou.device)
    out = {
        "map": _mean_valid(precision[:, :, :, 0, -1]),
        "map_50": _mean_valid(precision[list(t50), :, :, 0, -1]) if t50 else neg1,
        "map_75": _mean_valid(precision[list(t75), :, :, 0, -1]) if t75 else neg1,
        "map_small": _mean_valid(precision[:, :, :, 1, -1]),
        "map_medium": _mean_valid(precision[:, :, :, 2, -1]),
        "map_large": _mean_valid(precision[:, :, :, 3, -1]),
        "mar_small": _mean_valid(recall[:, :, 1, -1]),
        "mar_medium": _mean_valid(recall[:, :, 2, -1]),
        "mar_large": _mean_valid(recall[:, :, 3, -1]),
        "mar_per_mdet": _mean_valid(recall[:, :, 0, :], (0, 1)),
        "map_per_class": _mean_valid(precision[:, :, :, 0, -1], (0, 1)),
        "mar_per_class": _mean_valid(recall[:, :, 0, -1], (0,)),
    }
    if return_tables:
        out["precision"], out["recall"], out["scores"] = precision, recall, scores
    return out


class COCOEvaluationResult(dict):
    """The result dict, with attribute access."""

    def __getattr__(self, key: str) -> Any:
        if key in self:
            return self[key]
        raise AttributeError(f"No such attribute: {key}")


def _host_arrays(items: Sequence[Any], dtype) -> List[np.ndarray]:
    """Each item as a host numpy array of ``dtype``. Tensors come over in
    one copy per device (a float64 cat, exact for the labels, scores,
    boxes and flags here, then a split), not one per image."""
    out: List[Optional[np.ndarray]] = [None] * len(items)
    by_device: Dict[torch.device, List[int]] = {}
    for i, x in enumerate(items):
        if isinstance(x, torch.Tensor):
            by_device.setdefault(x.device, []).append(i)
        else:
            out[i] = np.asarray(x, dtype)
    for idx in by_device.values():
        host = torch.cat([items[i].reshape(-1).to(torch.float64) for i in idx]).cpu().numpy()
        parts = np.split(host, np.cumsum([items[i].numel() for i in idx])[:-1])
        for i, part in zip(idx, parts):
            out[i] = part.reshape(tuple(items[i].shape)).astype(dtype)
    return out


def _boxes_to_xyxy(boxes: np.ndarray, box_format: str) -> np.ndarray:
    """``(n, 4)`` host boxes in ``xyxy``: float64 as given, or float32 after a
    conversion, which JAX runs in float32 (its float64 input becomes float32)."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
    if box_format != "xyxy" and boxes.size:
        return box_convert(torch.from_numpy(boxes.astype(np.float32)), box_format, "xyxy").numpy()
    return boxes


def _infer_device(preds: Sequence[Dict[str, Any]], target: Sequence[Dict[str, Any]]) -> torch.device:
    """The device of the first tensor in the inputs, else the card."""
    for item in list(preds) + list(target):
        for v in item.values():
            if isinstance(v, torch.Tensor):
                return v.device
    return resolve_device("cuda", "coco_mean_average_precision", "Pass device='cpu' or CPU tensors to run on the CPU.")


def coco_mean_average_precision(
    preds: Sequence[Dict[str, Any]],
    target: Sequence[Dict[str, Any]],
    box_format: str = "xyxy",
    iou_thresholds: Optional[Sequence[float]] = None,
    rec_thresholds: Optional[Sequence[float]] = None,
    max_detection_thresholds: Optional[Sequence[int]] = None,
    class_metrics: bool = False,
    extended_summary: bool = False,
    average: str = "macro",
    iou_type: str = "bbox",
    *,
    device: Union[str, torch.device, None] = None,
) -> Dict[str, Any]:
    """COCO evaluation over a dataset of per-image dicts (pycocotools' ``COCOeval``).

    ``preds[i]``: ``scores``/``labels`` plus ``boxes`` (``iou_type="bbox"``)
    or ``masks`` (``iou_type="segm"``: ``(n, H, W)`` binary arrays or RLE
    dicts); ``target[i]``: the same geometry key, ``labels``, optional
    ``iscrowd``/``area``. Values may be numpy arrays or tensors. The
    evaluation runs on ``device``: by default the device of the first tensor
    in the inputs, else the card (which must exist).

    With the default (uniform 101-point) ``rec_thresholds`` the recall slots
    reproduce pycocotools' float64 comparison exactly through integer
    arithmetic; another grid compares in float32.
    """
    if iou_type not in ("bbox", "segm"):
        raise ValueError(f"Expected argument `iou_type` to be one of ('bbox', 'segm') but got {iou_type}")
    dev = _infer_device(preds, target) if device is None else resolve_device(device, "coco_mean_average_precision")
    iou_thrs = np.asarray(iou_thresholds if iou_thresholds is not None else DEFAULT_IOU_THRESHOLDS, np.float64)
    rec_thrs = np.asarray(rec_thresholds if rec_thresholds is not None else DEFAULT_REC_THRESHOLDS, np.float64)
    max_dets = sorted(max_detection_thresholds if max_detection_thresholds is not None else DEFAULT_MAX_DETECTIONS)
    area_rngs = np.asarray(list(DEFAULT_AREA_RANGES.values()), np.float64)
    n_imgs = len(preds)
    maxdet_last = max_dets[-1]

    if iou_type == "segm":
        from torchmetrics_tpu_torch.functional.detection import mask_utils

        def _to_rles(items):
            masks = items.get("masks", [])
            if isinstance(masks, dict):
                masks = [masks]
            return [m if isinstance(m, dict) else mask_utils.encode(m) for m in masks]

    scores_h = _host_arrays([p["scores"] for p in preds], np.float64)
    labels_h = _host_arrays([p["labels"] for p in preds], np.int64)
    glabels_h = _host_arrays([t["labels"] for t in target], np.int64)
    if iou_type == "bbox":
        boxes_h = _host_arrays([p["boxes"] for p in preds], np.float64)
        gboxes_h = _host_arrays([t["boxes"] for t in target], np.float64)
    crowds_h = _host_arrays([t.get("iscrowd", np.zeros(len(g))) for t, g in zip(target, glabels_h)], np.float64)
    areas_in = [t.get("area") for t in target]
    areas_h = _host_arrays([a if a is not None else np.zeros(0) for a in areas_in], np.float64)

    det_boxes_l, det_scores_l, det_labels_l, det_rles_l, det_marea_l = [], [], [], [], []
    gt_boxes_l, gt_labels_l, gt_crowd_l, gt_area_l, gt_rles_l = [], [], [], [], []
    for i, (p, t) in enumerate(zip(preds, target)):
        scores = scores_h[i].reshape(-1)
        labels = labels_h[i].reshape(-1)
        order = np.argsort(-scores, kind="mergesort")[:maxdet_last]
        scores, labels = scores[order], labels[order]
        if iou_type == "bbox":
            det_boxes_l.append(_boxes_to_xyxy(boxes_h[i].reshape(-1, 4)[order], box_format))
        else:
            rles = _to_rles(p)
            rles = [rles[j] for j in order]
            det_rles_l.append(rles)
            det_marea_l.append(np.asarray(mask_utils.area(rles)).reshape(-1) if rles else np.zeros(0))
        det_scores_l.append(scores)
        det_labels_l.append(labels)

        glabels = glabels_h[i].reshape(-1)
        crowd = crowds_h[i].reshape(-1).astype(bool)
        if iou_type == "bbox":
            gboxes = _boxes_to_xyxy(gboxes_h[i], box_format)
            gt_boxes_l.append(gboxes)
            default_area = (gboxes[:, 2] - gboxes[:, 0]) * (gboxes[:, 3] - gboxes[:, 1])
        else:
            grles = _to_rles(t)
            gt_rles_l.append(grles)
            default_area = np.asarray(mask_utils.area(grles)).reshape(-1) if grles else np.zeros(0)
        area = areas_h[i].reshape(-1) if areas_in[i] is not None and areas_h[i].size else default_area
        gt_labels_l.append(glabels)
        gt_crowd_l.append(crowd)
        gt_area_l.append(area)

    if average == "micro":
        # micro averaging pools every class into one
        det_labels_l = [np.zeros_like(x) for x in det_labels_l]
        gt_labels_l = [np.zeros_like(x) for x in gt_labels_l]

    all_labels = np.concatenate([np.concatenate(det_labels_l) if det_labels_l else np.zeros(0)]
                                + [np.concatenate(gt_labels_l) if gt_labels_l else np.zeros(0)])
    classes = np.unique(all_labels.astype(np.int64)) if all_labels.size else np.zeros(0, np.int64)
    num_t, num_r, num_k, num_a, num_m = len(iou_thrs), len(rec_thrs), len(classes), len(area_rngs), len(max_dets)

    def _dev(x: np.ndarray, dtype: torch.dtype) -> Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

    if n_imgs and num_k:
        pad_d = _round_up(max(1, max(len(s) for s in det_scores_l)))
        pad_g = _round_up(max(1, max(len(x) for x in gt_labels_l)))
        det_scores, det_valid = _pack_ragged(det_scores_l, pad_d)
        det_labels, _ = _pack_ragged(det_labels_l, pad_d, dtype=np.int64)
        gt_labels, gt_valid = _pack_ragged(gt_labels_l, pad_g, dtype=np.int64)
        gt_crowd, _ = _pack_ragged(gt_crowd_l, pad_g, dtype=bool)
        gt_area, _ = _pack_ragged(gt_area_l, pad_g)
        # a sentinel label no real class uses, so padded rows never match
        det_labels = np.where(det_valid, det_labels, -1)
        gt_labels_pad = np.where(gt_valid, gt_labels, -2)
        gt_crowd_t = _dev(gt_crowd, torch.bool)

        if iou_type == "bbox":
            det_boxes, _ = _pack_ragged(det_boxes_l, pad_d, 4)
            gt_boxes, _ = _pack_ragged(gt_boxes_l, pad_g, 4)
            iou_all, det_area = _bbox_iou_and_area(_dev(det_boxes, torch.float32), _dev(gt_boxes, torch.float32), gt_crowd_t)
        else:
            # each image's crowd-aware mask IoU through the RLE codec (host)
            iou_np = np.zeros((n_imgs, pad_d, pad_g), np.float32)
            for i in range(n_imgs):
                d_rles, g_rles = det_rles_l[i], gt_rles_l[i]
                if d_rles and g_rles:
                    iou_np[i, : len(d_rles), : len(g_rles)] = mask_utils.iou(
                        d_rles, g_rles, iscrowd=gt_crowd_l[i].astype(np.uint8)
                    )
            iou_all = _dev(iou_np, torch.float32)
            det_area = _dev(_pack_ragged(det_marea_l, pad_d)[0], torch.float32)

        # JAX holds labels and classes as int32 (its 64-bit types are off)
        rec_dsign = _rec_grid_dsigns(rec_thrs)
        summ = _match_and_accumulate(
            iou_all,
            det_area,
            _dev(det_labels, torch.int64).to(torch.int32),
            _dev(det_valid, torch.bool),
            _dev(gt_labels_pad, torch.int64).to(torch.int32),
            _dev(gt_valid, torch.bool),
            gt_crowd_t,
            _dev(gt_area, torch.float32),
            _dev(iou_thrs, torch.float32),
            _dev(area_rngs, torch.float32),
            _dev(det_scores, torch.float32),
            _dev(classes, torch.int64).to(torch.int32),
            _dev(rec_thrs, torch.float32),
            None if rec_dsign is None else _dev(rec_dsign, torch.int32),
            num_k=num_k,
            max_dets=tuple(max_dets),
            t50=tuple(int(i) for i in np.where(np.isclose(iou_thrs, 0.5))[0]),
            t75=tuple(int(i) for i in np.where(np.isclose(iou_thrs, 0.75))[0]),
            return_tables=extended_summary,
        )
    else:
        summ = {key: torch.tensor(-1.0, dtype=torch.float32, device=dev) for key in _SUMMARY_KEYS}
        summ["mar_per_mdet"] = torch.full((num_m,), -1.0, dtype=torch.float32, device=dev)
        summ["map_per_class"] = torch.full((max(num_k, 1),), -1.0, dtype=torch.float32, device=dev)
        summ["mar_per_class"] = torch.full((max(num_k, 1),), -1.0, dtype=torch.float32, device=dev)
        if extended_summary:
            summ["precision"] = torch.full((num_t, num_r, num_k, num_a, num_m), -1.0, dtype=torch.float32, device=dev)
            summ["recall"] = torch.full((num_t, num_k, num_a, num_m), -1.0, dtype=torch.float32, device=dev)
            summ["scores"] = torch.full((num_t, num_r, num_k, num_a, num_m), -1.0, dtype=torch.float32, device=dev)

    res: Dict[str, Any] = COCOEvaluationResult()
    for key in ("map", "map_50", "map_75", "map_small", "map_medium", "map_large"):
        res[key] = summ[key]
    for mi, mdet in enumerate(max_dets):
        res[f"mar_{mdet}"] = summ["mar_per_mdet"][mi]
    for key in ("mar_small", "mar_medium", "mar_large"):
        res[key] = summ[key]
    neg1 = torch.tensor(-1.0, dtype=torch.float32, device=dev)
    if class_metrics and num_k:
        res["map_per_class"] = summ["map_per_class"]
        res[f"mar_{maxdet_last}_per_class"] = summ["mar_per_class"]
    else:
        res["map_per_class"] = neg1
        res[f"mar_{maxdet_last}_per_class"] = neg1
    res["classes"] = _dev(classes, torch.int64).to(torch.int32)
    if extended_summary:
        res["precision"], res["recall"], res["scores"] = summ["precision"], summ["recall"], summ["scores"]
    return res
