# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""COCO RLE mask utilities over the port's native codec (counterpart of
``torchmetrics_tpu/functional/detection/mask_utils.py``).

``encode``/``decode``/``area``/``iou``/``from_polygons`` on dicts
``{"size": [h, w], "counts": np.uint32 runs}`` run through the C++ codec of
:mod:`torchmetrics_tpu_torch.native`, which raises if it cannot be built:
there is no silent numpy route. The numpy functions ``_encode_numpy``,
``_decode_numpy``, ``_area_numpy`` and ``_iou_numpy`` are the plain
versions the tests hold the codec against. Masks may be numpy arrays or
tensors on any device (copied to the host, where the codec runs).
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.native import get_rle_library

RLE = Dict[str, object]


def _host(x: Any) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _encode_numpy(flat: np.ndarray) -> np.ndarray:
    """Run lengths of a flat binary array, zeros first (the plain version of the codec's encode)."""
    flat = flat.astype(bool)
    change = np.nonzero(np.diff(flat))[0] + 1
    boundaries = np.concatenate([[0], change, [flat.size]])
    runs = np.diff(boundaries)
    if flat.size and flat[0]:
        runs = np.concatenate([[0], runs])
    return runs.astype(np.uint32)


def _decode_numpy(rle: RLE) -> np.ndarray:
    """The plain version of :func:`decode`."""
    h, w = rle["size"]
    counts = np.asarray(rle["counts"], np.uint32)
    size = int(h) * int(w)
    out = np.repeat(np.arange(counts.size) % 2, counts).astype(np.uint8)
    out = np.pad(out, (0, size - out.size)) if out.size < size else out[:size]
    return out.reshape((h, w), order="F")


def _area_numpy(rles: Sequence[RLE]) -> np.ndarray:
    """The plain version of :func:`area` over a list."""
    return np.asarray([np.asarray(r["counts"], np.uint32)[1::2].sum() for r in rles], np.float64)


def _iou_numpy(dt: Sequence[RLE], gt: Sequence[RLE], iscrowd: Optional[Sequence[int]] = None) -> np.ndarray:
    """The plain version of :func:`iou`: decode and compare densely in float64."""
    n_dt, n_gt = len(dt), len(gt)
    crowd = np.asarray(iscrowd if iscrowd is not None else np.zeros(n_gt), np.uint8)
    if n_dt == 0 or n_gt == 0:
        return np.zeros((n_dt, n_gt), np.float64)
    dt_masks = np.stack([_decode_numpy(r).ravel() for r in dt]).astype(bool)
    gt_masks = np.stack([_decode_numpy(r).ravel() for r in gt]).astype(bool)
    inter = dt_masks.astype(np.float64) @ gt_masks.T.astype(np.float64)
    area_d = dt_masks.sum(1)[:, None].astype(np.float64)
    area_g = gt_masks.sum(1)[None, :].astype(np.float64)
    union = np.where(crowd[None, :].astype(bool), area_d, area_d + area_g - inter)
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0)


def encode(mask: Any) -> RLE:
    """Encode an ``(H, W)`` binary mask (column-major runs, COCO's convention)."""
    mask = _host(mask)
    if mask.ndim != 2:
        raise ValueError(f"Expected a single (H, W) mask, got shape {mask.shape}")
    h, w = mask.shape
    flat = np.asfortranarray(mask.astype(np.uint8)).flatten(order="F")
    buf = np.zeros(flat.size + 1, np.uint32)
    n = get_rle_library().rle_encode(
        flat.ctypes.data_as(ctypes.c_void_p), ctypes.c_uint64(flat.size), buf.ctypes.data_as(ctypes.c_void_p)
    )
    return {"size": [h, w], "counts": buf[:n].copy()}


def decode(rle: RLE) -> np.ndarray:
    """Decode an RLE into an ``(H, W)`` uint8 mask."""
    h, w = rle["size"]
    counts = np.ascontiguousarray(rle["counts"], np.uint32)
    size = int(h) * int(w)
    out = np.zeros(size, np.uint8)
    get_rle_library().rle_decode(
        counts.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_uint64(counts.size),
        out.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_uint64(size),
    )
    return out.reshape((h, w), order="F")


def area(rles: Union[RLE, Sequence[RLE]]) -> np.ndarray:
    """Foreground areas of one or many RLEs (float64)."""
    single = isinstance(rles, dict)
    rle_list: List[RLE] = [rles] if single else list(rles)
    lib = get_rle_library()
    out = np.zeros(len(rle_list), np.float64)
    for i, r in enumerate(rle_list):
        counts = np.ascontiguousarray(r["counts"], np.uint32)
        out[i] = lib.rle_area(counts.ctypes.data_as(ctypes.c_void_p), ctypes.c_uint64(counts.size))
    return out[0] if single else out


def to_bbox(rles: Union[RLE, Sequence[RLE]]) -> np.ndarray:
    """Tight ``[x, y, w, h]`` box(es) of RLE mask(s), pycocotools' ``rleToBbox``
    rule: a foreground run across a column boundary covers the full height."""
    single = isinstance(rles, dict)
    out = []
    for r in [rles] if single else rles:
        h, _w = (int(v) for v in r["size"])
        cnts = np.asarray(r["counts"], np.int64)
        ends = np.cumsum(cnts)
        starts = ends - cnts
        s, e = starts[1::2], ends[1::2] - 1  # inclusive bounds of the 1-runs
        if s.size == 0 or h == 0:
            out.append([0.0, 0.0, 0.0, 0.0])
            continue
        xs, xe = s // h, e // h
        spans = xe > xs
        ys = np.where(spans, 0, s % h)
        ye = np.where(spans, h - 1, e % h)
        x0, x1 = xs.min(), xe.max()
        y0, y1 = ys.min(), ye.max()
        out.append([float(x0), float(y0), float(x1 - x0 + 1), float(y1 - y0 + 1)])
    return np.asarray(out[0] if single else out, np.float64)


def iou(dt: Sequence[RLE], gt: Sequence[RLE], iscrowd: Optional[Sequence[int]] = None) -> np.ndarray:
    """Crowd-aware IoU matrix ``(len(dt), len(gt))`` (float64) between RLE sets."""
    dt, gt = list(dt), list(gt)
    n_dt, n_gt = len(dt), len(gt)
    crowd = np.ascontiguousarray(iscrowd if iscrowd is not None else np.zeros(n_gt), np.uint8)
    if crowd.size != n_gt:
        raise ValueError(f"iscrowd must have one entry per gt, got {crowd.size} for {n_gt}")
    out = np.zeros((n_dt, n_gt), np.float64)
    if n_dt == 0 or n_gt == 0:
        return out

    def _runs(rles):
        runs = np.concatenate([np.asarray(r["counts"], np.uint32) for r in rles])
        lengths = np.asarray([len(r["counts"]) for r in rles], np.uint64)
        offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.uint64)
        return runs, offsets, lengths

    dt_runs, dt_offsets, dt_lengths = _runs(dt)
    gt_runs, gt_offsets, gt_lengths = _runs(gt)
    get_rle_library().rle_iou_matrix(
        dt_runs.ctypes.data_as(ctypes.c_void_p),
        dt_offsets.ctypes.data_as(ctypes.c_void_p),
        dt_lengths.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_uint64(n_dt),
        gt_runs.ctypes.data_as(ctypes.c_void_p),
        gt_offsets.ctypes.data_as(ctypes.c_void_p),
        gt_lengths.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_uint64(n_gt),
        crowd.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def rle_from_string(s: Union[str, bytes]) -> np.ndarray:
    """Decode COCO's compressed RLE ``counts`` string (pycocotools' ``rleFrString``
    varint and delta coding) into plain run lengths."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, np.uint32)


def rle_to_string(counts: np.ndarray) -> str:
    """Encode run lengths into COCO's compressed ``counts`` string (pycocotools' ``rleToString``)."""
    counts = np.asarray(counts, np.int64)
    out = []
    for i, x in enumerate(counts):
        x = int(x)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not (x == -1 if (c & 0x10) else x == 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def from_polygons(polygons: Sequence[Sequence[float]], h: int, w: int) -> RLE:
    """Rasterize COCO polygon segmentation(s) into one RLE (pycocotools'
    ``frPyObjects`` and ``merge``): each polygon is a flat ``[x0, y0, x1, y1, ...]``
    list, and several polygons unite into one mask."""
    if not (isinstance(h, int) and isinstance(w, int) and h > 0 and w > 0):
        raise ValueError(f"Polygon rasterization needs positive integer image dims, got h={h}, w={w}")
    lib = get_rle_library()
    rles = []
    for poly in polygons:
        xy = np.ascontiguousarray(poly, np.float64).reshape(-1)
        if xy.size < 6:
            continue  # a degenerate polygon (fewer than 3 vertices)
        buf = np.zeros(h * w + 2, np.uint32)
        n = lib.rle_from_polygon(
            xy.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_uint64(xy.size // 2),
            ctypes.c_uint64(h),
            ctypes.c_uint64(w),
            buf.ctypes.data_as(ctypes.c_void_p),
        )
        rles.append({"size": [h, w], "counts": buf[:n].copy()})
    if not rles:
        return {"size": [h, w], "counts": np.asarray([h * w], np.uint32)}
    if len(rles) == 1:
        return rles[0]
    return merge_union(rles)


def merge_union(rles: Sequence[RLE]) -> RLE:
    """Union of same-size RLEs at the run level (pycocotools' ``merge``), no dense masks."""
    h, w = rles[0]["size"]
    size = int(h) * int(w)
    starts_list, ends_list = [], []
    for r in rles:
        if list(r["size"]) != [h, w]:
            raise ValueError("All RLEs must share the same size for merging")
        cum = np.concatenate([[0], np.cumsum(np.asarray(r["counts"], np.int64))])
        starts_list.append(cum[1:-1:2] if cum.size > 2 else cum[1:0])
        ends_list.append(cum[2::2])
    starts = np.concatenate([s for s in starts_list if s.size] or [np.zeros(0, np.int64)])
    ends = np.concatenate([e for e in ends_list if e.size] or [np.zeros(0, np.int64)])
    if starts.size == 0:
        return {"size": [h, w], "counts": np.asarray([size], np.uint32)}
    order = np.argsort(starts, kind="stable")
    starts, ends = starts[order], ends[order]
    merged_s, merged_e = [int(starts[0])], [int(ends[0])]
    for s, e in zip(starts[1:], ends[1:]):
        if s <= merged_e[-1]:
            merged_e[-1] = max(merged_e[-1], int(e))
        else:
            merged_s.append(int(s))
            merged_e.append(int(e))
    counts = []
    pos = 0
    for s, e in zip(merged_s, merged_e):
        counts.append(s - pos)  # the zeros run (0 only for the first)
        counts.append(e - s)
        pos = e
    counts.append(size - pos)
    if counts[-1] == 0:
        counts.pop()
    return {"size": [h, w], "counts": np.asarray(counts, np.uint32)}
