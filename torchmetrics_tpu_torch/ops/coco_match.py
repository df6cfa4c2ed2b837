# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""K6 ``coco_match``: COCO's greedy matching of score-ordered detections to
ground truths for every (image, area range, IoU threshold), and its plain
version.

Counterpart of the ``lax.scan`` of ``_match_one_image`` in
``torchmetrics_tpu/functional/detection/map.py`` (vmapped over images),
without its area-range post-step, which the caller takes in PyTorch. The
kernel is ``csrc/coco_match.cu``; its source note gives the step, the bound
and the design. On CPU tensors :func:`coco_match` computes
:func:`coco_match_plain`; on CUDA tensors it launches the kernel or raises.
Both only compare and select, so they agree bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.ops import _build

Tensor = torch.Tensor

_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_PLAN_ARGTYPES = [ctypes.c_longlong] + [ctypes.c_int] * 4

#: pycocotools' bar is min(t, 1 - 1e-10); in float32 that constant is 1.0, as JAX's weak constant rounds
_BAR_CAP = float(np.float32(1 - 1e-10))


def match_bar(iou_thrs: Tensor) -> Tensor:
    """``min(t, 1 - 1e-10)`` of each float32 threshold, in float32 (a NaN stays NaN)."""
    return torch.minimum(iou_thrs.to(torch.float32), torch.tensor(_BAR_CAP, dtype=torch.float32, device=iou_thrs.device))


def _check(iou: Tensor, det_labels: Tensor, det_valid: Tensor, gt_labels: Tensor, gt_valid: Tensor,
           gt_crowd: Tensor, gt_ig: Tensor, iou_thrs: Tensor) -> Tuple[int, int, int, int, int]:
    if iou.ndim != 3 or iou.dtype != torch.float32:
        raise ValueError(f"coco_match: expected an (N, D, G) float32 IoU, got {tuple(iou.shape)} {iou.dtype}")
    n, d, g = iou.shape
    if gt_ig.ndim != 3 or gt_ig.shape[0] != n or gt_ig.shape[2] != g or gt_ig.dtype != torch.bool:
        raise ValueError(f"coco_match: expected an (N, A, G) bool gt_ig, got {tuple(gt_ig.shape)} {gt_ig.dtype}")
    a = gt_ig.shape[1]
    for name, x, shape, dtypes in (
        ("det_labels", det_labels, (n, d), (torch.int32,)), ("det_valid", det_valid, (n, d), (torch.bool,)),
        ("gt_labels", gt_labels, (n, g), (torch.int32,)), ("gt_valid", gt_valid, (n, g), (torch.bool,)),
        ("gt_crowd", gt_crowd, (n, g), (torch.bool,)),
    ):
        if tuple(x.shape) != shape or x.dtype not in dtypes:
            raise ValueError(f"coco_match: expected {name} {shape} {dtypes[0]}, got {tuple(x.shape)} {x.dtype}")
    if iou_thrs.ndim != 1:
        raise ValueError(f"coco_match: expected (T,) thresholds, got {tuple(iou_thrs.shape)}")
    return n, d, g, a, iou_thrs.shape[0]


def _last_best(vals: Tensor) -> Tuple[Tensor, Tensor]:
    """``(max, last argmax)`` along the last axis with ``jnp.max``'s and
    ``jnp.argmax``'s NaN rule: a NaN is the largest value (the max is NaN)
    and, over the reversed row, the first NaN wins: the last one here."""
    idx = torch.arange(vals.shape[-1], device=vals.device)
    isnan = torch.isnan(vals)
    anynan = isnan.any(-1)
    top = vals.amax(-1)
    last_top = torch.where(vals == top[..., None], idx, -1).amax(-1)
    last_nan = torch.where(isnan, idx, -1).amax(-1)
    return torch.where(anynan, float("nan"), top), torch.where(anynan, last_nan, last_top)


def coco_match_plain(iou: Tensor, det_labels: Tensor, det_valid: Tensor, gt_labels: Tensor, gt_valid: Tensor,
                     gt_crowd: Tensor, gt_ig: Tensor, iou_thrs: Tensor) -> Tuple[Tensor, Tensor]:
    """``(det_matched, det_ignored)``, each ``(N, A, T, D)`` bool: a loop over
    the detections, each step batched over images, area ranges, thresholds
    and ground truths, the order of ``_match_one_image``'s scan step. See
    :func:`coco_match` for the arguments."""
    n, d, g, a, t = _check(iou, det_labels, det_valid, gt_labels, gt_valid, gt_crowd, gt_ig, iou_thrs)
    dev = iou.device
    det_matched = torch.zeros((n, a, t, d), dtype=torch.bool, device=dev)
    det_ignored = torch.zeros_like(det_matched)
    if g == 0:
        return det_matched, det_ignored
    bar = match_bar(iou_thrs).to(dev)[None, None, :]  # (1, 1, T)
    pair_ok = det_valid[:, :, None] & gt_valid[:, None, :] & (det_labels[:, :, None] == gt_labels[:, None, :])
    ig = gt_ig[:, :, None, :]  # (N, A, 1, G)
    crowd = gt_crowd[:, None, None, :]
    minus_one = torch.tensor(-1.0, dtype=torch.float32, device=dev)
    gt_matched = torch.zeros((n, a, t, g), dtype=torch.bool, device=dev)
    for k in range(d):
        iou_d = iou[:, k, None, None, :]  # (N, 1, 1, G)
        ok_d = pair_ok[:, k, None, None, :]
        max1, best1 = _last_best(torch.where(ok_d & ~ig & ~gt_matched, iou_d, minus_one))
        max2, best2 = _last_best(torch.where(ok_d & ig & (crowd | ~gt_matched), iou_d, minus_one))
        ok1, ok2 = max1 >= bar, max2 >= bar
        matched = ok1 | ok2  # (N, A, T)
        m = torch.where(ok1, best1, best2)
        gt_matched = gt_matched | (torch.nn.functional.one_hot(m, g).to(torch.bool) & matched[..., None])
        det_matched[..., k] = matched
        det_ignored[..., k] = matched & torch.gather(gt_ig, 2, m)
    return det_matched, det_ignored


def coco_match_instantiation(n: int, d: int, g: int, a: int, t: int) -> int:
    """The kernel instantiation a launch at these sizes takes: 1-4, the words
    of its matched set in registers (G up to 128, the block's masks in shared
    memory), 0 the one that keeps masks, matched sets and output bits in a
    scratch, -1 no launch. Asks the built library (``csrc/coco_match.cu``'s
    plan), so it needs ``nvcc``."""
    fn = _build.function("coco_match_instantiation", _PLAN_ARGTYPES, library="coco_match")
    return fn(n, d, g, a, t)


def coco_match(iou: Tensor, det_labels: Tensor, det_valid: Tensor, gt_labels: Tensor, gt_valid: Tensor,
               gt_crowd: Tensor, gt_ig: Tensor, iou_thrs: Tensor) -> Tuple[Tensor, Tensor]:
    """``(det_matched, det_ignored)``, each ``(N, A, T, D)`` bool: COCO's
    greedy matching of every image's detections, in their (score) order.

    ``iou`` is (N, D, G) float32 (crowd-aware, any IoU type); ``det_labels``
    (N, D) and ``gt_labels`` (N, G) int32; ``det_valid`` (N, D), ``gt_valid``
    and ``gt_crowd`` (N, G) bool; ``gt_ig`` (N, A, G) bool, the ground truths
    ignored in each area range (crowd, or area outside the range); and
    ``iou_thrs`` (T,) float32, whose bar is ``min(t, 1 - 1e-10)`` in float32.
    CUDA input goes through the hand kernel, CPU input through
    :func:`coco_match_plain`; the result is bitwise the same.
    """
    if iou.device.type == "cpu":
        return coco_match_plain(iou, det_labels, det_valid, gt_labels, gt_valid, gt_crowd, gt_ig, iou_thrs)
    n, d, g, a, t = _check(iou, det_labels, det_valid, gt_labels, gt_valid, gt_crowd, gt_ig, iou_thrs)
    if iou.device.type != "cuda":
        raise ValueError(f"coco_match: input on {iou.device}; expected a CUDA device or the CPU")
    dev = iou.device
    det_matched = torch.empty((n, a, t, d), dtype=torch.bool, device=dev)
    det_ignored = torch.empty_like(det_matched)
    if det_matched.numel() == 0 or g == 0:  # nothing to match: no launch, and none is counted
        det_matched.zero_()
        det_ignored.zero_()
        return det_matched, det_ignored
    words = ctypes.c_longlong(0)
    _build.function("coco_match_scratch_words", _PLAN_ARGTYPES + [ctypes.POINTER(ctypes.c_longlong)],
                    library="coco_match")(n, d, g, a, t, ctypes.byref(words))
    words = words.value
    scratch = torch.empty(words, dtype=torch.int32, device=dev)  # the kernel initialises what it reads
    args = [x.contiguous() for x in (iou, det_labels, det_valid, gt_labels, gt_valid, gt_crowd, gt_ig)]
    bar = match_bar(iou_thrs.to(dev)).contiguous()
    fn = _build.function("coco_match", _ARGTYPES)
    with torch.cuda.device(dev):
        status = fn(
            *(x.data_ptr() for x in args), bar.data_ptr(), det_matched.data_ptr(), det_ignored.data_ptr(),
            scratch.data_ptr() if words else None, n, d, g, a, t, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(status, "coco_match")
    coco_match.launches += 1
    return det_matched, det_ignored


coco_match.launches = 0  # launches of the CUDA kernel (the plain version is not counted)
