# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""K1 ``binned_curve_state``: the binned multi-threshold confusion state of the
precision-recall curve family, and its plain PyTorch version.

Counterpart of ``_binned_curve_state`` with ``_threshold_bins`` in
``torchmetrics_tpu/functional/classification/precision_recall_curve.py``.
The kernel is ``csrc/binned_curve_state.cu``; its source note gives the
bound and the design. On a CPU tensor :func:`binned_curve_state` computes
the plain version; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.ops import _build

_ARGTYPES = [
    ctypes.c_void_p,  # p
    ctypes.c_void_p,  # thresholds
    ctypes.c_void_p,  # target
    ctypes.c_int,  # target64
    ctypes.c_int,  # labels
    ctypes.c_longlong,  # n
    ctypes.c_int,  # k
    ctypes.c_int,  # t
    ctypes.c_int,  # uniform
    ctypes.c_float,  # lo
    ctypes.c_float,  # scale
    ctypes.c_int,  # vec4
    ctypes.c_void_p,  # scratch
    ctypes.c_void_p,  # state
    ctypes.c_void_p,  # stream
]


def _check_args(p: torch.Tensor, thresholds: torch.Tensor, target: torch.Tensor, labels: bool) -> None:
    if p.ndim != 2 or p.dtype != torch.float32:
        raise ValueError(f"binned_curve_state: expected (N, K) float32 probabilities, got {tuple(p.shape)} {p.dtype}")
    if thresholds.ndim != 1 or thresholds.dtype != torch.float32:
        raise ValueError(f"binned_curve_state: expected (T,) float32 thresholds, got {tuple(thresholds.shape)} {thresholds.dtype}")
    want = p.shape[:1] if labels else p.shape
    if tuple(target.shape) != tuple(want) or target.dtype not in (torch.int32, torch.int64):
        raise ValueError(
            f"binned_curve_state: expected an int32/int64 target of shape {tuple(want)}, got {tuple(target.shape)} {target.dtype}"
        )


def binned_curve_state_plain(
    p: torch.Tensor, thresholds: torch.Tensor, target: torch.Tensor, labels: bool
) -> torch.Tensor:
    """The (T, K, 2, 2) int32 state; see :func:`binned_curve_state`.

    The bucketize formulation step by step: the bin of every entry
    (``searchsorted``, NaN pinned to bin 0), one ``(bin, column, y)``
    histogram, and a prefix sum over the bins.
    """
    _check_args(p, thresholds, target, labels)
    n, k = p.shape
    len_t = thresholds.shape[0]
    # p >= NaN is false, so NaN thresholds (sorted last) never count
    bins = torch.searchsorted(thresholds[~torch.isnan(thresholds)], p.contiguous(), right=True)
    bins = torch.where(torch.isnan(p), torch.zeros_like(bins), bins)
    cols = torch.arange(k, device=p.device)
    t = target.to(torch.int32).to(torch.int64)  # an int64 label is cut to int32 first, as astype(jnp.int32) cuts it
    if labels:
        valid = (t >= 0)[:, None].expand(n, k)
        y = (t.clamp(0, k - 1)[:, None] == cols[None, :]).to(torch.int64)
    else:
        valid = t >= 0
        y = t.clamp(0, 1)
    flat = (bins * k + cols[None, :]) * 2 + y
    hist = torch.bincount(flat[valid], minlength=(len_t + 1) * k * 2).to(torch.int32).reshape(len_t + 1, k, 2)
    # below[t] = entries with p < thr_t (bin <= t); the last prefix row is the total
    cum = hist.cumsum(0, dtype=torch.int32)
    below = cum[:len_t]
    return torch.stack([below, cum[len_t:] - below], dim=-1)  # [t, k, target, pred]


def binned_curve_state(
    p: torch.Tensor,
    thresholds: torch.Tensor,
    target: torch.Tensor,
    labels: bool,
    affine: Optional[Tuple[float, float]] = None,
) -> torch.Tensor:
    """(T, K, 2, 2) int32 state ``[t, k, y, pred >= thresholds[t]]`` of one batch.

    ``p`` is (N, K) float32 probabilities and ``thresholds`` (T,) float32,
    sorted ascending with any NaN last. ``target`` is (N,) class indices when
    ``labels`` (``y = (min(target, K-1) == column)``) or (N, K) binary labels
    otherwise (``y = min(target, 1)``), int32 or int64 (cut to int32); a
    negative target masks its entry. NaN probabilities count below every
    threshold, +inf above every one. ``affine`` is ``(lo, scale)`` from
    :func:`~torchmetrics_tpu_torch.functional.classification.precision_recall_curve._uniform_grid`
    where the O(1) bin index is exact on this grid; otherwise the kernel
    searches the thresholds. The result does not depend on it.

    CUDA tensors go through the hand kernel; CPU tensors through
    :func:`binned_curve_state_plain`.
    """
    if p.device.type == "cpu" and thresholds.device.type == "cpu" and target.device.type == "cpu":
        return binned_curve_state_plain(p, thresholds, target, labels)
    if p.device.type != "cuda" or thresholds.device != p.device or target.device != p.device:
        raise ValueError(
            f"binned_curve_state: p on {p.device}, thresholds on {thresholds.device}, target on {target.device};"
            " expected one CUDA device"
        )
    _check_args(p, thresholds, target, labels)
    if not p.is_contiguous() or not thresholds.is_contiguous():
        raise ValueError("binned_curve_state: p and thresholds must be contiguous")
    n, k = p.shape
    len_t = thresholds.shape[0]
    scratch_len = (len_t + 1) * k * 2 + k  # the global histogram, and a ticket for each column tile (at most K)
    if scratch_len >= 2**31:
        raise ValueError(f"binned_curve_state: histogram of {(len_t + 1) * k * 2} bins does not fit int32 indexing")
    if n == 0 or k == 0 or len_t == 0:  # nothing to count: no launch, and none is counted
        return torch.zeros((len_t, k, 2, 2), dtype=torch.int32, device=p.device)
    target = target.contiguous()
    state = torch.empty((len_t, k, 2, 2), dtype=torch.int32, device=p.device)
    scratch = torch.zeros(scratch_len, dtype=torch.int32, device=p.device)
    lo, scale = affine if affine is not None else (0.0, 0.0)
    fn = _build.function("binned_curve_state", _ARGTYPES)
    with torch.cuda.device(p.device):
        status = fn(
            p.data_ptr(),
            thresholds.data_ptr(),
            target.data_ptr(),
            int(target.dtype == torch.int64),
            int(labels),
            n,
            k,
            len_t,
            int(affine is not None),
            lo,
            scale,
            int(k % 4 == 0 and p.data_ptr() % 16 == 0),
            scratch.data_ptr(),
            state.data_ptr(),
            torch.cuda.current_stream(p.device).cuda_stream,
        )
    _build.check(status, "binned_curve_state")
    binned_curve_state.launches += 1
    binned_curve_state.matrix_launches += int(not labels)
    return state


binned_curve_state.launches = 0  # launches of the CUDA kernel (the plain version is not counted)
binned_curve_state.matrix_launches = 0  # of them, launches in matrix mode (an (N, K) target: binary, micro, multilabel)
