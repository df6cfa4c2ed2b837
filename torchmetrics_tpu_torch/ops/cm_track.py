# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""K3 ``cm_track``: the Count-Min sketch's heavy-hitter table after a batch
of tags, and its plain version.

Counterpart of the ``lax.scan`` of ``track`` in
``torchmetrics_tpu/sketch/countmin.py::cm_update``. The kernel is
``csrc/cm_track.cu``; its source note gives the step, the bound and the
design. On CPU tensors :func:`cm_track` computes :func:`cm_track_plain`; on
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from torchmetrics_tpu_torch.ops import _build

_ARGTYPES = [
    ctypes.c_void_p,  # tags
    ctypes.c_void_p,  # ests
    ctypes.c_longlong,  # n
    ctypes.c_void_p,  # keys (in place)
    ctypes.c_void_p,  # counts (in place)
    ctypes.c_int,  # k
    ctypes.c_void_p,  # stream
]
_MAX_SLOTS = 1024


def cm_track_plain(
    tags: torch.Tensor, ests: torch.Tensor, hh_keys: torch.Tensor, hh_counts: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The table after scanning ``tags`` in order; see :func:`cm_track`.

    The scan's step as a loop over the tags, on host integers: per tag, the
    first tracked slot (a live slot holding the tag), else the first
    minimum; admitted when tracked or ``est`` beats that minimum.
    """
    keys = hh_keys.to(torch.int64).tolist()
    cnts = hh_counts.tolist()
    for tag, est in zip((tags.to(torch.int64) & 0xFFFFFFFF).tolist(), ests.tolist()):
        pos = next((j for j, (key, c) in enumerate(zip(keys, cnts)) if key == tag and c > 0), -1)
        if pos >= 0:
            cnts[pos] = max(cnts[pos], est)
            continue
        low = min(cnts)
        if est > low:
            pos = cnts.index(low)
            keys[pos], cnts[pos] = tag, est
    device = hh_keys.device
    return (
        torch.tensor(keys, dtype=torch.int64, device=device).to(torch.uint32),
        torch.tensor(cnts, dtype=torch.int32, device=device),
    )


def cm_track(
    tags: torch.Tensor, ests: torch.Tensor, hh_keys: torch.Tensor, hh_counts: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hh_keys, hh_counts)`` after every tag of the batch, in order.

    ``tags`` is (n,) int32 holding each tag's 32 bits, ``ests`` (n,) int32
    each tag's Count-Min estimate against the grid after the batch,
    ``hh_keys`` (k,) uint32 and ``hh_counts`` (k,) int32 the table before the
    batch (left unchanged; the result is new tensors).

    CUDA tensors go through the hand kernel (k <= 1024); CPU tensors through
    :func:`cm_track_plain`.
    """
    tensors = (tags, ests, hh_keys, hh_counts)
    if all(t.device.type == "cpu" for t in tensors):
        return cm_track_plain(tags, ests, hh_keys, hh_counts)
    device = tags.device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(f"cm_track: inputs on {[str(t.device) for t in tensors]}; expected one CUDA device")
    if tags.dtype != torch.int32 or ests.dtype != torch.int32 or tags.shape != ests.shape or tags.ndim != 1:
        raise ValueError(
            f"cm_track: expected (n,) int32 tags and estimates, got {tuple(tags.shape)} {tags.dtype}"
            f" and {tuple(ests.shape)} {ests.dtype}"
        )
    k = hh_keys.numel()
    if hh_keys.dtype != torch.uint32 or hh_counts.dtype != torch.int32 or hh_keys.shape != (k,) or hh_counts.shape != (k,):
        raise ValueError(
            f"cm_track: expected (k,) uint32 keys and int32 counts, got {tuple(hh_keys.shape)} {hh_keys.dtype}"
            f" and {tuple(hh_counts.shape)} {hh_counts.dtype}"
        )
    if not 1 <= k <= _MAX_SLOTS:
        raise ValueError(f"cm_track: the kernel holds 1..{_MAX_SLOTS} slots, got k={k}")
    keys, counts = hh_keys.clone(), hh_counts.clone()
    if tags.numel() == 0:  # nothing to scan: no launch, and none is counted
        return keys, counts
    tags, ests = tags.contiguous(), ests.contiguous()
    fn = _build.function("cm_track", _ARGTYPES)
    with torch.cuda.device(device):
        status = fn(
            tags.data_ptr(),
            ests.data_ptr(),
            tags.numel(),
            keys.data_ptr(),
            counts.data_ptr(),
            k,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(status, "cm_track")
    cm_track.launches += 1
    return keys, counts


cm_track.launches = 0  # launches of the CUDA kernel (the plain version is not counted)
