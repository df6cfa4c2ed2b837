# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""K3 ``cm_track``: the Count-Min sketch's heavy-hitter table after a batch
of tags, and its plain version.

Counterpart of the ``lax.scan`` of ``track`` in
``torchmetrics_tpu/sketch/countmin.py::cm_update``. The kernel is
``csrc/cm_track.cu``; its source note gives the step, the two lemmas that
let it skip steps that change nothing, the bound and the design. On CPU
tensors :func:`cm_track` computes :func:`cm_track_plain`; on CUDA tensors it
launches the kernel or raises. :func:`cm_track_kept` names on the host the
tags the kernel steps through.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from torchmetrics_tpu_torch.ops import _build

_ARGTYPES = [
    ctypes.c_void_p,  # tags
    ctypes.c_void_p,  # ests
    ctypes.c_longlong,  # n
    ctypes.c_void_p,  # keys (in place)
    ctypes.c_void_p,  # counts (in place)
    ctypes.c_int,  # k
    ctypes.c_void_p,  # scratch
    ctypes.c_longlong,  # slots of the first-occurrence table
    ctypes.c_void_p,  # stream
]
_MAX_SLOTS = 1024
_TILE = 16384  # tags per tile of the serial kernel (kTile in csrc/cm_track.cu)


def _step(keys: List[int], cnts: List[int], tag: int, est: int) -> None:
    """One step of the scan on host integers: the first tracked slot (a live
    slot holding the tag), else the first minimum; admitted when tracked or
    ``est`` beats that minimum."""
    at = 0
    while tag in keys[at:]:
        at = keys.index(tag, at)
        if cnts[at] > 0:
            cnts[at] = max(cnts[at], est)
            return
        at += 1
    low = min(cnts)
    if est > low:
        pos = cnts.index(low)
        keys[pos], cnts[pos] = tag, est


def cm_track_plain(
    tags: torch.Tensor, ests: torch.Tensor, hh_keys: torch.Tensor, hh_counts: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The table after scanning ``tags`` in order; see :func:`cm_track`.

    The scan's step (:func:`_step`) as a loop over every tag, on host integers.
    """
    keys = hh_keys.to(torch.int64).tolist()
    cnts = hh_counts.tolist()
    for tag, est in zip((tags.to(torch.int64) & 0xFFFFFFFF).tolist(), ests.tolist()):
        _step(keys, cnts, tag, est)
    device = hh_keys.device
    return (
        torch.tensor(keys, dtype=torch.int64, device=device).to(torch.uint32),
        torch.tensor(cnts, dtype=torch.int32, device=device),
    )


def _filter_holds(tags: torch.Tensor, ests: torch.Tensor, hh_keys: torch.Tensor, hh_counts: torch.Tensor) -> bool:
    """The preconditions of the kernel's first-occurrence filter: each tag
    has one estimate in the batch, every count is ``>= 0``, and no two live
    slots (count ``> 0``) hold one key."""
    cnts = hh_counts.to(torch.int64).cpu()
    live = hh_keys.to(torch.int64).cpu()[cnts > 0]
    if not bool((cnts >= 0).all()) or live.unique().numel() != live.numel():
        return False
    _, inverse = torch.unique(tags.to(torch.int64).cpu(), return_inverse=True)
    e = ests.to(torch.int64).cpu()
    size = int(inverse.max()) + 1 if inverse.numel() else 0
    low = torch.zeros(size, dtype=torch.int64).scatter_reduce(0, inverse, e, "amin", include_self=False)
    high = torch.zeros(size, dtype=torch.int64).scatter_reduce(0, inverse, e, "amax", include_self=False)
    return bool(torch.equal(low, high))


def _filter_trace(
    tags: torch.Tensor, ests: torch.Tensor, hh_keys: torch.Tensor, hh_counts: torch.Tensor, tile: int = _TILE
) -> Tuple[bool, List[int], int]:
    """What the kernel's filters do with a batch: whether the preconditions
    hold (the filtered mode), the indices the tile filters keep in order,
    and the steps the chain runs on them.

    In the filtered mode, tile by tile (``tile`` tags each), an index is kept
    when it is its tag's first occurrence in the batch and its estimate
    beats the table's minimum at the tile's start; the chain then runs a
    step for a kept tag whose estimate still beats the minimum when its turn
    comes. Otherwise every index is kept and stepped. The table is advanced
    by the scan's step over the kept tags only.
    """
    n = tags.numel()
    if not _filter_holds(tags, ests, hh_keys, hh_counts):
        return False, list(range(n)), n
    t = tags.to(torch.int64).cpu() & 0xFFFFFFFF
    e = ests.to(torch.int64).cpu()
    index = torch.arange(n)
    uniq, inverse = torch.unique(t, return_inverse=True)
    first_at = torch.full((uniq.numel(),), n, dtype=torch.int64).scatter_reduce(0, inverse, index, "amin")
    is_first = first_at[inverse] == index
    keys = hh_keys.to(torch.int64).tolist()
    cnts = hh_counts.tolist()
    tag_list, est_list = t.tolist(), e.tolist()
    kept: List[int] = []
    steps = 0
    for start in range(0, n, tile):
        low = min(cnts)
        chunk = (torch.nonzero(is_first[start : start + tile] & (e[start : start + tile] > low)).flatten() + start).tolist()
        for i in chunk:
            if est_list[i] > min(cnts):
                steps += 1
                _step(keys, cnts, tag_list[i], est_list[i])
        kept.extend(chunk)
    return True, kept, steps


def cm_track_kept(
    tags: torch.Tensor, ests: torch.Tensor, hh_keys: torch.Tensor, hh_counts: torch.Tensor, tile: int = _TILE
) -> torch.Tensor:
    """(m,) int64 indices of the tags that :func:`cm_track`'s kernel keeps, in order.

    Scanning only these tags gives the same table as scanning every tag: a
    later occurrence of a tag is a no-op (lemma (a), given the
    preconditions of :func:`_filter_holds`), and so is any tag whose
    estimate does not beat the table's minimum at an earlier step (lemma
    (b)); ``csrc/cm_track.cu`` proves both. Where the preconditions fail,
    every index. The main path never calls this: it states on the host
    what the kernel filters, for the tests.
    """
    return torch.tensor(_filter_trace(tags, ests, hh_keys, hh_counts, tile)[1], dtype=torch.int64)


def _check(tags: torch.Tensor, ests: torch.Tensor, hh_keys: torch.Tensor, hh_counts: torch.Tensor) -> None:
    tensors = (tags, ests, hh_keys, hh_counts)
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
    if tags.numel() >= 2**31:
        raise ValueError(f"cm_track: the kernel indexes tags in 32 bits, got n={tags.numel()}")


def _launch(
    tags: torch.Tensor, ests: torch.Tensor, hh_keys: torch.Tensor, hh_counts: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The kernel's table, and a view of its three counters in the scratch
    (``None`` for an empty batch, which launches nothing)."""
    _check(tags, ests, hh_keys, hh_counts)
    keys, counts = hh_keys.clone(), hh_counts.clone()
    n = tags.numel()
    if n == 0:  # nothing to scan: no launch, and none is counted
        return keys, counts, None
    tags, ests = tags.contiguous(), ests.contiguous()
    # the kernel reads both in int4 loads: a view that starts off 16 bytes is copied
    tags, ests = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (tags, ests))
    slots = 1 << (2 * n - 1).bit_length()  # a power of two >= 2n
    words = (n + 31) // 32
    # the first-occurrence table (int64 entries, cleared by the kernel's memset), the marks, the counters and a flag
    scratch = torch.empty(slots * 2 + words + 4, dtype=torch.int32, device=tags.device)
    fn = _build.function("cm_track", _ARGTYPES)
    device = tags.device
    with torch.cuda.device(device):
        status = fn(
            tags.data_ptr(),
            ests.data_ptr(),
            n,
            keys.data_ptr(),
            counts.data_ptr(),
            hh_keys.numel(),
            scratch.data_ptr(),
            slots,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(status, "cm_track")
    cm_track.launches += 1
    return keys, counts, scratch[slots * 2 + words : slots * 2 + words + 3]


def cm_track(
    tags: torch.Tensor, ests: torch.Tensor, hh_keys: torch.Tensor, hh_counts: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hh_keys, hh_counts)`` after every tag of the batch, in order.

    ``tags`` is (n,) int32 holding each tag's 32 bits, ``ests`` (n,) int32
    each tag's Count-Min estimate against the grid after the batch,
    ``hh_keys`` (k,) uint32 and ``hh_counts`` (k,) int32 the table before the
    batch (left unchanged; the result is new tensors).

    CUDA tensors go through the hand kernel (k <= 1024), which steps only
    through the tags :func:`cm_track_kept` names; CPU tensors through
    :func:`cm_track_plain`.
    """
    if all(t.device.type == "cpu" for t in (tags, ests, hh_keys, hh_counts)):
        return cm_track_plain(tags, ests, hh_keys, hh_counts)
    keys, counts, _ = _launch(tags, ests, hh_keys, hh_counts)
    return keys, counts


def cm_track_stats(
    tags: torch.Tensor, ests: torch.Tensor, hh_keys: torch.Tensor, hh_counts: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`cm_track` and what its filters did: (3,) int32 ``[filtered
    mode (1) or every tag kept (0), tags the tile filters kept, steps the
    chain ran]``.

    A debug read for measurements: the kernel writes the counters on the
    card; on CPU tensors they come from :func:`_filter_trace` beside
    :func:`cm_track_plain`. Counted as a launch of :func:`cm_track`.
    """
    if all(t.device.type == "cpu" for t in (tags, ests, hh_keys, hh_counts)):
        filtered, kept, steps = _filter_trace(tags, ests, hh_keys, hh_counts)
        return (*cm_track_plain(tags, ests, hh_keys, hh_counts), torch.tensor([int(filtered), len(kept), steps], dtype=torch.int32))
    keys, counts, stats = _launch(tags, ests, hh_keys, hh_counts)
    if stats is None:
        stats = torch.tensor([int(_filter_holds(tags, ests, hh_keys, hh_counts)), 0, 0], dtype=torch.int32, device=tags.device)
    return keys, counts, stats


cm_track.launches = 0  # launches of the CUDA kernel (the plain version is not counted)
