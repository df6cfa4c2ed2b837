# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""K1 ``binned_curve_state``: the binned multi-threshold confusion state of the
precision-recall curve family, and its plain PyTorch version.

Counterpart of ``_binned_curve_state`` with ``_threshold_bins`` in
``torchmetrics_tpu/functional/classification/precision_recall_curve.py``.
The kernel is ``csrc/binned_curve_state.cu``; its source note gives the
bound and the design. On a CPU tensor :func:`binned_curve_state` computes
the plain version; on a CUDA tensor it launches the kernel or raises.

K1s, :func:`binned_curve_state_segmented`, is the sliced plan's mode of the
same kernel source: the state of each cohort cell at once, each row's
entries counted into the cell ``slice_assign`` gave it (counterpart of
JAX's per-row ``vmap`` of the update, segment-summed over the cells).
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


_SORT_ROWS = 4096  # rows per block of K1s's counting sort (kSortRows in csrc/binned_curve_state.cu)
_SEGMENTED_ARGTYPES = [
    ctypes.c_void_p,  # p
    ctypes.c_void_p,  # thresholds
    ctypes.c_void_p,  # target
    ctypes.c_int,  # target64
    ctypes.c_int,  # labels
    ctypes.c_void_p,  # cells
    ctypes.c_longlong,  # n
    ctypes.c_int,  # k
    ctypes.c_int,  # t
    ctypes.c_int,  # num_cells
    ctypes.c_int,  # uniform
    ctypes.c_float,  # lo
    ctypes.c_float,  # scale
    ctypes.c_int,  # vec4
    ctypes.c_void_p,  # hist (scratch, zeroed)
    ctypes.c_void_p,  # the counting sort (scratch)
    ctypes.c_void_p,  # state
    ctypes.c_void_p,  # stream
]


def _check_cells(cells: torch.Tensor, n: int, who: str) -> None:
    if cells.dtype != torch.int32 or tuple(cells.shape) != (n,):
        raise ValueError(f"{who}: expected ({n},) int32 cells, got {tuple(cells.shape)} {cells.dtype}")


def binned_curve_state_segmented_plain(
    p: torch.Tensor, thresholds: torch.Tensor, target: torch.Tensor, labels: bool, cells: torch.Tensor, num_cells: int
) -> torch.Tensor:
    """The (num_cells, T, K, 2, 2) int32 state; see :func:`binned_curve_state_segmented`.

    :func:`binned_curve_state_plain`'s bucketize formulation with the cell in
    the index: one ``(cell, bin, column, y)`` histogram (entries of cell
    ``-1`` and masked entries sent to a trash bin), then the prefix sum over
    the bins of each cell.
    """
    _check_args(p, thresholds, target, labels)
    n, k = p.shape
    _check_cells(cells, n, "binned_curve_state_segmented")
    len_t = thresholds.shape[0]
    bins = torch.searchsorted(thresholds[~torch.isnan(thresholds)], p.contiguous(), right=True)
    bins = torch.where(torch.isnan(p), torch.zeros_like(bins), bins)
    cols = torch.arange(k, device=p.device)
    t = target.to(torch.int32).to(torch.int64)
    if labels:
        valid = (t >= 0)[:, None].expand(n, k)
        y = (t.clamp(0, k - 1)[:, None] == cols[None, :]).to(torch.int64)
    else:
        valid = t >= 0
        y = t.clamp(0, 1)
    cell = cells.to(torch.int64)[:, None].expand(n, k)
    trash = num_cells * (len_t + 1) * k * 2
    flat = ((cell * (len_t + 1) + bins) * k + cols[None, :]) * 2 + y
    flat = torch.where(valid & (cell >= 0), flat, trash)
    hist = torch.zeros(trash + 1, dtype=torch.int32, device=p.device)
    hist = hist.index_add(0, flat.reshape(-1), torch.ones((), dtype=torch.int32, device=p.device).expand(flat.numel()))
    cum = hist[:trash].reshape(num_cells, len_t + 1, k, 2).cumsum(1, dtype=torch.int32)
    below = cum[:, :len_t]
    return torch.stack([below, cum[:, len_t:] - below], dim=-1)  # [cell, t, k, target, pred]


def binned_curve_state_segmented(
    p: torch.Tensor,
    thresholds: torch.Tensor,
    target: torch.Tensor,
    labels: bool,
    cells: torch.Tensor,
    num_cells: int,
    affine: Optional[Tuple[float, float]] = None,
) -> torch.Tensor:
    """(num_cells, T, K, 2, 2) int32 state of each cohort cell.

    ``p``, ``thresholds``, ``target``, ``labels`` and ``affine`` as
    :func:`binned_curve_state` takes them; ``cells`` is (N,) int32, the cell
    of each row of ``p``, ``-1`` for a row that is dropped (it spilled from
    the slice table, or the StateGuard's mask refused it). Cell ``c``'s state
    is :func:`binned_curve_state` of the rows whose cell is ``c``, bit for bit.

    CUDA tensors go through the hand kernel (K1s: K1 with a row mask at one
    cell, else a counting sort of the rows by cell and K1's shared-memory
    count per run of a cell); CPU tensors through
    :func:`binned_curve_state_segmented_plain`.
    """
    tensors = (p, thresholds, target, cells)
    if all(t.device.type == "cpu" for t in tensors):
        return binned_curve_state_segmented_plain(p, thresholds, target, labels, cells, num_cells)
    if p.device.type != "cuda" or any(t.device != p.device for t in tensors):
        raise ValueError(f"binned_curve_state_segmented: tensors on {[str(t.device) for t in tensors]}; expected one CUDA device")
    _check_args(p, thresholds, target, labels)
    n, k = p.shape
    _check_cells(cells, n, "binned_curve_state_segmented")
    len_t = thresholds.shape[0]
    if num_cells * (len_t + 1) * k * 2 + k >= 2**31 or n + num_cells * -(-n // _SORT_ROWS) >= 2**31:
        raise ValueError(f"binned_curve_state_segmented: {num_cells} cells of ({len_t + 1}, {k}, 2) bins do not fit int32 indexing")
    if n == 0 or k == 0 or len_t == 0 or num_cells == 0:  # nothing to count: no launch, and none is counted
        return torch.zeros((num_cells, len_t, k, 2, 2), dtype=torch.int32, device=p.device)
    state = torch.empty((num_cells, len_t, k, 2, 2), dtype=torch.int32, device=p.device)  # the kernel writes all of it
    p, thresholds, target, cells = p.contiguous(), thresholds.contiguous(), target.contiguous(), cells.contiguous()
    # the (num_cells, T+1, K, 2) histogram, then K1's tickets at one cell
    hist = torch.zeros(num_cells * (len_t + 1) * k * 2 + k, dtype=torch.int32, device=p.device)
    # the counting sort's cell offsets, row order and per-block counts (K1 at one cell needs none)
    sort_len = num_cells + 1 + n + num_cells * -(-n // _SORT_ROWS)
    sort = torch.empty(sort_len, dtype=torch.int32, device=p.device) if num_cells > 1 else hist
    lo, scale = affine if affine is not None else (0.0, 0.0)
    fn = _build.function("binned_curve_state_segmented", _SEGMENTED_ARGTYPES, library="binned_curve_state")
    with torch.cuda.device(p.device):
        status = fn(
            p.data_ptr(),
            thresholds.data_ptr(),
            target.data_ptr(),
            int(target.dtype == torch.int64),
            int(labels),
            cells.data_ptr(),
            n,
            k,
            len_t,
            num_cells,
            int(affine is not None),
            lo,
            scale,
            int(k % 4 == 0 and p.data_ptr() % 16 == 0),
            hist.data_ptr(),
            sort.data_ptr(),
            state.data_ptr(),
            torch.cuda.current_stream(p.device).cuda_stream,
        )
    _build.check(status, "binned_curve_state_segmented")
    binned_curve_state_segmented.launches += 1
    binned_curve_state_segmented.matrix_launches += int(not labels)
    return state


binned_curve_state_segmented.launches = 0  # launches of the CUDA kernel (the plain version is not counted)
binned_curve_state_segmented.matrix_launches = 0  # of them, launches in matrix mode
