# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""K2 ``stat_counts``: the multiclass stat scores tp, fp, tn, fn of a batch,
the argmax of the scores fused in, and its plain PyTorch version.

Counterpart of ``jnp.argmax`` in
``torchmetrics_tpu/functional/classification/stat_scores.py::_multiclass_stat_scores_format``
followed by the bincount branch of ``::_multiclass_stat_scores_update``.
The kernel is ``csrc/stat_counts.cu``; its source note gives the bound and
the design. On a CPU tensor :func:`stat_counts` computes the plain version;
on a CUDA tensor it launches the kernel or raises.

K2s, :func:`stat_counts_segmented`, is the sliced plan's mode of the same
kernel source: the counts of each cohort cell at once, each row added into
the cell ``slice_assign`` gave it (counterpart of JAX's per-row ``vmap`` of
the update, segment-summed over the cells).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.ops import _build
from torchmetrics_tpu_torch.utilities.data import _bincount

_ARGTYPES = [
    ctypes.c_void_p,  # preds
    ctypes.c_int,  # preds_mode
    ctypes.c_void_p,  # target
    ctypes.c_int,  # target64
    ctypes.c_longlong,  # n
    ctypes.c_int,  # num_classes
    ctypes.c_int,  # llpr
    ctypes.c_int,  # has_ignore
    ctypes.c_int,  # ignore_index
    ctypes.c_void_p,  # out
    ctypes.c_void_p,  # stream
]
_INTS = (torch.int32, torch.int64)


def _is_scores(preds: torch.Tensor, target: torch.Tensor) -> bool:
    """(N, C) scores with an (N,) target; otherwise both are class indices."""
    return preds.ndim == target.ndim + 1


def stat_counts_plain(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> torch.Tensor:
    """The (4, C) int32 rows tp, fp, tn, fn; see :func:`stat_counts`.

    The JAX package's arithmetic step for step: the argmax of scores, int32
    indices ``target * C + pred`` (``pred`` clamped and ignored entries sent
    to a trash bin at ``C**2`` when ``ignore_index`` is set), counted with
    ``jnp.bincount`` semantics (:func:`~torchmetrics_tpu_torch.utilities.data._bincount`),
    then the diagonal and the row and column sums of the matrix.
    """
    c = num_classes
    if _is_scores(preds, target):
        preds = torch.argmax(preds, dim=1)
    preds = preds.reshape(-1).to(torch.int32)
    target = target.reshape(-1).to(torch.int32)
    if ignore_index is not None:
        valid = target != ignore_index
        idx = torch.where(valid, target * c + preds.clamp(0, c - 1), torch.full_like(target, c * c))
        bins = _bincount(idx, minlength=c * c + 1)[: c * c]
    else:
        bins = _bincount(target * c + preds, minlength=c * c)
    confmat = bins.reshape(c, c)
    tp = torch.diagonal(confmat)
    fp = confmat.sum(0, dtype=torch.int32) - tp
    fn = confmat.sum(1, dtype=torch.int32) - tp
    tn = confmat.sum(dtype=torch.int32) - (fp + fn + tp)
    return torch.stack([tp, fp, tn, fn])


def stat_counts_segmented_plain(
    preds: torch.Tensor,
    target: torch.Tensor,
    cells: torch.Tensor,
    num_cells: int,
    num_classes: int,
    ignore_index: Optional[int] = None,
) -> torch.Tensor:
    """The (num_cells, 4, C) int32 rows tp, fp, tn, fn of each cell; see
    :func:`stat_counts_segmented`.

    :func:`stat_counts_plain`'s arithmetic with the cell in the index: one
    ``(cell, target, pred)`` histogram (rows of cell ``-1``, ignored rows and
    indices past the last bin sent to a trash bin), then per cell the
    diagonal and the row and column sums of its matrix.
    """
    c = num_classes
    if _is_scores(preds, target):
        preds = torch.argmax(preds, dim=1)
    preds = preds.reshape(-1).to(torch.int32)
    target = target.reshape(-1).to(torch.int32)
    cells = cells.reshape(-1).to(torch.int64)
    if ignore_index is not None:
        b = torch.where(target != ignore_index, target * c + preds.clamp(0, c - 1), torch.full_like(target, c * c))
    else:
        b = target * c + preds
    b = b.to(torch.int64).clamp(min=0)
    trash = num_cells * c * c
    idx = torch.where((b < c * c) & (cells >= 0), cells * (c * c) + b, trash)
    confmat = _bincount(idx, minlength=trash).reshape(num_cells, c, c)
    tp = torch.diagonal(confmat, dim1=1, dim2=2)
    fp = confmat.sum(1, dtype=torch.int32) - tp
    fn = confmat.sum(2, dtype=torch.int32) - tp
    tn = confmat.sum((1, 2), dtype=torch.int32)[:, None] - (fp + fn + tp)
    return torch.stack([tp, fp, tn, fn], dim=1)


def _lanes_per_row_log2(vectors: int) -> int:
    """log2 of the lanes that share a row: about four vectors per lane, at most a warp."""
    llpr = 0
    while (1 << llpr) < 32 and (1 << llpr) * 4 < vectors:
        llpr += 1
    return llpr


def stat_counts(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> torch.Tensor:
    """(4, C) int32 rows tp, fp, tn, fn of one batch of multiclass predictions.

    ``preds`` is (N, C) float32 scores, whose argmax along the classes is the
    prediction (``jnp.argmax``: the first NaN, else the first maximum), or
    (N,) int32/int64 class indices; ``target`` is (N,) int32/int64. int64
    labels are cut to int32, as the JAX update casts them.

    CUDA tensors go through the hand kernel; CPU tensors through
    :func:`stat_counts_plain`.
    """
    if preds.device.type == "cpu" and target.device.type == "cpu":
        return stat_counts_plain(preds, target, num_classes, ignore_index)
    if preds.device.type != "cuda" or target.device != preds.device:
        raise ValueError(f"stat_counts: preds on {preds.device} and target on {target.device}; expected one CUDA device")
    if target.dtype not in _INTS:
        raise TypeError(f"stat_counts: expected an int32/int64 target, got {target.dtype}")
    if not 1 <= num_classes <= 46340:  # C*C must fit in int32
        raise ValueError(f"stat_counts: num_classes={num_classes} out of range")
    if ignore_index is not None and not -(2**31) <= ignore_index < 2**31:
        raise ValueError(f"stat_counts: ignore_index={ignore_index} does not fit in int32")
    target = target.reshape(-1).contiguous()
    scores = _is_scores(preds, target)
    llpr = 0
    if scores:
        if preds.dtype != torch.float32 or preds.shape != (target.numel(), num_classes):
            raise ValueError(
                f"stat_counts: expected ({target.numel()}, {num_classes}) float32 scores, got {tuple(preds.shape)} {preds.dtype}"
            )
        preds = preds.contiguous()
        vec4 = num_classes % 4 == 0 and preds.data_ptr() % 16 == 0
        mode = 0 if vec4 else 1
        llpr = _lanes_per_row_log2(num_classes // 4 if vec4 else num_classes)
    else:
        if preds.dtype not in _INTS:
            raise TypeError(f"stat_counts: expected int32/int64 labels or (N, C) float32 scores, got {preds.dtype}")
        preds = preds.reshape(-1).contiguous()
        if preds.numel() != target.numel():
            raise ValueError(f"stat_counts: {preds.numel()} preds but {target.numel()} targets")
        mode = 2 if preds.dtype == torch.int32 else 3
    out = torch.zeros((4, num_classes), dtype=torch.int32, device=preds.device)
    if target.numel() == 0:  # nothing to count: no launch, and none is counted
        return out
    fn = _build.function("stat_counts", _ARGTYPES)
    with torch.cuda.device(preds.device):
        status = fn(
            preds.data_ptr(),
            mode,
            target.data_ptr(),
            int(target.dtype == torch.int64),
            target.numel(),
            num_classes,
            llpr,
            int(ignore_index is not None),
            ignore_index if ignore_index is not None else 0,
            out.data_ptr(),
            torch.cuda.current_stream(preds.device).cuda_stream,
        )
    _build.check(status, "stat_counts")
    stat_counts.launches += 1
    return out


stat_counts.launches = 0  # launches of the CUDA kernel (the plain version is not counted)

_SEGMENTED_ARGTYPES = _ARGTYPES[:4] + [ctypes.c_void_p] + [  # cells
    ctypes.c_longlong,  # n
    ctypes.c_int,  # num_classes
    ctypes.c_int,  # num_cells
    ctypes.c_int,  # llpr
    ctypes.c_int,  # has_ignore
    ctypes.c_int,  # ignore_index
    ctypes.c_int,  # route
    ctypes.c_void_p,  # scratch
    ctypes.c_void_p,  # out
    ctypes.c_void_p,  # stream
]
# K2s's routes (csrc/stat_counts.cu, enum Route)
_ONE_CELL, _CELL_COUNTERS, _GLOBAL = 0, 1, 2
_CELL_SMEM_MAX = 227 * 1024  # kCellSmemMax in csrc/stat_counts.cu


def _cell_counter_bytes(num_cells: int, num_classes: int) -> int:
    """The cell counters' shared memory: three 16-bit counters a class and cell, two a word."""
    return (num_cells * 3 * num_classes + 1) // 2 * 4


def _segmented_route(num_cells: int, num_classes: int) -> int:
    """The route K2s takes for a shape (see ``csrc/stat_counts.cu``)."""
    if num_cells == 1:
        return _ONE_CELL
    if _cell_counter_bytes(num_cells, num_classes) <= _CELL_SMEM_MAX:
        return _CELL_COUNTERS
    return _GLOBAL


def _segmented_buffers(route: int, num_cells: int, num_classes: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, scratch)`` of a route: zeroed where the route adds into them,
    uninitialised where a launch writes them."""
    shape = (num_cells, 4, num_classes)
    if route == _ONE_CELL:
        out = torch.zeros(shape, dtype=torch.int32, device=device)
        return out, out
    if route == _CELL_COUNTERS:  # the derive launch writes every output word
        return (torch.empty(shape, dtype=torch.int32, device=device),
                torch.zeros(num_cells * 3 * num_classes, dtype=torch.int32, device=device))
    return torch.zeros(shape, dtype=torch.int32, device=device), torch.zeros(num_cells, dtype=torch.int32, device=device)


def _kernel_preds(preds: torch.Tensor, target: torch.Tensor, num_classes: int, who: str) -> Tuple[torch.Tensor, int, int]:
    """``(preds, preds_mode, llpr)`` as the kernel takes them (see ``csrc/stat_counts.cu``)."""
    if _is_scores(preds, target):
        if preds.dtype != torch.float32 or preds.shape != (target.numel(), num_classes):
            raise ValueError(
                f"{who}: expected ({target.numel()}, {num_classes}) float32 scores, got {tuple(preds.shape)} {preds.dtype}"
            )
        preds = preds.contiguous()
        vec4 = num_classes % 4 == 0 and preds.data_ptr() % 16 == 0
        return preds, 0 if vec4 else 1, _lanes_per_row_log2(num_classes // 4 if vec4 else num_classes)
    if preds.dtype not in _INTS:
        raise TypeError(f"{who}: expected int32/int64 labels or (N, C) float32 scores, got {preds.dtype}")
    preds = preds.reshape(-1).contiguous()
    if preds.numel() != target.numel():
        raise ValueError(f"{who}: {preds.numel()} preds but {target.numel()} targets")
    return preds, 2 if preds.dtype == torch.int32 else 3, 0


def stat_counts_segmented(
    preds: torch.Tensor,
    target: torch.Tensor,
    cells: torch.Tensor,
    num_cells: int,
    num_classes: int,
    ignore_index: Optional[int] = None,
) -> torch.Tensor:
    """(num_cells, 4, C) int32 rows tp, fp, tn, fn of each cohort cell.

    ``preds`` and ``target`` as :func:`stat_counts` takes them; ``cells`` is
    (N,) int32, the cell of each row, ``-1`` for a row that is dropped (it
    spilled from the slice table). Cell ``k``'s rows are :func:`stat_counts`
    of the rows whose cell is ``k``, bit for bit.

    CUDA tensors go through the hand kernel (K2s); CPU tensors through
    :func:`stat_counts_segmented_plain`.
    """
    tensors = (preds, target, cells)
    if all(t.device.type == "cpu" for t in tensors):
        return stat_counts_segmented_plain(preds, target, cells, num_cells, num_classes, ignore_index)
    if preds.device.type != "cuda" or any(t.device != preds.device for t in tensors):
        raise ValueError(f"stat_counts_segmented: tensors on {[str(t.device) for t in tensors]}; expected one CUDA device")
    if target.dtype not in _INTS:
        raise TypeError(f"stat_counts_segmented: expected an int32/int64 target, got {target.dtype}")
    if not 1 <= num_classes <= 46340:  # C*C must fit in int32
        raise ValueError(f"stat_counts_segmented: num_classes={num_classes} out of range")
    if ignore_index is not None and not -(2**31) <= ignore_index < 2**31:
        raise ValueError(f"stat_counts_segmented: ignore_index={ignore_index} does not fit in int32")
    target = target.reshape(-1).contiguous()
    if cells.dtype != torch.int32 or cells.numel() != target.numel():
        raise ValueError(f"stat_counts_segmented: expected ({target.numel()},) int32 cells, got {tuple(cells.shape)} {cells.dtype}")
    cells = cells.reshape(-1).contiguous()
    preds, mode, llpr = _kernel_preds(preds, target, num_classes, "stat_counts_segmented")
    n = target.numel()
    if n == 0 or num_cells == 0:  # nothing to count: no launch, and none is counted
        return torch.zeros((num_cells, 4, num_classes), dtype=torch.int32, device=preds.device)
    route = _segmented_route(num_cells, num_classes)
    out, scratch = _segmented_buffers(route, num_cells, num_classes, preds.device)
    fn = _build.function("stat_counts_segmented", _SEGMENTED_ARGTYPES, library="stat_counts")
    with torch.cuda.device(preds.device):
        status = fn(
            preds.data_ptr(),
            mode,
            target.data_ptr(),
            int(target.dtype == torch.int64),
            cells.data_ptr(),
            n,
            num_classes,
            num_cells,
            llpr,
            int(ignore_index is not None),
            ignore_index if ignore_index is not None else 0,
            route,
            scratch.data_ptr(),
            out.data_ptr(),
            torch.cuda.current_stream(preds.device).cuda_stream,
        )
    _build.check(status, "stat_counts_segmented")
    stat_counts_segmented.launches += 1
    return out


stat_counts_segmented.launches = 0  # launches of the CUDA kernel (the plain version is not counted)
