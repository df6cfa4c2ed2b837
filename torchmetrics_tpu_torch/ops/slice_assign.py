# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""K4 ``slice_assign``: one batch of cohort keys placed in the sliced plan's
slice table, and its plain version.

Counterpart of ``torchmetrics_tpu/parallel/sliced.py::_assign_cells`` (with
``::_hash_rows``). The kernel is ``csrc/slice_assign.cu``; its source note
gives the algorithm, the bound and the design. On CPU tensors
:func:`slice_assign` computes :func:`slice_assign_plain`; on CUDA tensors it
launches the kernel or raises. Both update the table in place.

**Hashing in int64.** Torch's ``uint32`` has no shifts or remainder on the
CPU, so the plain version mixes the keys in int64 tensors holding values in
``[0, 2**32)`` with the HyperLogLog sketch's 32-bit helpers.
"""
from __future__ import annotations

import ctypes

import torch

from torchmetrics_tpu_torch.ops import _build
from torchmetrics_tpu_torch.sketch.hll import _MASK32, _fmix32, _mul32

_ARGTYPES = [
    ctypes.c_void_p,  # kmat
    ctypes.c_int,  # w
    ctypes.c_longlong,  # b
    ctypes.c_void_p,  # keys (in place)
    ctypes.c_void_p,  # occupied (in place)
    ctypes.c_int,  # n
    ctypes.c_void_p,  # spills (in place)
    ctypes.c_void_p,  # cells
    ctypes.c_void_p,  # scratch
    ctypes.c_void_p,  # stream
]
_MAX_SMEM_CLAIMS = 12288  # csrc/slice_assign.cu kMaxSmemClaims


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK32) | (x >> (32 - r))


def hash_rows(kmat: torch.Tensor) -> torch.Tensor:
    """JAX's ``_hash_rows``: the murmur3-style mix of each row's key columns,
    as int64 values in ``[0, 2**32)``."""
    h = torch.full((kmat.shape[0],), 0x811C9DC5, dtype=torch.int64, device=kmat.device)
    for i in range(kmat.shape[1]):
        k = _mul32(kmat[:, i].to(torch.int64) & _MASK32, 0xCC9E2D51)
        k = _mul32(_rotl32(k, 15), 0x1B873593)
        h = (_mul32(_rotl32(h ^ k, 13), 5) + 0xE6546B64) & _MASK32
    return _fmix32(h)


def _check_args(keys: torch.Tensor, occupied: torch.Tensor, spills: torch.Tensor, kmat: torch.Tensor) -> None:
    if keys.ndim != 2 or keys.dtype != torch.int32 or not keys.is_contiguous():
        raise ValueError(f"slice_assign: expected contiguous (num_cells, key_width) int32 table keys, got {tuple(keys.shape)} {keys.dtype}")
    if occupied.shape != keys.shape[:1] or occupied.dtype != torch.bool or not occupied.is_contiguous():
        raise ValueError(f"slice_assign: expected a contiguous ({keys.shape[0]},) bool occupancy, got {tuple(occupied.shape)} {occupied.dtype}")
    if spills.shape != () or spills.dtype != torch.int32:
        raise ValueError(f"slice_assign: expected a () int32 spill counter, got {tuple(spills.shape)} {spills.dtype}")
    if kmat.ndim != 2 or kmat.shape[1] != keys.shape[1] or kmat.dtype != torch.int32:
        raise ValueError(
            f"slice_assign: expected (B, {keys.shape[1]}) int32 cohort keys, got {tuple(kmat.shape)} {kmat.dtype}"
        )


def slice_assign_plain(
    keys: torch.Tensor, occupied: torch.Tensor, spills: torch.Tensor, kmat: torch.Tensor
) -> torch.Tensor:
    """The (B,) int32 cells of ``kmat``'s rows; see :func:`slice_assign`.

    JAX's ``_assign_cells`` step for step: the associative lookup of the
    resident keys, then its ``while_loop``'s rounds as a host loop (each
    round's claim a ``scatter_reduce(..., "amin")`` over the contending
    rows), then the spill count.
    """
    _check_args(keys, occupied, spills, kmat)
    n, batch = keys.shape[0], kmat.shape[0]
    rows = torch.arange(batch, dtype=torch.int64, device=kmat.device)
    h0 = hash_rows(kmat) % n
    resident = (keys[None, :, :] == kmat[:, None, :]).all(-1) & occupied[None, :]
    cells = torch.where(resident.any(1), resident.to(torch.int8).argmax(1), -1)
    j = 0
    while j < n and bool((cells < 0).any()):
        slot = (h0 + j) % n
        match = occupied[slot] & (keys[slot] == kmat).all(1)
        cells = torch.where((cells < 0) & match, slot, cells)
        cand = (cells < 0) & ~occupied[slot]
        winner = torch.full((n + 1,), batch, dtype=torch.int64, device=kmat.device)
        winner = winner.scatter_reduce(0, torch.where(cand, slot, n), rows, reduce="amin")
        is_winner = cand & (winner[slot] == rows)
        keys[slot[is_winner]] = kmat[is_winner]
        occupied[slot[is_winner]] = True
        match2 = occupied[slot] & (keys[slot] == kmat).all(1)
        cells = torch.where(cand & match2, slot, cells)
        j += 1
    spills.add_((cells < 0).sum().to(torch.int32))
    return cells.to(torch.int32)


def slice_assign(keys: torch.Tensor, occupied: torch.Tensor, spills: torch.Tensor, kmat: torch.Tensor) -> torch.Tensor:
    """Place each row of ``kmat`` (B, key_width) int32 in the slice table and
    return its (B,) int32 cell, ``-1`` for a row that spilled.

    The table (``keys`` (num_cells, key_width) int32, ``occupied``
    (num_cells,) bool, ``spills`` () int32) is updated in place: new cohorts
    are inserted, and the rows that found no cell after a full sweep are
    added to ``spills``. CUDA tensors go through the hand kernel; CPU tensors
    through :func:`slice_assign_plain`.
    """
    tensors = (keys, occupied, spills, kmat)
    if all(t.device.type == "cpu" for t in tensors):
        return slice_assign_plain(keys, occupied, spills, kmat)
    if keys.device.type != "cuda" or any(t.device != keys.device for t in tensors):
        raise ValueError(f"slice_assign: tensors on {[str(t.device) for t in tensors]}; expected one CUDA device")
    _check_args(keys, occupied, spills, kmat)
    kmat = kmat.contiguous()
    n, batch = keys.shape[0], kmat.shape[0]
    cells = torch.empty((batch,), dtype=torch.int32, device=keys.device)
    if batch == 0:  # nothing to place: no launch, and none is counted
        return cells
    scratch = torch.zeros((batch + 1 + (n if n > _MAX_SMEM_CLAIMS else 0),), dtype=torch.int32, device=keys.device)
    fn = _build.function("slice_assign", _ARGTYPES)
    with torch.cuda.device(keys.device):
        status = fn(
            kmat.data_ptr(),
            kmat.shape[1],
            batch,
            keys.data_ptr(),
            occupied.data_ptr(),
            n,
            spills.data_ptr(),
            cells.data_ptr(),
            scratch.data_ptr(),
            torch.cuda.current_stream(keys.device).cuda_stream,
        )
    _build.check(status, "slice_assign")
    slice_assign.launches += 1
    return cells


slice_assign.launches = 0  # launches of the CUDA kernel (the plain version is not counted)
