# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""K4 ``slice_assign``: one batch of cohort keys placed in the sliced plan's
slice table, and its plain version.

Counterpart of ``torchmetrics_tpu/parallel/sliced.py::_assign_cells`` (with
``::_hash_rows``). The kernel is ``csrc/slice_assign.cu``; its source note
gives the algorithm, the bound and the design. On CPU tensors
:func:`slice_assign` computes :func:`slice_assign_plain`; on CUDA tensors it
launches the kernel or raises. Both update the table in place.
:func:`slice_assign_reps_plain` takes the kernel's route on the host (one
representative per new key), for the tests to hold against both.

**Hashing in int64.** Torch's ``uint32`` has no shifts or remainder on the
CPU, so the plain version mixes the keys in int64 tensors holding values in
``[0, 2**32)`` with the HyperLogLog sketch's 32-bit helpers.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

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
    ctypes.c_void_p,  # ctrl (kept with the table)
    ctypes.c_void_p,  # hash (kept with the table)
    ctypes.c_longlong,  # hash slots
    ctypes.c_void_p,  # scratch
    ctypes.c_void_p,  # stream
]
_CTRL_WORDS = 8
# (device index, table keys' address) -> (ctrl, hash): the kernel's control
# words and key hash, zeroed once and left ready by every call. Never freed:
# a captured CUDA graph may hold their addresses.
_KEPT: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
_LAST_CTRL: Dict[Tuple[int, int], torch.Tensor] = {}  # the control words of each table's last call


def _hash_slots(batch: int) -> int:
    """The key hash's size for a batch: a power of two, at least twice the rows."""
    return 1 << max(1, (2 * batch - 1).bit_length())


def _kept_buffers(keys: torch.Tensor, batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The control words and key hash kept with this table, made at its first
    call outside a capture; inside one, or for a batch larger than the kept
    hash holds, a zeroed pair for this call alone (two memsets)."""
    slots = _hash_slots(batch)
    key = (keys.device.index, keys.data_ptr())
    kept = _KEPT.get(key)
    if kept is None or kept[1].numel() < slots:
        fresh = (torch.zeros(_CTRL_WORDS, dtype=torch.int32, device=keys.device), torch.zeros(slots, dtype=torch.int64, device=keys.device))
        if kept is None and not torch.cuda.is_current_stream_capturing():
            _KEPT[key] = fresh
        kept = fresh
    _LAST_CTRL[key] = kept[0]
    return kept


def slice_assign_stats(keys: torch.Tensor) -> Dict[str, int]:
    """The representatives (distinct new keys) and the rounds of this
    table's last call, as the kernel left them (0 and 0 where every key was
    resident; a host read)."""
    ctrl = _LAST_CTRL[(keys.device.index, keys.data_ptr())].tolist()
    return {"new_keys": ctrl[2], "rounds": ctrl[3]}


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


def slice_assign_reps_plain(
    keys: torch.Tensor, occupied: torch.Tensor, spills: torch.Tensor, kmat: torch.Tensor, stats: Optional[Dict[str, int]] = None
) -> torch.Tensor:
    """The kernel's route on the host, for the tests: what
    :func:`slice_assign_plain` computes, by another way.

    The resident lookup, then the rounds over one representative per
    distinct unresolved key (its lowest row) without JAX's third step, and
    only while a slot is empty; each representative's cell goes to every row
    of its key (``csrc/slice_assign.cu`` argues why that is JAX's result).
    ``stats``, if given, receives the representatives (``new_keys``) and the
    rounds run, as the kernel counts them.
    """
    _check_args(keys, occupied, spills, kmat)
    n, batch = keys.shape[0], kmat.shape[0]
    resident = (keys[None, :, :] == kmat[:, None, :]).all(-1) & occupied[None, :]
    cells = torch.where(resident.any(1), resident.to(torch.int8).argmax(1), -1)
    rows = torch.nonzero(cells < 0).reshape(-1)
    uniq, inverse = torch.unique(kmat[rows], dim=0, return_inverse=True)
    reps = torch.full((uniq.shape[0],), batch, dtype=torch.int64, device=kmat.device).scatter_reduce(0, inverse, rows, "amin")
    h0 = hash_rows(kmat[reps]) % n
    rep_cells = torch.full((reps.numel(),), -1, dtype=torch.int64, device=kmat.device)
    j = 0
    while reps.numel() and j < n and bool((~occupied).any()):
        slot = (h0 + j) % n
        match = occupied[slot] & (keys[slot] == kmat[reps]).all(1)
        rep_cells = torch.where((rep_cells < 0) & match, slot, rep_cells)
        cand = (rep_cells < 0) & ~occupied[slot]
        winner = torch.full((n + 1,), batch, dtype=torch.int64, device=kmat.device)
        winner = winner.scatter_reduce(0, torch.where(cand, slot, n), reps, reduce="amin")
        is_winner = cand & (winner[slot] == reps)
        keys[slot[is_winner]] = kmat[reps[is_winner]]
        occupied[slot[is_winner]] = True
        rep_cells = torch.where(is_winner, slot, rep_cells)
        j += 1
        if not bool((rep_cells < 0).any()):
            break
    cells[rows] = rep_cells[inverse]
    spills.add_((cells < 0).sum().to(torch.int32))
    if stats is not None:
        stats.update(new_keys=int(reps.numel()), rounds=j)
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
    ctrl, hashed = _kept_buffers(keys, batch)
    scratch = torch.empty((batch + hashed.numel() + 5 * batch + n,), dtype=torch.int32, device=keys.device)
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
            ctrl.data_ptr(),
            hashed.data_ptr(),
            hashed.numel(),
            scratch.data_ptr(),
            torch.cuda.current_stream(keys.device).cuda_stream,
        )
    _build.check(status, "slice_assign")
    slice_assign.launches += 1
    return cells


slice_assign.launches = 0  # launches of the CUDA kernel (the plain version is not counted)
