# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Fixed-capacity append buffers: list ("cat") states inside a captured step
(counterpart of ``torchmetrics_tpu/parallel/cat_buffer.py``).

A list of per-batch tensors cannot live in a CUDA graph, which replays
fixed addresses and shapes. The fused plan gives each list state a
capacity-bounded buffer instead::

    CatBuffer(data=(capacity, *elem), count=int32, overflowed=bool)

``count`` and ``overflowed`` are 0-d tensors on the buffer's device, so an
append computes its offset on the device and never reads it back to the
host.

PyTorch has no scatter that drops out-of-range indices (JAX's
``mode="drop"``): ``index_copy_`` past the end is a device-side assert, and
clamping to the last row would let a dropped row race a valid one there.
So every buffer made here keeps one private spare row after its capacity
(storage of ``capacity + 1`` rows, ``data`` the first ``capacity``), and a
row that does not fit is written to the spare, which nothing reads. The
rows kept, ``count`` and ``overflowed`` are JAX's bit for bit.

The public functions are pure, as in JAX: they copy the buffer and update
the copy in place with :func:`_append_` or :func:`_merge_`. The fused plan
appends to its own buffers in place, its counterpart of a donated carry.
:func:`cat_buffer_all_gather` merges every rank's buffer over a
``torch.distributed`` group (the sharded fused plan's cat members).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor

__all__ = [
    "CatBuffer",
    "cat_buffer_all_gather",
    "cat_buffer_append",
    "cat_buffer_init",
    "cat_buffer_merge",
    "cat_buffer_values",
    "infer_cat_layout",
]


class CatBuffer(NamedTuple):
    """A fixed-capacity append buffer: three tensors on one device."""

    data: Tensor  # (capacity, *elem); a spare row lies after it in storage
    count: Tensor  # int32 scalar: valid rows
    overflowed: Tensor  # bool scalar: an append ran past capacity


def _storage(buf: CatBuffer) -> Tensor:
    """The ``(capacity + 1, *elem)`` storage under ``buf.data``, its spare row last."""
    data = buf.data
    row = math.prod(data.shape[1:])
    need = (data.storage_offset() + (data.shape[0] + 1) * row) * data.element_size()
    if not data.is_contiguous() or data.untyped_storage().nbytes() < need:
        raise ValueError("CatBuffer data has no spare row: make buffers with cat_buffer_init")
    return data.as_strided((data.shape[0] + 1, *data.shape[1:]), data.stride(), data.storage_offset())


def _copy(buf: CatBuffer) -> CatBuffer:
    """A buffer of its own with ``buf``'s contents, spare row included."""
    storage = _storage(buf).clone()
    return CatBuffer(storage[: buf.data.shape[0]], buf.count.clone(), buf.overflowed.clone())


def cat_buffer_init(
    capacity: int, elem_shape: Sequence[int] = (), dtype: torch.dtype = torch.float32, device: Any = "cpu"
) -> CatBuffer:
    """An empty buffer holding up to ``capacity`` rows of shape ``elem_shape`` on ``device``."""
    storage = torch.zeros((capacity + 1, *elem_shape), dtype=dtype, device=device)
    return CatBuffer(
        data=storage[:capacity],
        count=torch.zeros((), dtype=torch.int32, device=storage.device),
        overflowed=torch.zeros((), dtype=torch.bool, device=storage.device),
    )


def _as_rows(buf: CatBuffer, rows: Any) -> Tensor:
    rows = torch.as_tensor(rows, device=buf.data.device)
    if rows.ndim == buf.data.ndim - 1:  # single row convenience
        rows = rows[None]
    return rows.to(buf.data.dtype)


def _append_(buf: CatBuffer, rows: Tensor) -> None:
    """Append ``rows`` to ``buf`` in place (rows past capacity go to the spare row)."""
    cap, n = buf.data.shape[0], rows.shape[0]
    idx = buf.count.to(torch.int64) + torch.arange(n, device=rows.device)
    _storage(buf).index_copy_(0, torch.clamp(idx, max=cap), rows)
    new_total = buf.count + n
    buf.overflowed.logical_or_(new_total > cap)
    buf.count.copy_(torch.clamp(new_total, max=cap))


def _merge_(a: CatBuffer, b: CatBuffer) -> None:
    """Splice ``b``'s valid rows after ``a``'s, in place in ``a``."""
    cap_a = a.data.shape[0]
    rb = torch.arange(b.data.shape[0], device=a.data.device)
    dest = a.count.to(torch.int64) + rb
    # invalid source rows, and rows past a's capacity, route to the spare row
    dest = torch.where((rb < b.count) & (dest < cap_a), dest, cap_a)
    _storage(a).index_copy_(0, dest, b.data.to(a.data.dtype))
    new_total = a.count + b.count
    a.overflowed.copy_(a.overflowed | b.overflowed | (new_total > cap_a))
    a.count.copy_(torch.clamp(new_total, max=cap_a))


def cat_buffer_append(buf: CatBuffer, rows: Any) -> CatBuffer:
    """``buf`` with ``rows`` (shape ``(B, *elem)``) appended at its current offset.

    Rows that would land past capacity are dropped and ``overflowed``
    latches: no earlier row is overwritten.
    """
    out = _copy(buf)
    _append_(out, _as_rows(buf, rows))
    return out


def cat_buffer_merge(a: CatBuffer, b: CatBuffer) -> CatBuffer:
    """Splice ``b``'s valid rows after ``a``'s (pairwise cat reduction)."""
    out = _copy(a)
    _merge_(out, b)
    return out


def cat_buffer_all_gather(buf: CatBuffer, axis_name: str = "data", *, mesh: Optional[Any] = None) -> CatBuffer:
    """Cross-rank merge: every rank's valid rows, in rank order, in one buffer.

    Every rank of ``mesh``'s dim ``axis_name`` (the default group with
    ``mesh=None``) calls it with its own buffer; each gets the same result,
    of capacity ``world * capacity``, with ``count`` summed and
    ``overflowed`` OR-ed (the JAX function runs inside ``shard_map`` over a
    mesh axis instead). Rank order makes it deterministic, so sort-based
    metrics see the same rows on every rank. The rows past the valid ones
    are zeros, as in JAX.
    """
    from torchmetrics_tpu_torch.parallel.sharded import _axis_group
    from torchmetrics_tpu_torch.utilities.distributed import gather_all_tensors

    group = _axis_group(mesh, axis_name)
    datas = gather_all_tensors(buf.data, group=group)
    meta = torch.stack([buf.count.to(torch.int32), buf.overflowed.to(torch.int32)])
    metas = torch.stack(gather_all_tensors(meta, group=group))
    counts = metas[:, 0]
    offsets = torch.cumsum(counts, 0) - counts  # exclusive prefix sum
    capacity = sum(d.shape[0] for d in datas)
    out = cat_buffer_init(capacity, tuple(buf.data.shape[1:]), buf.data.dtype, buf.data.device)
    storage = _storage(out)
    for rank, data in enumerate(datas):
        rows = torch.arange(data.shape[0], device=data.device)
        # invalid rows route to the spare row, which nothing reads
        dest = torch.where(rows < counts[rank], offsets[rank] + rows, capacity)
        storage.index_copy_(0, dest, data)
    out.count.copy_(counts.sum())
    out.overflowed.copy_(metas[:, 1].any())
    return out


def cat_buffer_values(buf: CatBuffer) -> Tensor:
    """The valid rows (reads the count on the host). Raises if the buffer ever overflowed."""
    if bool(buf.overflowed):
        raise RuntimeError(
            f"CatBuffer overflowed its capacity of {buf.data.shape[0]} rows; rows were dropped."
            " Re-run with a larger capacity, or fall back to host (list-state) accumulation."
        )
    return buf.data[: int(buf.count)]


def infer_cat_layout(metric: Any, example_batch: Tuple[Any, ...]) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Per-list-state ``(elem_shape, dtype)`` of what ``metric``'s update appends.

    JAX learns it under ``jax.eval_shape``; PyTorch has no abstract
    evaluation, so the update runs once on the example batch, from a reset
    state, and the metric's state, count and cached value are restored after.
    """
    with metric._scratch():
        metric.reset()
        metric.update(*example_batch)
        appended_by_key = {k: [torch.atleast_1d(x) for x in v] for k, v in metric.state_tree().items() if isinstance(v, list)}
    layout = {}
    for key, appended in appended_by_key.items():
        if not appended:
            raise ValueError(f"list state {key!r} received no append for the example batch")
        elem = tuple(appended[0].shape[1:])
        if any(tuple(a.shape[1:]) != elem or a.dtype != appended[0].dtype for a in appended):
            raise ValueError(f"list state {key!r} appends inconsistent shapes/dtypes per update")
        layout[key] = (elem, appended[0].dtype)
    return layout

