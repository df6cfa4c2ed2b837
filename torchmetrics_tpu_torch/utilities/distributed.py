# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Cross-process synchronization primitives on ``torch.distributed``
(counterpart of ``torchmetrics_tpu/utilities/distributed.py``).

Each process holds a local replica of a metric's states; ``Metric.sync()``
gathers them with the collectives of the process group it is given (the
default group unless a ``process_group`` is set). The collectives run on
the tensor's own device with the group's backend: NCCL for CUDA tensors
across cards, gloo on the CPU (gloo also carries CUDA tensors, staging them
through the host itself, which is how two ranks share one card). A
collective the backend refuses raises :class:`SyncError` naming the op and
the backend; nothing is moved to another device behind the caller's back.

:func:`gather_all_tensors` keeps the JAX function's protocol for uneven
shapes: gather every rank's ``ndim``, then the shapes into a buffer sized
from the largest ``ndim``, then either one ``all_gather`` (all shapes equal)
or pad to the per-dim maximum, gather and trim. :func:`gather_all_objects`
sends pickled bytes behind a length + CRC32 header, so a corrupt or
truncated payload raises :class:`SyncError` naming its rank.
"""
from __future__ import annotations

import math
import pickle
import struct
import zlib
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from torchmetrics_tpu_torch.robustness import faults
from torchmetrics_tpu_torch.utilities.exceptions import SyncError


def reduce(x: torch.Tensor, reduction: Optional[str]) -> torch.Tensor:
    """Reduce a tensor by elementwise-mean/sum or identity."""
    if reduction == "elementwise_mean":
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    if reduction is None or reduction == "none":
        return x
    raise ValueError("Reduction parameter unknown.")


def class_reduce(num: torch.Tensor, denom: torch.Tensor, weights: torch.Tensor, class_reduction: str = "none") -> torch.Tensor:
    """Reduce per-class metric scores."""
    valid_reduction = ("micro", "macro", "weighted", "none", None)
    fraction = torch.sum(num) / torch.sum(denom) if class_reduction == "micro" else num / denom
    fraction = torch.where(torch.isnan(fraction), 0.0, fraction)
    if class_reduction == "micro":
        return fraction
    if class_reduction == "macro":
        return torch.mean(fraction)
    if class_reduction == "weighted":
        return torch.sum(fraction * (weights.to(torch.float32) / torch.sum(weights)))
    if class_reduction == "none" or class_reduction is None:
        return fraction
    raise ValueError(f"Reduction parameter {class_reduction} unknown. Choose between one of these: {valid_reduction}")


def distributed_available() -> bool:
    """True when ``torch.distributed`` is initialised with more than one rank."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def world_size(group: Optional[Any] = None) -> int:
    """Ranks in ``group`` (the default group when ``None``); 1 without an initialised group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return 1


def _collective(op: str, fn: Callable[[], Any], tensor: torch.Tensor, group: Optional[Any]) -> Any:
    """Run one collective; a backend's refusal becomes a :class:`SyncError`
    naming the op, the tensor's device and the backend."""
    try:
        return fn()
    except (RuntimeError, ValueError) as err:
        backend = dist.get_backend(group)
        raise SyncError(
            f"{op} of a {tensor.dtype} tensor on {tensor.device} failed on the {backend!r} backend: {err}"
        ) from err


#: dtypes no backend's collective takes, sent as the same bits in a dtype
#: of the same width: gloo (and NCCL through torch) has no uint32 collective
_WIRE_DTYPES = {torch.uint32: torch.int32}


def _all_gather(tensor: torch.Tensor, group: Optional[Any]) -> List[torch.Tensor]:
    """``dist.all_gather`` of equal-shaped tensors, rank-ordered (a 0-d
    tensor travels as one element; a ``uint32`` one as its int32 bits)."""
    flat = tensor.reshape(1) if tensor.ndim == 0 else tensor.contiguous()
    wire = _WIRE_DTYPES.get(flat.dtype)
    if wire is not None:
        flat = flat.view(wire)
    out = [torch.empty_like(flat) for _ in range(world_size(group))]
    _collective("all_gather", lambda: dist.all_gather(out, flat, group=group), flat, group)
    if wire is not None:
        out = [t.view(tensor.dtype) for t in out]
    return [t.reshape(()) for t in out] if tensor.ndim == 0 else out


def all_reduce_(tensor: torch.Tensor, op: Any, group: Optional[Any] = None) -> torch.Tensor:
    """``dist.all_reduce`` in place on ``tensor`` (which must be contiguous); returns it."""
    _collective(f"all_reduce({op})", lambda: dist.all_reduce(tensor, op=op, group=group), tensor, group)
    return tensor


#: dtype codes of the gather header (the position in this tuple)
_DTYPES = (
    torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.int32, torch.int64,
    torch.int16, torch.int8, torch.uint8, torch.bool, torch.complex64, torch.complex128, torch.uint32,
)


def gather_all_tensors(result: torch.Tensor, group: Optional[Any] = None) -> List[torch.Tensor]:
    """Gather a tensor from every rank of ``group``, supporting uneven dim sizes.

    Rank-ordered list of each rank's tensor, on ``result``'s device. With one
    rank (or no initialised group) returns ``[result]``. Shapes may differ in
    any dim and ``ndim`` may exceed 8: the shape buffer is sized from the
    largest ``ndim``, gathered first with each rank's dtype. Non-empty
    tensors must agree on dtype and ``ndim`` (else :class:`SyncError`); an
    empty one, such as the ``(0,)`` float32 tensor a rank without data
    contributes to a cat state, takes the dtype and trailing shape of the
    first non-empty rank's, so the ranks' buffers agree.
    """
    if world_size(group) <= 1:
        return [result]
    if faults._ACTIVE:
        faults.fire("gather_arrays.pre")
    device = result.device
    header = torch.tensor([result.ndim, _DTYPES.index(result.dtype)], dtype=torch.int64, device=device)
    headers = [h.tolist() for h in _all_gather(header, group)]
    shape_buf = torch.zeros((max(1, max(n for n, _ in headers)),), dtype=torch.int64, device=device)
    shape_buf[: result.ndim] = torch.tensor(result.shape, dtype=torch.int64)
    shapes = [tuple(s.tolist()[:n]) for s, (n, _) in zip(_all_gather(shape_buf, group), headers)]
    full = [r for r, shape in enumerate(shapes) if math.prod(shape) > 0] or [0]
    ref_ndim, ref_dtype = headers[full[0]]
    bad = [r for r in full if headers[r] != [ref_ndim, ref_dtype]]
    if bad:
        raise SyncError(
            f"gather: rank {bad[0]} holds a {_DTYPES[headers[bad[0]][1]]} tensor of {headers[bad[0]][0]} dims, rank"
            f" {full[0]} a {_DTYPES[ref_dtype]} tensor of {ref_ndim} dims"
        )
    trailing = shapes[full[0]][1:]
    for r, shape in enumerate(shapes):  # empty tensors take the reference's dtype and trailing shape
        if r not in full:
            shapes[r] = (0, *trailing) if ref_ndim else ()
    mine = shapes[dist.get_rank(group)]
    if result.numel() == 0 and (tuple(result.shape), result.dtype) != (mine, _DTYPES[ref_dtype]):
        result = torch.zeros(mine, dtype=_DTYPES[ref_dtype], device=device)
    if all(s == shapes[0] for s in shapes):
        return _all_gather(result, group)
    max_shape = tuple(max(s[d] for s in shapes) for d in range(ref_ndim))
    padded = torch.zeros(max_shape, dtype=result.dtype, device=device)
    padded[tuple(slice(0, d) for d in result.shape)] = result
    gathered = _all_gather(padded, group)
    return [g[tuple(slice(0, d) for d in shape)] for g, shape in zip(gathered, shapes)]


#: the JAX package's name for the same function
gather_all_arrays = gather_all_tensors


#: wire header of the object-gather protocol: u64 payload length + u32 CRC32.
#: The CRC turns a corrupt or truncated payload into a :class:`SyncError`
#: naming the offending rank instead of an opaque ``pickle.loads`` failure
#: (or, worse, silently wrong deserialized state).
_OBJ_HEADER = struct.Struct("<QI")


def gather_all_objects(obj: Any, group: Optional[Any] = None) -> List[Any]:
    """Gather arbitrary picklable objects from every rank of ``group``, rank-ordered.

    The analogue of ``dist.all_gather_object``, through the byte protocol of
    :func:`_gather_objects_via_bytes` so that the CRC check and the fault
    points apply. With one rank returns ``[obj]``.
    """
    if world_size(group) <= 1:
        return [obj]
    return _gather_objects_via_bytes(obj, group)


def _object_device(group: Optional[Any]) -> torch.device:
    """Where the byte buffers of the object gather live: NCCL moves CUDA
    tensors only, every other backend takes host tensors."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _gather_objects_via_bytes(obj: Any, group: Optional[Any] = None) -> List[Any]:
    if faults._ACTIVE:
        faults.fire("gather_bytes.pre")
    payload = pickle.dumps(obj)
    wire = _OBJ_HEADER.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload
    if faults._ACTIVE:
        wire = faults.mutate_bytes("gather_bytes.payload", wire, header_len=_OBJ_HEADER.size)
    device = _object_device(group)
    sizes = [int(s) for s in _all_gather(torch.tensor([len(wire)], dtype=torch.int64, device=device), group)]
    buf = torch.zeros((max(sizes),), dtype=torch.uint8, device=device)
    buf[: len(wire)] = torch.frombuffer(bytearray(wire), dtype=torch.uint8).to(device)
    gathered = _all_gather(buf, group)
    out: List[Any] = []
    for rank, (total, raw) in enumerate(zip(sizes, gathered)):
        if total < _OBJ_HEADER.size:
            raise SyncError(
                f"object gather: rank {rank} sent {total} byte(s), smaller than the {_OBJ_HEADER.size}-byte header —"
                " truncated payload"
            )
        data = raw[:total].cpu().numpy().tobytes()
        length, crc = _OBJ_HEADER.unpack(data[: _OBJ_HEADER.size])
        body = data[_OBJ_HEADER.size : _OBJ_HEADER.size + length]
        if len(body) != length:
            raise SyncError(
                f"object gather: rank {rank} declared {length} payload byte(s) but sent {total - _OBJ_HEADER.size} —"
                " truncated payload"
            )
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            raise SyncError(f"object gather: payload from rank {rank} failed its CRC32 integrity check — corrupt payload")
        try:
            out.append(pickle.loads(body))
        except Exception as err:
            raise SyncError(f"object gather: payload from rank {rank} passed CRC but failed to unpickle: {err}") from err
    return out
