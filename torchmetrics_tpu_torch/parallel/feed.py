# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Async double-buffered host→device batch feed (counterpart of
``torchmetrics_tpu/parallel/feed.py``).

A streaming evaluation that updates on host-resident batches serializes
producing batch k+1, its host→device copy and the update on batch k.
:class:`DeviceFeed` overlaps them with a background staging thread and a
depth-bounded queue (double buffering at ``depth=2``, the default)::

    plan = suite.fused()
    for batch in DeviceFeed(batches):      # producer + copy overlap step k
        plan.update(*batch)

For a CUDA target the staging thread copies each host tensor (numpy arrays
become tensors first) into pinned memory and issues a ``non_blocking`` copy
on a side CUDA stream, into a device tensor allocated on that side stream,
and waits for the copies on the host before it queues the batch: a batch
handed out is already on the card, and the producer may reuse its host
buffers. The consumer marks each staged tensor with ``record_stream`` for
its own stream, so the caching allocator hands the block back to the side
stream only after the consumer's queued work on it has run. One side stream
per device serves every feed, so its allocator pool is reused from feed to
feed. Tensors already on the target device pass through.
Tuples, lists and dicts of arrays are staged leaf by leaf. ``depth`` bounds
device memory: at most ``depth`` staged batches sit in the queue (plus the
one being staged).

**Failure contract.** A producer exception (the batch iterable raising, or
the staging itself failing) is captured by the staging thread and re-raised
to the consumer on its next iteration step, at the position where the batch
would have appeared. Abandoning the iterator early (``break``) stops the
producer thread promptly: it never blocks forever on a full queue. The
``feed.stage`` fault point (``robustness/faults.py``) fires on the staging
thread before each batch is staged, to rehearse exactly that.
"""
from __future__ import annotations

import queue
import threading
from contextlib import nullcontext
from typing import Any, Dict, Iterable, Iterator, Optional, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.robustness import faults

__all__ = ["DeviceFeed"]

_DONE = object()  # producer sentinel: the batch iterable is exhausted


class _ProducerError:
    """Envelope for an exception captured on the staging thread, re-raised
    on the consumer at the position where the failed batch would have
    appeared."""

    __slots__ = ("error",)

    def __init__(self, error: BaseException) -> None:
        self.error = error


def _target_device(device: Union[str, torch.device, None]) -> torch.device:
    """The device batches land on, resolved on the caller's thread: PyTorch's
    current CUDA device is per thread, and the staging thread would otherwise
    see its own."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("DeviceFeed was asked to stage on CUDA, but no CUDA device is available; pass device='cpu'")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


_SIDE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    """The device's staging stream, made once: the caching allocator keeps its
    blocks per stream, so a stream that lives on lets every feed reuse them."""
    if device.index not in _SIDE_STREAMS:
        _SIDE_STREAMS[device.index] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device.index]


def _leaves(tree: Any) -> Iterator[Any]:
    if isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _leaves(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _leaves(x)
    else:
        yield tree


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, tuple):
        return tuple(_map(fn, x) for x in tree)
    if isinstance(tree, list):
        return [_map(fn, x) for x in tree]
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


class DeviceFeed:
    """Iterate ``batches`` with a background thread staging up to ``depth``
    device copies ahead of the consumer.

    Args:
        batches: any iterable of batches (tensors, numpy arrays, or tuples,
            lists or dicts of them: ``(preds, target)`` in the common case).
            Consumed on the staging thread: its ``__next__`` must not
            require the consumer's thread.
        device: target device; ``None`` is the current CUDA device of the
            thread that starts the iteration, and raises without a card.
            ``"cpu"`` stages host tensors (numpy arrays copied into tensors).
        depth: how many staged batches to keep queued ahead of the consumer
            (``2`` = double buffering; ``1`` = one batch ahead).
    """

    def __init__(self, batches: Iterable[Any], device: Optional[Union[str, torch.device]] = None, depth: int = 2) -> None:
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._batches = batches
        self._device = device
        self._depth = depth

    @staticmethod
    def _stage(batch: Any, device: torch.device, stream: Optional["torch.cuda.Stream"]) -> Any:
        """The batch with every host leaf copied to ``device``.

        On CUDA the staged tensors are allocated and written on ``stream``,
        and the copies are waited for on the host, so a producer may reuse
        its host buffers (pinned ones too) as soon as the next batch is asked for.
        """
        if faults._ACTIVE:  # staging-fault drill: a poisoned batch or transfer
            faults.fire("feed.stage")

        def leaf(x: Any) -> Any:
            if isinstance(x, (np.ndarray, np.generic)):
                arr = np.asarray(x)
                # on the CPU the batch gets its own copy, never the caller's array
                x = torch.from_numpy(arr.copy() if stream is None or not arr.flags.writeable else arr)
            if not isinstance(x, torch.Tensor) or x.device == device:
                return x
            if stream is None or x.device.type != "cpu":
                return x.to(device)
            return x.pin_memory().to(device, non_blocking=True)

        if stream is None:
            return _map(leaf, batch)
        with torch.cuda.stream(stream):
            staged = _map(leaf, batch)
        stream.synchronize()
        return staged

    def __iter__(self) -> Iterator[Any]:
        device = _target_device(self._device)
        stream = _side_stream(device) if device.type == "cuda" else None
        staged: queue.Queue = queue.Queue(maxsize=self._depth)
        stop = threading.Event()

        def put_until_stopped(item: Any) -> bool:
            """Blocking put that yields to the stop flag (an abandoned
            consumer must never leave the producer wedged on a full queue);
            True when the item landed."""
            while not stop.is_set():
                try:
                    staged.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce() -> None:
            payload: Any = _DONE
            try:
                with torch.cuda.device(device) if stream is not None else nullcontext():
                    for batch in self._batches:
                        if not put_until_stopped(self._stage(batch, device, stream)):
                            return
            except BaseException as err:  # noqa: BLE001 - surfaced to the consumer
                payload = _ProducerError(err)
            # terminal marker (end of stream or the captured error): the
            # consumer is guaranteed to unblock on its next get()
            put_until_stopped(payload)

        worker = threading.Thread(target=produce, daemon=True, name="tm-tpu-device-feed")
        worker.start()
        try:
            while True:
                item = staged.get()
                if item is _DONE:
                    return
                if isinstance(item, _ProducerError):
                    raise item.error
                if stream is not None:
                    # staged on the side stream, read on the consumer's: the
                    # allocator must not reuse a block before that read has run
                    consumer = torch.cuda.current_stream(device)
                    for x in _leaves(item):
                        if isinstance(x, torch.Tensor) and x.device == device:
                            x.record_stream(consumer)
                yield item
        finally:
            stop.set()  # consumer done/abandoned: unblock a put-blocked producer
