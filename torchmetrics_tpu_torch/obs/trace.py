# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""In-process tracing: nestable spans into a bounded ring buffer.

The runtime's hot layers (``Metric.update``/``compute``/``forward``/``sync``,
the sharded jit-build/dispatch path, ``MetricCollection`` group updates,
checkpoint save/load) are instrumented with spans from this module. Tracing is
**opt-in** — ``TM_TPU_TRACE=1`` in the environment or the :func:`tracing`
context manager — and the disabled path at every instrumentation point is a
single module-level flag check (``if trace.ENABLED:``): no string formatting,
no dict/object allocation, no function call. The default hot path is
unchanged.

When enabled, each span records ``(name, start, duration, thread, depth,
args)`` with the monotonic clock (``time.perf_counter_ns`` — wall-clock jumps
cannot produce negative durations) into a bounded ring buffer
(``TM_TPU_TRACE_BUFFER`` events, default 65536; oldest events drop first and
the drop count is kept). Spans nest: per-thread depth tracking means a
``forward`` span contains its ``update``/``compute``/``reset`` children, and
the daemon worker thread of a bounded sync records under its own thread id.

Export as JSON-lines or Chrome ``chrome://tracing`` format via
:mod:`torchmetrics_tpu_torch.obs.export`; render with ``tools/metricscope.py``.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

from . import counters as _counters

#: THE flag every instrumentation point checks. Module-level so the disabled
#: hot path is one global load + truth test; flip only via enable()/disable()
#: (or the tracing() context manager) so buffer state stays consistent.
ENABLED: bool = os.environ.get("TM_TPU_TRACE", "0") == "1"

_DEFAULT_CAPACITY = 65536


def _env_capacity() -> int:
    try:
        return max(1, int(os.environ.get("TM_TPU_TRACE_BUFFER", str(_DEFAULT_CAPACITY))))
    except ValueError:
        return _DEFAULT_CAPACITY


_lock = threading.Lock()
_events: deque = deque(maxlen=_env_capacity())
_dropped = 0
_high_water = 0
_tls = threading.local()


def enable() -> None:
    """Turn tracing on (spans start recording at the next flag check)."""
    global ENABLED
    ENABLED = True


def disable() -> None:
    """Turn tracing off; the recorded buffer is kept until :func:`clear`."""
    global ENABLED
    ENABLED = False


def is_enabled() -> bool:
    return ENABLED


def configure(capacity: int) -> None:
    """Resize the ring buffer (keeps the newest events that fit)."""
    global _events, _dropped
    if capacity < 1:
        raise ValueError(f"trace buffer capacity must be >= 1, got {capacity}")
    with _lock:
        kept = list(_events)[-capacity:]
        _dropped += len(_events) - len(kept)
        _events = deque(kept, maxlen=capacity)


def clear() -> None:
    """Drop all recorded events, the drop counter and the high-water mark."""
    global _dropped, _high_water
    with _lock:
        _events.clear()
        _dropped = 0
        _high_water = 0


def get_trace() -> List[Dict[str, Any]]:
    """Stable snapshot of the recorded events, oldest first."""
    with _lock:
        return list(_events)


def dropped_events() -> int:
    """How many events the bounded buffer has discarded (oldest-first)."""
    with _lock:
        return _dropped


def high_water() -> int:
    """The most events the ring buffer has held since the last :func:`clear`.

    ``high_water() == capacity`` means the buffer filled at least once — any
    further recording dropped oldest events; exporters surface it as the
    ``obs.trace.ring_high_water`` gauge so a trace file carries its own
    truncation evidence.
    """
    with _lock:
        return _high_water


def _record(event: Dict[str, Any]) -> None:
    global _dropped, _high_water
    with _lock:
        if len(_events) == _events.maxlen:
            _dropped += 1
        _events.append(event)
        if len(_events) > _high_water:
            _high_water = len(_events)


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class _Span:
    """Context manager for one span. Enter/exit on the same thread; records
    only if tracing was enabled at enter (a mid-span disable still records —
    the buffer is the source of truth, not the flag)."""

    __slots__ = ("name", "args", "_t0", "_depth", "_active")

    def __init__(self, name: str, args: Optional[Dict[str, Any]]) -> None:
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        self._active = ENABLED
        if self._active:
            stack = _stack()
            self._depth = len(stack)
            stack.append(self.name)
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc: Any) -> None:
        if self._active:
            t1 = time.perf_counter_ns()
            _stack().pop()
            _record(
                {
                    "type": "span",
                    "name": self.name,
                    "ts": self._t0,
                    "dur": t1 - self._t0,
                    "tid": threading.get_ident(),
                    "depth": self._depth,
                    "args": self.args,
                }
            )


def span(name: str, **args: Any) -> _Span:
    """A nestable timed span: ``with span("metric.update", metric="Accuracy"):``.

    ``args`` must be JSON-serializable scalars (they ride into the exported
    trace verbatim). Call sites on hot paths must guard with
    ``if trace.ENABLED:`` so the disabled path never reaches this call.
    """
    return _Span(name, args or None)


def instant(name: str, **args: Any) -> None:
    """Record a zero-duration point event (retry, degrade, evict...)."""
    if not ENABLED:
        return
    _record(
        {
            "type": "instant",
            "name": name,
            "ts": time.perf_counter_ns(),
            "dur": 0,
            "tid": threading.get_ident(),
            "depth": len(_stack()),
            "args": args or None,
        }
    )


@contextmanager
def tracing(clear_first: bool = True) -> Iterator[None]:
    """Enable tracing for a scope: ``with tracing(): ... trace.get_trace()``.

    By default clears the span buffer AND the counter registry on entry so the
    scope observes only its own activity; pass ``clear_first=False`` to append
    to an existing recording. On exit the flag returns to its previous value
    (recorded events are kept for export).
    """
    global ENABLED
    if clear_first:
        clear()
        _counters.clear()
    prev = ENABLED
    ENABLED = True
    try:
        yield
    finally:
        ENABLED = prev
