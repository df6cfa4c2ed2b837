# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Named monotonic counters and gauges for the observability layer.

Names follow the ``layer.component.event`` convention (ARCHITECTURE.md §10):

==================================  ==============================================
name                                incremented when
==================================  ==============================================
``sharded.cache.hit``               ``_SHARDED_FN_CACHE`` serves a compiled step
``sharded.cache.miss``              no cached step for the (metric, mesh, axis,
                                    fingerprint) key — a jit build follows
``sharded.cache.invalidated``       an entry existed but its weakrefs went stale
                                    (id reuse after gc) — rebuilt
``sharded.cache.evict``             a superseded-fingerprint entry is deleted
``metric.sync.attempt``             a ``Metric.sync()`` attempt starts
``metric.sync.rollback``            a failed attempt rolled states back
``metric.sync.degrade``             sync exhausted attempts and fell back to
                                    local-only state (``on_error="local"``)
``metric.sync.failure``             sync exhausted attempts and raised
``collection.update.dedup_skipped`` a compute-group member skipped its update
                                    (the group leader updated for it)
``checkpoint.save`` / ``.load``     a checkpoint was saved / restored
``sketch.merge`` (+ ``.<Class>``)   a host-side pairwise sketch-state merge ran
                                    (cross-rank "merge" sync, forward fold);
                                    traced merges are excluded, not undercounted
``robustness.store.save``/``.load`` a ``CheckpointStore`` snapshot was persisted /
                                    a ``latest()`` recovery walk ran (the
                                    ``robustness.store.snapshot_bytes`` gauge
                                    tracks the newest snapshot's on-disk size)
``robustness.store.recovery_skipped``  ``latest()`` skipped a torn/corrupt/invalid
                                    snapshot and fell back to an older one
``runner.snapshot``                 a ``StreamingEvaluator`` snapshot was written
``runner.resume``                   a ``StreamingEvaluator.resume()`` restored (or
                                    started fresh from an empty store)
``runner.watchdog_stall``           an update/compute outlived the watchdog
                                    deadline and raised ``StallError``
``xla.compile``                     an AOT compile capture ran (cold compiled
                                    step under tracing; the ``xla.compile.last_ms``
                                    gauge keeps the newest compile wall time)
``device.telemetry.drain``          a pending in-graph telemetry state was
                                    materialized into ``device.<Metric>.*`` gauges
                                    at a compute/sync boundary
``obs.trace.ring_high_water``       (gauge) most events the span ring buffer has
                                    held — set by every live ``write_jsonl`` so a
                                    trace file carries its own truncation evidence
``metric.<Class>.state_bytes``      (gauge) bytes held by the class's registered
                                    states, refreshed at every attribution
                                    boundary (compute/sync/runner snapshot) —
                                    the state-memory column of the cost ledger
                                    and ``metricscope watch``
``metric.<Class>.sync_bytes``       (gauge) bytes this rank contributed to the
                                    last cross-process state gather for the class
``metric.state_bytes_total``        (gauge) whole-process state footprint with
                                    compute-group-shared arrays counted ONCE —
                                    the ``metricscope watch`` state_bytes column
``obs.costs.emit_errors``           a configured ``costs.json`` emission failed
                                    (I/O error; attribution never raises into
                                    the evaluation it observes)
``serve.dropped_batches``           a metricserve stream acked batches it will
                                    never apply (worker death or ``delete``
                                    latched them) — admission control delays
                                    instead of dropping, so the
                                    ``serve_sustained_streams`` bench leg holds
                                    this at zero
``serve.costs_errors``              a per-stream drain-time ``costs.json``
                                    emission failed (I/O; a drain never fails
                                    over its own attribution)
``serve.worker_crashes``            a stream's worker thread died (any cause);
                                    the supervisor decides restart vs park
``serve.worker_restarts``           the supervisor restarted a crashed worker
                                    (backoff + snapshot-restore + retained-
                                    buffer replay — exactly-once preserved)
``serve.circuit_open``              a stream exhausted its restart budget and
                                    parked with the circuit breaker open
                                    (``ctl revive`` half-opens it)
``serve.deadletter``                a poison batch (``poison_threshold``
                                    consecutive crashes on the same seq) was
                                    quarantined to ``deadletter.jsonl``
``store.write_failures``            a snapshot or dead-letter write hit
                                    ENOSPC/EIO; after the retries the stream
                                    degrades to in-memory-only until the
                                    recovery probe lands a write
==================================  ==============================================

The names are the JAX package's, so traces of both packages read alike. In
the port ``xla.compile`` counts a CUDA graph capture (see
:mod:`~torchmetrics_tpu_torch.obs.xla`), and the ``sharded.cache.*``
counters never fire: the port has no compiled-step cache.

Increment sites sit behind the same ``trace.ENABLED`` flag as spans, so the
disabled path allocates nothing. The module itself is dependency-free (neither
torch nor jax) and thread-safe.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Union

_lock = threading.Lock()
_counters: Dict[str, int] = {}
_gauges: Dict[str, float] = {}
_gauge_ts: Dict[str, int] = {}  # name -> monotonic ns of the last set_gauge


def inc(name: str, n: int = 1) -> None:
    """Add ``n`` (default 1) to the monotonic counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def set_gauge(name: str, value: Union[int, float]) -> None:
    """Set the gauge ``name`` to its latest observed value."""
    with _lock:
        _gauges[name] = value
        _gauge_ts[name] = time.monotonic_ns()


def get(name: str) -> int:
    """Current value of counter ``name`` (0 if never incremented)."""
    with _lock:
        return _counters.get(name, 0)


def snapshot(include_ts: bool = False) -> Dict[str, Dict[str, Union[int, float]]]:
    """Stable point-in-time copy: ``{"counters": {...}, "gauges": {...}}``,
    keys sorted so repeated snapshots of the same state compare equal.

    ``include_ts=True`` adds a third key ``"gauge_ts_mono_ns"`` mapping each
    gauge to the ``time.monotonic_ns()`` instant of its last ``set_gauge``
    call, so exporters (OpenMetrics, ``metricscope watch``) can flag a gauge
    that stopped updating instead of rendering its dead value as live. The
    default two-key shape is unchanged — existing consumers compare
    snapshots structurally.
    """
    with _lock:
        snap: Dict[str, Dict[str, Union[int, float]]] = {
            "counters": {k: _counters[k] for k in sorted(_counters)},
            "gauges": {k: _gauges[k] for k in sorted(_gauges)},
        }
        if include_ts:
            snap["gauge_ts_mono_ns"] = {k: _gauge_ts[k] for k in sorted(_gauge_ts)}
        return snap


def clear() -> None:
    """Reset every counter and gauge (and the gauge timestamps)."""
    with _lock:
        _counters.clear()
        _gauges.clear()
        _gauge_ts.clear()
