# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""One durable, self-healing evaluation stream inside a ``metricserve`` daemon
(counterpart of ``torchmetrics_tpu/serve/stream.py``).

A :class:`Stream` is the service-side unit the daemon multiplexes: one named
(model-version × dataset) evaluation owning

- a declarative :class:`StreamSpec` (factory import path + evaluator knobs,
  the wire-facing description a ``create`` request carries),
- its own :class:`~torchmetrics_tpu_torch.robustness.store.CheckpointStore`
  sub-directory (restart = resume from the snapshot cursor, never recount),
- a bounded ingest queue (admission control — the **only** place a batch
  waits) feeding ONE worker thread that pumps the evaluator's open-loop
  serve API (:meth:`~torchmetrics_tpu_torch.robustness.runner.StreamingEvaluator.
  serve_step`), optionally through a
  :class:`~torchmetrics_tpu_torch.parallel.feed.DeviceFeed` so host decode and
  the host-to-device copy overlap device work exactly like a batch run.

**Exactly-once ingest.** Every batch carries a client sequence number. The
stream acks ``seq == next_seq`` (advancing), re-acks ``seq < next_seq``
(duplicate — idempotent replay), and rejects ``seq > next_seq`` with the
expected value (gap — the client rewinds). After a daemon crash ``next_seq``
restarts at the restored snapshot cursor, so the client replays exactly the
acked-but-unpersisted suffix and no sample is counted twice or dropped.

**Supervision.** A worker exception is no longer terminal. The supervisor
(the worker thread's own outer loop) rebuilds the evaluator from the spec,
restores from the newest valid snapshot, and replays the acked-but-unapplied
suffix from an in-memory **retained buffer** (pruned once a batch is covered
by two snapshots, capped at ``max(256, 4 × queue_max)``) — exactly-once
holds across in-process restarts with no client involvement. Restarts back
off exponentially with jitter and are budgeted by a **circuit breaker**:
more than ``max_restarts`` failures inside ``restart_window_s`` parks the
stream (state ``failed``, circuit ``open``, health ``stalled``); a manual
:meth:`revive` (``ctl revive``) half-opens the circuit for one probe
incarnation — the next failure re-opens it, the next successful apply
closes it.

**Poison-batch quarantine.** A batch that kills the worker
``poison_threshold`` times in a row is dead-lettered: its seq + wire payload
+ error + attempt count are appended to the stream's ``deadletter.jsonl``
(atomic temp+fsync+replace, the ``store_format`` discipline), the cursor
advances past it (:meth:`~torchmetrics_tpu_torch.robustness.runner.
StreamingEvaluator.serve_skip` — the skip still moves the durable
watermark), and the stream keeps serving. ``ctl deadletter list|requeue|
purge`` manages the quarantine; a requeued payload re-enters through the
normal exactly-once admission at the current watermark. The quarantine
survives daemon restarts (re-read from disk at stream construction).

**Disk-fault degradation.** ENOSPC/EIO on a snapshot or dead-letter write
retries briefly, then detaches the store and keeps serving **in-memory-only**
(health ``degraded``, ``store.write_failures`` counter); a recovery probe
re-attempts the write every ``_RECOVERY_PROBE_S`` and re-enables durability
the moment disk recovers.

**Control ops ride the batch queue.** flush/drain must serialize with the
batches already admitted, so ops travel the same queue. With a DeviceFeed in
front, an op enqueues a leafless ``()`` marker into the feed (an empty
tuple — the feed stages nothing and hands it through untouched) and parks the op itself on a FIFO
side-channel; the worker executes the op when the marker surfaces, which is
exactly its queue position. Each worker incarnation gets a FRESH queue and
side-channel: a superseded DeviceFeed staging thread (blocked in the old
source) notices the swap and winds down instead of stealing live batches.

**Dropped-batch accounting.** ``serve.dropped_batches`` counts batches the
daemon ACKED but will never apply — the suffix abandoned when a stream is
deleted or fails unrecoverably, plus purged dead-letter records. A parked
(circuit-open) stream does NOT latch its pending suffix: the retained buffer
still holds it and a revive applies it, so the counter stays zero on every
healable path.

**The device.** A stream runs on one device (``device``, default
``"cuda"``; without a card that raises, it never drops to the CPU). Its
factory builds the target there, its feed stages batches there, and its
worker thread enters that CUDA device before it opens the evaluator (a new
thread's current device is device 0), so a fused plan captures and allocates
on the stream's card. Batches decode to numpy exactly as the JAX package's
do; the cast to the metric's input dtypes happens at the metric's input, as
in the JAX package. A worker rebuilt after a crash first drops the dead
evaluator (its states and any fused plan's graphs and pool) and collects it,
so a crash loop does not grow device memory.
"""
from __future__ import annotations

import errno
import gc
import inspect
import json
import os
import queue
import random
import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import Any, Dict, List, Optional, Tuple

import torch

from torchmetrics_tpu_torch.obs import counters as _obs_counters
from torchmetrics_tpu_torch.robustness import faults
from torchmetrics_tpu_torch.robustness import store_format as _fmt
from torchmetrics_tpu_torch.robustness.store import CheckpointStore
from torchmetrics_tpu_torch.serve import wire
from torchmetrics_tpu_torch.utilities.data import resolve_device

__all__ = ["StreamSpec", "Stream", "decode_batch", "resolve_target"]

#: ``()`` is the op marker: real batches are always NON-empty tuples (or a
#: bare array), so an empty tuple is unambiguous — and leafless, so a
#: DeviceFeed hands it through as a no-op instead of choking on non-array leaves
_OP_MARKER: Tuple[()] = ()

_STATE_HEALTH = {
    "starting": 0,
    "serving": 0,
    "draining": 0,
    "drained": 0,
    "failed": 3,
}

#: numeric state codes for the ``serve.<name>.state`` gauge (gauges are
#: floats; scrapers map back through this table)
STATE_CODES = {"starting": 0, "serving": 1, "draining": 2, "drained": 3, "failed": 4}

#: numeric circuit codes for the ``serve.<name>.circuit_state`` gauge
CIRCUIT_CODES = {"closed": 0, "half_open": 1, "open": 2}

#: snapshot/dead-letter write retries before degrading to in-memory-only,
#: and the base of their exponential backoff
_DISK_RETRIES = 3
_DISK_RETRY_BASE_S = 0.01
#: cadence of the degraded stream's durability recovery probe
_RECOVERY_PROBE_S = 0.5


def _is_disk_error(err: BaseException) -> bool:
    """The resource-exhaustion class the degradation path absorbs."""
    return isinstance(err, OSError) and err.errno in (errno.ENOSPC, errno.EIO)


class _Unrecoverable(RuntimeError):
    """A worker failure supervision must NOT retry (exactly-once would break)."""


class _Halt(RuntimeError):
    """The stream was abandoned while the worker was down — exit quietly."""


#: the JAX package's import root, and the port's module of the same path
_JAX_ROOT, _PORT_ROOT = "torchmetrics_tpu", "torchmetrics_tpu_torch"


def _port_module(module_name: str) -> str:
    """A JAX package module path (``torchmetrics_tpu`` or anything under
    ``torchmetrics_tpu.``) as the port's module of the same path: a spec
    exported by a JAX leaf names JAX's factories, and the port folds or
    serves it with its own. The JAX package is never imported."""
    if module_name == _JAX_ROOT or module_name.startswith(_JAX_ROOT + "."):
        return _PORT_ROOT + module_name[len(_JAX_ROOT):]
    return module_name


def _takes_device(factory: Any) -> bool:
    try:
        params = inspect.signature(factory).parameters.values()
    except (TypeError, ValueError):
        return False
    return any(p.name == "device" or p.kind is inspect.Parameter.VAR_KEYWORD for p in params)


def resolve_target(path: str, kwargs: Optional[Dict[str, Any]] = None, device: Any = None) -> Any:
    """Build a stream's metric target from a ``module:callable`` factory
    path — the declarative form a wire ``create`` carries (a server cannot
    receive live Python objects). The factory returns a ``Metric``,
    ``MetricCollection`` or ``SlicedPlan``; see
    :mod:`torchmetrics_tpu_torch.serve.factories` for ready-made ones.

    A path under the JAX package (``torchmetrics_tpu.serve.factories:accuracy``)
    resolves to the port's module of the same path, so one spec serves and
    folds in either package. ``device`` is the owner's device (the stream's,
    daemon's or aggregator's); it is passed to a factory that takes a
    ``device`` keyword, and never rides ``kwargs``, which travel on the wire."""
    module_name, sep, attr = path.partition(":")
    if not sep or not module_name or not attr:
        raise ValueError(f"target must be 'module:callable', got {path!r}")
    import importlib

    factory = importlib.import_module(_port_module(module_name))
    for part in attr.split("."):
        factory = getattr(factory, part)
    kwargs = dict(kwargs or {})
    if device is not None and _takes_device(factory):
        kwargs["device"] = device
    return factory(**kwargs)


def decode_batch(batch: Any) -> Tuple[Any, ...]:
    """Wire batch (list of nested number lists, one per positional update
    argument) → tuple of arrays. One decode path for the daemon AND for
    parity tests replaying the same stream in-process, so a resumed service
    run compares bitwise against an uninterrupted one."""
    import numpy as np

    if not isinstance(batch, (list, tuple)) or not batch:
        raise wire.WireError("batch must be a non-empty JSON list (one entry per update argument)")
    return tuple(np.asarray(part) for part in batch)


def _batch_signature(decoded: Tuple[Any, ...]) -> Tuple[Tuple[Tuple[int, ...], str], ...]:
    """(trailing shape, dtype) per part — the aval the stream pins at its
    first accepted batch. The LEADING dim is the batch dim and may vary
    (clients split unevenly); everything else must match."""
    return tuple((tuple(part.shape[1:]), str(part.dtype)) for part in decoded)


class StreamSpec:
    """Declarative stream description — what a wire ``create`` carries.

    Args:
        name: registry key; one path component (no ``/``, no ``.`` — it names
            a store sub-directory and a ``serve.<name>.*`` gauge family).
        target: ``module:callable`` factory path for the metric target.
        kwargs: keyword arguments for the factory.
        fused: drive a ``MetricCollection`` target through the fused plane.
        fused_options: fused-plan build kwargs (``cat_capacity`` etc.; a
            fused collection with cat-state members NEEDS ``cat_capacity``
            so its carries get fixed-capacity buffers).
        window: ``WindowRing`` knobs (``slots`` + ``every_n``/``every_s``)
            wrapped around the target, or ``None``.
        snapshot_every_n / snapshot_every_s: evaluator snapshot cadence.
        queue_max: ingest queue bound (admission control), default 64.
        use_feed: stage batches through a ``DeviceFeed`` (default True).
        watchdog_timeout_s / on_stall: evaluator watchdog policy.
        max_restarts: circuit-breaker budget — more than this many worker
            failures inside ``restart_window_s`` parks the stream with the
            circuit ``open`` (``0`` = any failure parks immediately).
        restart_window_s: the sliding window the budget counts over.
        backoff_base_s / backoff_max_s: restart backoff — attempt ``n``
            sleeps ``min(max, base·2ⁿ⁻¹)`` plus the same again in jitter.
        poison_threshold: consecutive worker deaths on the SAME batch before
            it is dead-lettered and skipped (≥ 1).
        guard_ring: depth of the StateGuard known-good rollback ring (≥ 1) —
            how many verified post-batch states are retained in memory for
            an instant rollback when the poison probe trips. Only consulted
            when the target metric is guarded (``robustness/guard.py``).
        guard_recover_s: the sliding window guard rollbacks are counted over
            for health: one rollback inside the window reads stalling, two
            or more read degraded (floors ``/healthz`` at 503 until the
            window drains).
    """

    _FIELDS = (
        "name", "target", "kwargs", "fused", "fused_options", "window", "snapshot_every_n",
        "snapshot_every_s", "queue_max", "use_feed", "watchdog_timeout_s", "on_stall",
        "max_restarts", "restart_window_s", "backoff_base_s", "backoff_max_s", "poison_threshold",
        "guard_ring", "guard_recover_s",
    )

    def __init__(
        self,
        name: str,
        target: str,
        kwargs: Optional[Dict[str, Any]] = None,
        fused: bool = False,
        fused_options: Optional[Dict[str, Any]] = None,
        window: Optional[Dict[str, Any]] = None,
        snapshot_every_n: Optional[int] = None,
        snapshot_every_s: Optional[float] = None,
        queue_max: int = 64,
        use_feed: bool = True,
        watchdog_timeout_s: Optional[float] = None,
        on_stall: str = "raise",
        max_restarts: int = 5,
        restart_window_s: float = 60.0,
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 2.0,
        poison_threshold: int = 3,
        guard_ring: int = 4,
        guard_recover_s: float = 60.0,
    ) -> None:
        if not name or any(ch in name for ch in "/\\.") or name != name.strip():
            raise ValueError(
                f"stream name {name!r} must be one clean path component (it names a store"
                " sub-directory and a serve.<name>.* gauge family — no '/', '\\\\' or '.')"
            )
        if queue_max < 1:
            raise ValueError(f"queue_max must be >= 1, got {queue_max}")
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
        if restart_window_s <= 0:
            raise ValueError(f"restart_window_s must be > 0, got {restart_window_s}")
        if backoff_base_s <= 0 or backoff_max_s < backoff_base_s:
            raise ValueError(
                f"need 0 < backoff_base_s <= backoff_max_s, got {backoff_base_s}/{backoff_max_s}"
            )
        if poison_threshold < 1:
            raise ValueError(f"poison_threshold must be >= 1, got {poison_threshold}")
        if guard_ring < 1:
            raise ValueError(f"guard_ring must be >= 1, got {guard_ring}")
        if guard_recover_s <= 0:
            raise ValueError(f"guard_recover_s must be > 0, got {guard_recover_s}")
        self.name = name
        self.target = target
        self.kwargs = dict(kwargs or {})
        self.fused = bool(fused)
        self.fused_options = dict(fused_options) if fused_options else None
        self.window = dict(window) if window else None
        self.snapshot_every_n = snapshot_every_n
        self.snapshot_every_s = snapshot_every_s
        self.queue_max = int(queue_max)
        self.use_feed = bool(use_feed)
        self.watchdog_timeout_s = watchdog_timeout_s
        self.on_stall = on_stall
        self.max_restarts = int(max_restarts)
        self.restart_window_s = float(restart_window_s)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.poison_threshold = int(poison_threshold)
        self.guard_ring = int(guard_ring)
        self.guard_recover_s = float(guard_recover_s)

    def to_wire(self) -> Dict[str, Any]:
        return {field: getattr(self, field) for field in self._FIELDS}

    @classmethod
    def from_wire(cls, obj: Dict[str, Any]) -> "StreamSpec":
        unknown = sorted(set(obj) - set(cls._FIELDS))
        if unknown:
            raise wire.WireError(f"unknown StreamSpec field(s): {', '.join(unknown)}")
        if "name" not in obj or "target" not in obj:
            raise wire.WireError("StreamSpec needs at least 'name' and 'target'")
        return cls(**obj)

    def build_evaluator(self, store_dir: str, device: Any = "cuda") -> Any:
        """Materialize the evaluator this spec describes over ``store_dir``,
        its target built on ``device``.

        ``write_rank=None``: a daemon rank owns its whole base directory, so
        EVERY rank persists (multi-host deployments give each rank its own
        base dir and fold state through the merge-state sync at compute)."""
        from torchmetrics_tpu_torch.robustness.runner import StreamingEvaluator

        metric = resolve_target(self.target, self.kwargs, device=device)
        ring = None
        if self.window is not None:
            from torchmetrics_tpu_torch.parallel.windowing import WindowRing

            ring = WindowRing(metric, **self.window)
        store = CheckpointStore(store_dir, keep_last=3, write_rank=None)
        return StreamingEvaluator(
            metric,
            store=store,
            snapshot_every_n=self.snapshot_every_n,
            snapshot_every_s=self.snapshot_every_s,
            fused=self.fused,
            fused_options=self.fused_options,
            window_ring=ring,
            watchdog_timeout_s=self.watchdog_timeout_s,
            on_stall=self.on_stall,
        )


class _Op:
    """One control op riding the batch queue (see the module docstring)."""

    __slots__ = ("name", "done", "result", "error")

    def __init__(self, name: str) -> None:
        self.name = name
        self.done = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None

    def finish(self, result: Any = None, error: Optional[BaseException] = None) -> None:
        self.result, self.error = result, error
        self.done.set()


class Stream:
    """One running stream: spec + evaluator + bounded queue + supervised worker,
    on ``device`` (default ``"cuda"``; pass ``"cpu"`` to run on the host)."""

    def __init__(self, spec: StreamSpec, store_dir: str, device: Any = "cuda") -> None:
        self.spec = spec
        self.store_dir = str(store_dir)
        self.device = resolve_device(device, f"stream {spec.name}")
        if self.device.type == "cuda" and self.device.index is None:
            # resolved on the caller's thread: the worker's current device is its own
            self.device = torch.device("cuda", torch.cuda.current_device())
        #: sibling of the store dir — survives store prunes AND daemon restarts
        self.deadletter_path = os.path.join(
            os.path.dirname(os.path.abspath(self.store_dir)), "deadletter.jsonl"
        )
        self.evaluator = spec.build_evaluator(self.store_dir, self.device)
        self._queue: "queue.Queue[Tuple[str, Any]]" = queue.Queue(maxsize=spec.queue_max)
        self._pending_ops: "deque[_Op]" = deque()
        self._lock = threading.Lock()
        self._ready = threading.Event()
        self._finished = threading.Event()
        self.state = "starting"
        self.next_seq = 0  # acked watermark; meaningful once _ready is set
        self.result: Optional[Any] = None
        self.failure: Optional[str] = None
        self.last_failure: Optional[str] = None  # newest worker crash (survives healing)
        self.dropped = 0
        self._dropped_latched = False
        # --- supervision / circuit breaker -------------------------------
        self.circuit = "closed"
        self.restarts = 0
        self._failure_times: "deque[float]" = deque()  # monotonic, pruned to the window
        self._opened_once = False
        self._evaluator_dirty = False  # the evaluator died mid-step: rebuild before reuse
        self._applying = False  # worker is inside a batch apply (poison accounting)
        self._crash_seq: Optional[int] = None  # consecutive-crash culprit
        self._crash_count = 0
        # --- retained in-flight buffer (exactly-once across restarts) ----
        self._retained: Dict[int, Tuple[Any, Any]] = {}  # seq -> (wire batch, decoded)
        self._retained_floor = 0  # seqs below were pruned/evicted — unrecoverable
        self._retain_cap = max(256, 4 * spec.queue_max)
        self._last_snap_step = 0  # retention keeps everything >= the PREVIOUS snapshot
        self._snap_seen_t: Optional[float] = None
        # --- dead-letter quarantine --------------------------------------
        self._deadletter: Dict[int, Dict[str, Any]] = {}
        self._quarantined: set = set()
        self._dl_dirty = False  # records newer than the on-disk file (disk fault)
        self._dl_write_lock = threading.Lock()
        self._load_deadletter()
        # --- StateGuard known-good rollback ring -------------------------
        self._guard_metric: Optional[Any] = None  # the guarded target, re-resolved per incarnation
        self._guard_ring: "deque[Tuple[int, Dict[str, Any], int]]" = deque(maxlen=spec.guard_ring)
        self._guard_rollback_times: "deque[float]" = deque()  # monotonic, pruned to guard_recover_s
        self.guard_rollbacks = 0
        self.guard_poisoned_total = 0  # poison detections (the latch itself resets on rollback)
        # --- durability degradation --------------------------------------
        self._durable = True
        self._store_ref: Optional[CheckpointStore] = None  # parked store while degraded
        self._probe_at = 0.0
        self.write_failures = 0
        # --- payload validation ------------------------------------------
        self._avals: Optional[Tuple[Tuple[Tuple[int, ...], str], ...]] = None
        self._drain_op: Optional[_Op] = None
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"metricserve-{spec.name}"
        )

    # ----------------------------------------------------------- lifecycle
    def start(self, timeout_s: float = 60.0) -> int:
        """Start the worker, wait for the durable open (snapshot restore) to
        finish, and return the cursor batches resume from — the ``next_seq``
        a client must replay from."""
        self._thread.start()
        if not self._ready.wait(timeout_s):
            raise TimeoutError(f"stream {self.spec.name} did not open within {timeout_s}s")
        with self._lock:
            if self.state == "failed":
                raise RuntimeError(f"stream {self.spec.name} failed to open: {self.failure}")
            return self.next_seq

    def _run(self) -> None:
        """Supervisor: serve until clean exit; on a crash decide restart vs
        park/fail. Backoff/circuit/poison policy lives in :meth:`_supervise`.
        The whole worker runs inside the stream's CUDA device."""
        device = torch.cuda.device(self.device) if self.device.type == "cuda" else nullcontext()
        try:
            with device:
                while True:
                    try:
                        self._serve_once()
                        return
                    except BaseException as err:  # the worker must report, never vanish
                        self._evaluator_dirty = True
                        if not self._supervise(err):
                            return
        finally:
            self._ready.set()
            self._finished.set()

    def _serve_once(self) -> None:
        """One worker incarnation: open (restore), replay the retained
        suffix, then pump the live queue until a drain/abandon ends it."""
        if self._evaluator_dirty:
            # the previous incarnation died mid-step: its in-memory state is
            # suspect — rebuild from the spec and restore through the
            # durability plane's recovery ladder
            try:
                self.evaluator._unregister_probes()
            except Exception:
                pass
            # free the dead evaluator's fused plan (its graphs and pool)
            # before the rebuild allocates, and its states after the swap;
            # status reads keep a live evaluator throughout
            dead = self.evaluator
            dead._fused_plan = None
            gc.collect()
            self.evaluator = self.spec.build_evaluator(self.store_dir, self.device)
            del dead
            gc.collect()
            self._evaluator_dirty = False
        start = int(self.evaluator.serve_open())
        self._opened_once = True
        if not self._durable:
            # still degraded: reads worked, writes stay off until the
            # recovery probe flips durability back on
            with self._lock:
                self._store_ref = self.evaluator.store
                self.evaluator.store = None
        self._snap_seen_t = self.evaluator._last_snapshot_t
        self._last_snap_step = start
        self._guard_open()
        if self.spec.use_feed:
            # a superseded staging thread may still be draining the OLD
            # queue; give its in-flight op hand-off a beat to land before we
            # collect the side-channel (batches need no grace: the retained
            # buffer re-feeds them regardless of who consumed the queue item)
            time.sleep(0.05)
        with self._lock:
            if self.state == "failed":
                raise _Halt(self.failure or "stream stopped")
            if start > self.next_seq:
                self.next_seq = start  # fresh process over an older store
            evicted = [
                s for s in range(start, self.next_seq)
                if s not in self._retained and s not in self._quarantined and s < self._retained_floor
            ]
            if evicted:
                raise _Unrecoverable(
                    f"acked batch(es) {evicted[:5]} fell below the retained-buffer floor"
                    f" ({self._retained_floor}) and the snapshot restore only reached cursor"
                    f" {start} — exactly-once replay is impossible"
                )
            replay = [
                (s, self._retained[s][1] if s in self._retained else None)
                for s in range(start, self.next_seq)
            ]
            # synthetic skips are NOT carried over: replay regenerates them
            # from the quarantine set, and a stale one would double-advance
            # the cursor
            parked: "deque[_Op]" = deque(op for op in self._pending_ops if op.name != "skip")
            while True:
                try:
                    kind, payload = self._queue.get_nowait()
                except queue.Empty:
                    break
                if kind == "op":
                    parked.append(payload)
            # fresh queue + side-channel per incarnation: a stale DeviceFeed
            # stager blocked in the old source can never steal live batches
            self._queue = queue.Queue(maxsize=self.spec.queue_max)
            self._pending_ops = deque()
            pending = self._pending_ops
            live_queue = self._queue
            if self.state == "starting":
                self.state = "serving"
        self._ready.set()
        source = self._source(live_queue, pending, replay, parked)
        if self.spec.use_feed:
            from torchmetrics_tpu_torch.parallel.feed import DeviceFeed

            items: Any = DeviceFeed(source, device=self.device)
        else:
            items = source
        try:
            for item in items:
                if isinstance(item, tuple) and not item:
                    self._exec_op(pending.popleft())
                else:
                    self._applying = True
                    if faults._ACTIVE:
                        faults.fire("serve.worker.crash")
                    self._step_guarded(item)
                    self._applying = False
                    if self._guard_metric is not None:
                        self._guard_after_apply(item)
                    self._note_applied()
                self._after_apply()
            # the source ended: a drain (or abandon) op asked for the close
            final_op = pending.popleft()
            try:
                if final_op.name == "abandon":
                    self.evaluator._unregister_probes()
                    final_op.finish()
                else:
                    result = self._close_guarded()
                    with self._lock:
                        self.result = wire.to_jsonable(result)
                        self.state = "drained"
                    final_op.finish(result=self.result)
            except BaseException as err:
                # never leave the drain caller waiting out its timeout:
                # report, then let supervision decide the stream's fate
                final_op.finish(error=err)
                raise
        except BaseException:
            # an op accepted into this incarnation must outlive its death:
            # whatever was marker-yielded but unexecuted (minus synthetic
            # skips) plus whatever never left the parked deque is handed to
            # the next incarnation — or error-finished by the failure path
            with self._lock:
                self._pending_ops = deque(
                    [op for op in pending if op.name != "skip" and not op.done.is_set()]
                    + [op for op in parked if not op.done.is_set()]
                )
            raise

    def _source(
        self,
        live_queue: "queue.Queue[Tuple[str, Any]]",
        pending: "deque[_Op]",
        replay: List[Tuple[int, Any]],
        parked: "deque[_Op]",
    ) -> Any:
        """Replayed suffix + re-parked ops + live queue → one iterator the
        (optional) DeviceFeed stages. Ends at drain/abandon — or quietly when
        a restart has superseded this incarnation's queue."""
        for seq, decoded in replay:
            if decoded is None or seq in self._quarantined:
                # quarantined (or a requeued dead-letter hole): advance the
                # cursor without applying so the watermark stays seq == cursor
                pending.append(_Op("skip"))
                yield _OP_MARKER
            else:
                yield decoded
        while parked:
            op = parked.popleft()
            pending.append(op)
            if op.name in ("drain", "abandon"):
                stop = RuntimeError(f"stream {self.spec.name} is past {op.name}")
                while parked:
                    parked.popleft().finish(error=stop)
                return
            yield _OP_MARKER
        while True:
            try:
                kind, payload = live_queue.get(timeout=1.0)
            except queue.Empty:
                if live_queue is not self._queue:
                    return  # superseded incarnation: wind down the stale feed
                continue
            if kind == "batch":
                seq, decoded = payload
                if seq in self._quarantined:
                    pending.append(_Op("skip"))
                    yield _OP_MARKER
                else:
                    yield decoded
            elif payload.name in ("drain", "abandon"):
                pending.append(payload)
                return
            else:
                pending.append(payload)
                yield _OP_MARKER

    # ------------------------------------------------- disk-fault degradation
    def _note_write_failure(self, err: BaseException) -> None:
        _obs_counters.inc("store.write_failures")
        with self._lock:
            # counter mutates under the same lock its readers take (ML012) —
            # writer and recovery-probe threads both call this path
            self.write_failures += 1
            self.last_failure = f"{type(err).__name__}: {err}"

    def _enter_degraded(self) -> None:
        """Detach the store: the stream keeps serving in-memory-only while
        the recovery probe retries the write path."""
        with self._lock:
            if not self._durable:
                return
            self._durable = False
            self._store_ref = self.evaluator.store
            self.evaluator.store = None
            self._probe_at = time.monotonic() + _RECOVERY_PROBE_S

    def _handle_disk_fault(self, err: OSError) -> bool:
        """A snapshot write hit ENOSPC/EIO: retry with backoff, then degrade.
        True when a retry landed the write (durability intact)."""
        self._note_write_failure(err)
        delay = _DISK_RETRY_BASE_S
        for _ in range(_DISK_RETRIES):
            time.sleep(delay)
            delay *= 2
            try:
                self.evaluator.snapshot()
                return True
            except OSError as retry_err:
                if not _is_disk_error(retry_err):
                    raise
                self._note_write_failure(retry_err)
        self._enter_degraded()
        return False

    def _step_guarded(self, item: Any) -> None:
        cursor_before = self.evaluator.cursor
        try:
            self.evaluator.serve_step(item)
        except OSError as err:
            # ENOSPC/EIO with the cursor already advanced = the batch applied
            # and only its cadence snapshot failed — absorb into degradation
            if _is_disk_error(err) and self.evaluator.cursor > cursor_before:
                self._handle_disk_fault(err)
            else:
                raise

    def _close_guarded(self) -> Any:
        try:
            return self.evaluator.serve_close()
        except OSError as err:
            if not _is_disk_error(err):
                raise
            # the members are already folded back and only the FINAL snapshot
            # hit disk exhaustion: degrade and compute in memory rather than
            # fail the whole drain
            self._note_write_failure(err)
            self._enter_degraded()
            evaluator = self.evaluator
            compute = evaluator.metric.compute_all if evaluator._is_plan else evaluator.metric.compute
            return evaluator._bounded(compute, "compute")

    # ----------------------------------------------- StateGuard rollback ring
    def _guard_open(self) -> None:
        """Per-incarnation guard wiring: resolve whether this evaluator's
        target is a guarded plain Metric, point the runner's cadence-snapshot
        gate at the poison probe (a just-corrupted state must not reach disk
        in the window between the apply and the rollback), and seed the
        rollback ring with the just-restored — hence verified — state.

        Ring entries are ``(cursor, state dict, update_count)``;
        ``_copy_state_dict`` holds array REFERENCES, so a deep ring costs
        pointers per batch, not state copies."""
        self._guard_ring.clear()
        self._guard_metric = None
        evaluator = self.evaluator
        if self.spec.fused or self.spec.window is not None or evaluator._is_plan:
            return  # ring rollback needs a plain Metric target owning its own states
        metric = getattr(evaluator, "metric", None)
        if metric is None or getattr(metric, "_guard_policy", None) is None:
            return
        self._guard_metric = metric
        evaluator.snapshot_gate = self._guard_snapshot_gate
        self._guard_capture()

    def _guard_snapshot_gate(self) -> bool:
        metric = self._guard_metric
        return metric is None or int(metric.guard_poisoned) == 0

    def _guard_capture(self) -> None:
        metric = self._guard_metric
        self._guard_ring.append(
            (int(self.evaluator.cursor), metric._copy_state_dict(), metric._update_count)
        )

    def _guard_after_apply(self, item: Any) -> None:
        """Poison-probe checkpoint after every applied batch: clean → retain
        the post-batch state in the ring; tripped → restore the newest
        known-good entry (the state BEFORE the offending batch), quarantine
        the batch to the dead-letter ledger with its guard verdict, and skip
        past it — no disk restore, no client replay (later batches are still
        queued; the skip moves the watermark exactly one seq)."""
        metric = self._guard_metric
        if int(metric.guard_poisoned) == 0:
            self._guard_capture()
            return
        evaluator = self.evaluator
        culprit = int(evaluator.cursor) - 1
        if not self._guard_ring:
            raise _Unrecoverable(
                f"poison probe tripped at seq {culprit} with an empty rollback ring"
            )
        cursor0, state, count = self._guard_ring[-1]
        metric._install_state_tree(state)
        metric._update_count = count
        metric._computed = None
        evaluator.cursor = cursor0
        with self._lock:
            self.guard_rollbacks += 1
            self.guard_poisoned_total += 1
            self._guard_rollback_times.append(time.monotonic())
        _obs_counters.inc("serve.guard_rollbacks")
        from torchmetrics_tpu_torch.robustness.guard import batch_verdict_host

        verdict = batch_verdict_host(metric, item if isinstance(item, tuple) else (item,))
        err = RuntimeError(f"StateGuard poison probe: state went non-finite applying seq {culprit}")
        self._quarantine(culprit, err, guard=verdict)
        # advance the watermark past the quarantined batch; the cadence
        # snapshot inside the skip persists the ROLLED-BACK truth (the latch
        # is down again, so the gate passes)
        cursor_before = evaluator.cursor
        try:
            evaluator.serve_skip()
        except OSError as skip_err:
            if _is_disk_error(skip_err) and evaluator.cursor > cursor_before:
                self._handle_disk_fault(skip_err)
            else:
                raise
        self._guard_capture()

    def _guard_health_code(self) -> int:
        """0 ok / 1 stalling / 2 degraded from rollbacks inside the sliding
        ``guard_recover_s`` window — the ``guard.<name>.health_state`` gauge
        the live plane floors ``/healthz`` with (one recent rollback is an
        incident; repeats mean the upstream is actively feeding poison)."""
        with self._lock:
            horizon = time.monotonic() - self.spec.guard_recover_s
            while self._guard_rollback_times and self._guard_rollback_times[0] < horizon:
                self._guard_rollback_times.popleft()
            recent = len(self._guard_rollback_times)
        return 2 if recent >= 2 else (1 if recent == 1 else 0)

    def _after_apply(self) -> None:
        """Post-item housekeeping on the worker: retained-buffer pruning when
        a snapshot lands, and the degraded-mode durability recovery probe."""
        evaluator = self.evaluator
        if (
            self._durable
            and evaluator.store is not None
            and evaluator._last_snapshot_t != self._snap_seen_t
        ):
            self._snap_seen_t = evaluator._last_snapshot_t
            step = evaluator.store.last_step()
            if step is not None and step > self._last_snap_step:
                # a NEW snapshot landed: batches below the PREVIOUS one can
                # never be replayed again, even if the newest proves corrupt
                # and the restore ladder falls back one level
                floor = self._last_snap_step
                with self._lock:
                    for seq in [s for s in self._retained if s < floor]:
                        del self._retained[seq]
                    if floor > self._retained_floor:
                        self._retained_floor = floor
                self._last_snap_step = step
        if (not self._durable or self._dl_dirty) and time.monotonic() >= self._probe_at:
            self._probe_at = time.monotonic() + _RECOVERY_PROBE_S
            self._recover_durability()

    def _recover_durability(self) -> None:
        if not self._durable:
            self.evaluator.store = self._store_ref
            try:
                self.evaluator.snapshot()
            except OSError as err:
                if not _is_disk_error(err):
                    self.evaluator.store = None
                    raise
                self._note_write_failure(err)
                self.evaluator.store = None
                return
            with self._lock:
                self._durable = True
                self._store_ref = None
            self._snap_seen_t = None  # force the prune scan to re-baseline
        if self._dl_dirty:
            self._persist_deadletter()

    # --------------------------------------------------- dead-letter storage
    def _load_deadletter(self) -> None:
        """Re-read the quarantine at construction — dead-letter state must
        survive a daemon restart."""
        try:
            with open(self.deadletter_path, "r", encoding="utf-8") as fh:
                lines = fh.readlines()
        except (FileNotFoundError, OSError):
            return
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
                seq = int(record["seq"])
            except (ValueError, TypeError, KeyError):
                continue  # a torn line can only predate atomic_write — skip it
            self._deadletter[seq] = record
            self._quarantined.add(seq)

    def _write_deadletter(self) -> None:
        with self._lock:
            records = [self._deadletter[s] for s in sorted(self._deadletter)]
        lines = [json.dumps(record, separators=(",", ":"), sort_keys=True) for record in records]
        data = ("\n".join(lines) + "\n").encode() if lines else b""
        if faults._ACTIVE:
            try:
                faults.fire("deadletter.write")
            except faults.FaultInjected as err:
                raise OSError(errno.ENOSPC, f"injected disk exhaustion: {err}") from None
        _fmt.atomic_write(self.deadletter_path, data)

    def _persist_deadletter(self) -> None:
        """Atomic whole-file rewrite with the disk-fault retry/degrade
        discipline; on exhaustion the quarantine stays memory-only (dirty)
        and the recovery probe re-persists it."""
        with self._dl_write_lock:
            delay = _DISK_RETRY_BASE_S
            for attempt in range(_DISK_RETRIES + 1):
                try:
                    # _dl_write_lock exists ONLY to serialize deadletter-file
                    # writers; holding it across the write is its purpose and
                    # no reader/ingest path ever contends on it
                    # metriclint: disable=ML012 -- dedicated writer-serialization lock
                    self._write_deadletter()
                    self._dl_dirty = False
                    return
                except OSError as err:
                    if not _is_disk_error(err):
                        raise
                    self._note_write_failure(err)
                    if attempt < _DISK_RETRIES:
                        # backoff under the dedicated writer-serialization lock
                        # is intentional: a concurrent writer SHOULD wait out
                        # the retry window rather than race the rewrite
                        # metriclint: disable=ML012 -- intentional backoff under writer lock
                        time.sleep(delay)
                        delay *= 2
            self._dl_dirty = True

    def _quarantine(self, seq: int, err: BaseException, guard: Optional[Dict[str, Any]] = None) -> None:
        with self._lock:
            entry = self._retained.pop(seq, None)
            record = {
                "seq": seq,
                "stream": self.spec.name,
                "batch": entry[0] if entry is not None else None,
                "error": f"{type(err).__name__}: {err}",
                "attempts": self._crash_count,
                "quarantined_at": time.time(),
            }
            if guard is not None:
                # the StateGuard verdict for the poisoned batch: nan/inf/
                # domain row counts — metricdoctor pretty-prints these
                record["guard"] = guard
            self._deadletter[seq] = record
            self._quarantined.add(seq)
        _obs_counters.inc("serve.deadletter")
        self._persist_deadletter()

    # ------------------------------------------------------------ supervision
    def _supervise(self, err: BaseException) -> bool:
        """Decide the crashed worker's fate: True = restart (after backoff),
        False = stream parked/failed/halted. Runs on the worker thread."""
        applying, self._applying = self._applying, False
        if isinstance(err, _Halt):
            self._release_waiters(RuntimeError(str(err)))
            return False
        if isinstance(err, _Unrecoverable) or not self._opened_once:
            self._fail(err)
            return False
        with self._lock:
            halted = self.state == "failed"  # deleted/abandoned while crashing
            self.last_failure = f"{type(err).__name__}: {err}"
        if halted:
            self._release_waiters(err)
            return False
        _obs_counters.inc("serve.worker_crashes")
        if not applying:
            # the crash hit between batches (op/feed/open): the evaluator is
            # still cursor-consistent — persist it so the restart replays the
            # shortest possible suffix (best-effort; degradation handles disk)
            try:
                if self._durable and self.evaluator.store is not None:
                    self.evaluator.snapshot()
                    self._after_apply()
            except BaseException:
                pass
        quarantined_now = False
        if applying:
            culprit = int(self.evaluator.cursor)
            if culprit == self._crash_seq:
                # _crash_seq/_crash_count are confined to the single
                # supervisor thread; no other thread reads or writes them
                # metriclint: disable=ML012 -- supervisor-thread-confined counter
                self._crash_count += 1
            else:
                self._crash_seq, self._crash_count = culprit, 1
            if self._crash_count >= self.spec.poison_threshold and culprit not in self._quarantined:
                self._quarantine(culprit, err)
                quarantined_now = True
                self._crash_seq, self._crash_count = None, 0
                # the poisonous cause is removed — fresh restart budget
                self._failure_times.clear()
        if self.circuit == "half_open" and not quarantined_now:
            self._park(err)
            return False
        now = time.monotonic()
        self._failure_times.append(now)
        while self._failure_times and now - self._failure_times[0] > self.spec.restart_window_s:
            self._failure_times.popleft()
        if len(self._failure_times) > self.spec.max_restarts:
            self._park(err)
            return False
        with self._lock:
            self.restarts += 1
        _obs_counters.inc("serve.worker_restarts")
        attempt = len(self._failure_times)
        base = min(self.spec.backoff_max_s, self.spec.backoff_base_s * (2 ** (attempt - 1)))
        deadline = time.monotonic() + base + random.uniform(0.0, base)
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return True
            with self._lock:
                abandoned = self.state == "failed"
            if abandoned:  # deleted during the backoff: don't wait it out
                self._release_waiters(err)
                return False
            time.sleep(min(0.02, remaining))

    def _park(self, err: BaseException) -> None:
        """Open the circuit: the stream stops restarting and waits for a
        manual :meth:`revive`. Pending acked batches stay retained (NOT
        latched as dropped) — a revive applies them."""
        with self._lock:
            self.circuit = "open"
        wrapped = RuntimeError(
            f"circuit open after {len(self._failure_times)} worker failure(s) within"
            f" {self.spec.restart_window_s:g}s (last: {type(err).__name__}: {err})"
            f" — revive {self.spec.name!r} to retry"
        )
        _obs_counters.inc("serve.circuit_open")
        self._fail(wrapped, latch_dropped=False)

    def revive(self, timeout_s: float = 60.0) -> Dict[str, Any]:
        """Half-open a parked stream's circuit and start one probe worker
        incarnation: its first successful apply closes the circuit, its first
        failure re-opens it. Only valid with the circuit ``open``."""
        with self._lock:
            if not (self.state == "failed" and self.circuit == "open"):
                return wire.error(
                    "bad_request",
                    f"stream {self.spec.name} is not parked"
                    f" (state {self.state}, circuit {self.circuit})",
                )
        self._thread.join(timeout=10.0)  # the parked worker is exiting; let it
        with self._lock:
            self.circuit = "half_open"
            self.state = "starting"
            self.failure = None
            self._failure_times.clear()
            self._crash_seq, self._crash_count = None, 0
            self._evaluator_dirty = True
            self._ready = threading.Event()
            self._finished = threading.Event()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name=f"metricserve-{self.spec.name}"
            )
        try:
            next_seq = self.start(timeout_s)
        except (RuntimeError, TimeoutError) as err:
            return wire.error("failed", f"revive of {self.spec.name} failed: {err}")
        return wire.ok(stream=self.spec.name, revived=True, next_seq=next_seq, circuit=self.circuit)

    def _note_applied(self) -> None:
        """A batch fully applied: reset poison accounting and close a
        half-open circuit (the probe incarnation proved itself)."""
        if self._crash_seq is not None and self.evaluator.cursor > self._crash_seq:
            # the SUSPECT batch itself applied cleanly, so it is not poison;
            # a replayed batch BELOW the suspect proves nothing — resetting
            # there would let a poison batch behind a long replay suffix
            # crash-loop forever without ever reaching poison_threshold
            self._crash_seq, self._crash_count = None, 0
        if self.circuit != "closed":
            with self._lock:
                self.circuit = "closed"
            self._failure_times.clear()

    def _exec_op(self, op: _Op) -> None:
        try:
            if op.name == "flush":
                recovered = True
                try:
                    step = self.evaluator.snapshot()
                except OSError as err:
                    if not _is_disk_error(err):
                        raise
                    recovered = self._handle_disk_fault(err)
                    step = self.evaluator.cursor if recovered else None
                op.finish(result={
                    "snapshot_step": step,
                    "cursor": self.evaluator.cursor,
                    "durable": bool(self._durable),
                })
            elif op.name == "export":
                # captured ON the worker thread, so the payload is a
                # consistent cut: exactly the applied batches, cursor == the
                # watermark stamped on the slice
                op.finish(result=self.evaluator._payload())
            elif op.name == "skip":
                cursor_before = self.evaluator.cursor
                try:
                    self.evaluator.serve_skip()
                except OSError as err:
                    if _is_disk_error(err) and self.evaluator.cursor > cursor_before:
                        self._handle_disk_fault(err)
                    else:
                        raise
                op.finish()
            else:
                raise ValueError(f"unknown stream op {op.name!r}")
        except BaseException as err:
            op.finish(error=err)
            raise

    def _fail(self, err: BaseException, latch_dropped: bool = True) -> None:
        with self._lock:
            if self.state not in ("drained", "failed"):
                self.state = "failed"
                self.failure = f"{type(err).__name__}: {err}"
                if latch_dropped:
                    self._latch_dropped_locked()
        # the worker is dead: withdraw the evaluator's live probes so a
        # parked stream's last watchdog margin can't poison a LATER daemon's
        # /healthz in this process (revive re-registers via serve_open)
        try:
            self.evaluator._unregister_probes()
        except Exception:
            pass
        self._release_waiters(err)

    def _release_waiters(self, err: BaseException) -> None:
        """Fail every parked/queued op with the cause (queued batches are
        dropped from the queue — the retained buffer still holds them)."""
        while self._pending_ops:
            self._pending_ops.popleft().finish(error=err)
        while True:
            try:
                kind, payload = self._queue.get_nowait()
            except queue.Empty:
                break
            if kind == "op":
                payload.finish(error=err)

    def _latch_dropped_locked(self) -> None:
        """Latch acked-but-never-applied batches into the dropped counter
        (once — parked streams latch only if later deleted, not on park)."""
        if self._dropped_latched:
            return
        self._dropped_latched = True
        pending = max(0, self.next_seq - self.evaluator.cursor)
        if pending:
            self.dropped += pending
            _obs_counters.inc("serve.dropped_batches", pending)

    # -------------------------------------------------------------- ingest
    def offer(
        self, seq: Any, batch: Any, *, block: bool = False, deadline_s: Optional[float] = None
    ) -> Dict[str, Any]:
        """Admit one wire batch under the seq protocol; returns a wire
        envelope. ``block=False`` is the HTTP mode (full queue → an immediate
        ``backpressure`` error the daemon maps to 429 + ``Retry-After``);
        ``block=True`` is the socket mode (wait up to ``deadline_s`` for a
        slot, then the same error)."""
        if not self._ready.is_set():
            if not self._ready.wait(deadline_s if block and deadline_s else 0.05):
                return wire.error(
                    "backpressure", f"stream {self.spec.name} is still opening", retry_after_s=0.1
                )
        if not isinstance(seq, int) or isinstance(seq, bool) or seq < 0:
            return wire.error("bad_request", f"seq must be a non-negative int, got {seq!r}")
        try:
            decoded = decode_batch(batch)
        except wire.WireError as err:
            return wire.error("bad_request", str(err))
        bad = self._check_payload(decoded)
        if bad is not None:
            return bad
        if faults._ACTIVE:
            faults.fire("serve.ingest")
        # seq check + enqueue + ack are ONE atomic step under the lock —
        # two racing offers of the same seq must not both enqueue. The socket
        # mode retries the non-blocking attempt until its deadline rather
        # than blocking inside the lock (status/gauges stay responsive).
        deadline = None if deadline_s is None else time.monotonic() + deadline_s
        while True:
            with self._lock:
                if self.state == "failed":
                    message = f"stream {self.spec.name} failed: {self.failure}"
                    if self.circuit == "open":
                        message += " (circuit open — revive to retry)"
                    return wire.error("failed", message, circuit=self.circuit)
                if self.state in ("draining", "drained"):
                    return wire.error("draining", f"stream {self.spec.name} is {self.state}")
                if seq < self.next_seq:
                    # duplicate replay — ack idempotently, nothing re-applied
                    return wire.ok(stream=self.spec.name, duplicate=True, next_seq=self.next_seq)
                if seq > self.next_seq:
                    return wire.error(
                        "bad_seq",
                        f"gap: got seq {seq}, expected {self.next_seq} — rewind the replay",
                        expected=self.next_seq,
                    )
                try:
                    self._queue.put_nowait(("batch", (seq, decoded)))
                except queue.Full:
                    pass
                else:
                    self._admit_locked(seq, batch, decoded)
                    return wire.ok(stream=self.spec.name, next_seq=self.next_seq)
            if not block or (deadline is not None and time.monotonic() >= deadline):
                return wire.error(
                    "backpressure",
                    f"stream {self.spec.name} ingest queue is full ({self.spec.queue_max})",
                    retry_after_s=0.05,
                )
            time.sleep(0.005)

    def _admit_locked(self, seq: int, batch: Any, decoded: Tuple[Any, ...]) -> None:
        """Book-keeping for an enqueued batch: pin the aval signature at the
        first accept, retain the payload for crash replay, advance the ack
        watermark. Caller holds the lock and has already enqueued."""
        if self._avals is None:
            self._avals = _batch_signature(decoded)
        if seq not in self._quarantined:
            self._retained[seq] = (batch, decoded)
            while len(self._retained) > self._retain_cap:
                oldest = next(iter(self._retained))
                del self._retained[oldest]
                self._retained_floor = max(self._retained_floor, oldest + 1)
        self.next_seq = seq + 1

    def _check_payload(self, decoded: Tuple[Any, ...]) -> Optional[Dict[str, Any]]:
        """``bad_payload`` wire error when ``decoded`` disagrees with the
        stream's first-accepted batch avals, else None. Leading (batch) dims
        may differ; part count, dtypes and trailing shapes may not."""
        expected = self._avals
        if expected is None:
            return None
        got = _batch_signature(decoded)
        if got == expected:
            return None
        if len(got) != len(expected):
            message = f"batch has {len(got)} part(s), stream {self.spec.name} expects {len(expected)}"
        else:
            part = next(i for i in range(len(got)) if got[i] != expected[i])
            message = (
                f"part {part}: expected trailing shape {expected[part][0]} dtype"
                f" {expected[part][1]}, got {got[part][0]} dtype {got[part][1]}"
            )
        return wire.error(
            "bad_payload",
            f"payload disagrees with the stream's first-accepted batch — {message}",
            expected=[[list(shape), dtype] for shape, dtype in expected],
            got=[[list(shape), dtype] for shape, dtype in got],
        )

    # ------------------------------------------------------------- control
    def _submit_op(self, name: str, timeout_s: float) -> _Op:
        op = _Op(name)
        with self._lock:
            if self.state == "failed":
                op.finish(error=RuntimeError(self.failure or "stream failed"))
                return op
            if self.state in ("draining", "drained") and name != "drain":
                op.finish(error=RuntimeError(f"stream {self.spec.name} is {self.state}"))
                return op
            if name == "drain":
                if self.state == "drained":
                    op.finish(result=self.result)
                    return op
                if self.state == "draining":
                    live = self._drain_op
                    if live is not None and (not live.done.is_set() or live.error is None):
                        return live  # ride the drain already in flight
                    # the previous drain died with its worker: submit a fresh one
                self.state = "draining"
                self._drain_op = op
        deadline = time.monotonic() + timeout_s
        while True:
            target = self._queue
            try:
                target.put(("op", op), timeout=0.1)
            except queue.Full:
                if time.monotonic() >= deadline:
                    op.finish(
                        error=RuntimeError(f"stream {self.spec.name} queue stayed full for {timeout_s}s")
                    )
                    return op
                continue
            if target is self._queue or op.done.is_set():
                return op
            # a restart swapped the queue mid-put: the op may sit in a
            # superseded queue nobody reads — re-submit into the live one
            # (flush is idempotent; drain dedups through _drain_op)

    def flush(self, timeout_s: float = 60.0) -> Dict[str, Any]:
        """Snapshot now, AFTER everything already admitted has applied."""
        op = self._submit_op("flush", timeout_s)
        if not op.done.wait(timeout_s):
            return wire.error("failed", f"flush of {self.spec.name} timed out after {timeout_s}s")
        if op.error is not None:
            return wire.error("failed", f"flush failed: {op.error}")
        return wire.ok(stream=self.spec.name, **op.result)

    def export(self, timeout_s: float = 60.0, fingerprint: Optional[str] = None) -> Dict[str, Any]:
        """The ``/v1/state`` verb: a consistent state slice for federation.

        The payload (the checkpoint format, arrays wire-encoded with their
        dtypes) is captured on the worker thread via the op queue, so the
        stamped ``watermark`` is exactly the applied-batch cursor of the
        serialized state — an aggregator folding it can dedup a restarted
        leaf's replayed prefix against it. A drained stream exports its
        final state directly (the worker is gone; nothing mutates it).
        ``fingerprint`` pins the export: a mismatch is the typed
        ``fingerprint_mismatch`` error (HTTP 409) instead of a payload the
        caller would have to reject after the fact.
        """
        have = self.evaluator._fingerprint()
        if fingerprint is not None and fingerprint != have:
            return wire.error(
                "fingerprint_mismatch",
                f"stream {self.spec.name} carries registry fingerprint {have},"
                f" the export was pinned to {fingerprint}",
                expected=fingerprint,
                got=have,
            )
        with self._lock:
            state = self.state
        if state == "drained":
            payload = self.evaluator._payload()
        else:
            op = self._submit_op("export", timeout_s)
            if not op.done.wait(timeout_s):
                return wire.error("failed", f"export of {self.spec.name} timed out after {timeout_s}s")
            if op.error is not None:
                return wire.error("failed", f"export failed: {op.error}")
            payload = op.result
        return wire.ok(
            stream=self.spec.name,
            watermark=int(payload["cursor"]),
            kind=payload["kind"],
            fingerprint=have,
            windowed=self.spec.window is not None,
            spec={"target": self.spec.target, "kwargs": self.spec.kwargs,
                  "fused": self.spec.fused, "fused_options": self.spec.fused_options},
            state=wire.encode_state(payload),
        )

    def drain(self, timeout_s: float = 300.0) -> Dict[str, Any]:
        """Apply every admitted batch, final snapshot + compute; returns the
        results envelope. Idempotent — a second drain returns the same
        results."""
        if faults._ACTIVE:
            faults.fire("serve.drain")
        op = self._submit_op("drain", timeout_s)
        if not op.done.wait(timeout_s):
            return wire.error("failed", f"drain of {self.spec.name} timed out after {timeout_s}s")
        if op.error is not None:
            return wire.error("failed", f"drain failed: {op.error}")
        return wire.ok(stream=self.spec.name, cursor=self.evaluator.cursor, results=op.result)

    def abandon(self) -> int:
        """Stop the stream WITHOUT computing (the delete path): unblocks the
        worker, latches acked-but-unapplied batches as dropped, returns the
        dropped count."""
        with self._lock:
            already = self.state in ("drained", "failed")
            if not already:
                self.state = "failed"
                self.failure = "deleted"
            if self.state == "failed":
                # a parked stream deferred this latch hoping for a revive;
                # deletion makes its pending suffix unrecoverable for real
                self._latch_dropped_locked()
        if not already:
            # wake the worker: the abandon sentinel ends the source without a
            # final compute; the state machine above already stopped offers
            try:
                self._queue.put(("op", _Op("abandon")), timeout=5.0)
            except queue.Full:
                pass
        self._thread.join(timeout=10.0)
        return self.dropped

    # --------------------------------------------------------- dead letters
    def deadletter_list(self) -> Dict[str, Any]:
        """The quarantine, oldest first (payloads included — they are the
        recovery artifact)."""
        with self._lock:
            records = [dict(self._deadletter[s]) for s in sorted(self._deadletter)]
        return wire.ok(stream=self.spec.name, deadletter=records, depth=len(records))

    def deadletter_requeue(self, seq: Any) -> Dict[str, Any]:
        """Re-admit a quarantined payload through the normal exactly-once
        path at the CURRENT watermark (it gets a new seq). If re-admission
        fails the record is reinstated — a dead letter is never lost."""
        if not isinstance(seq, int) or isinstance(seq, bool):
            return wire.error("bad_request", f"seq must be an int, got {seq!r}")
        with self._lock:
            record = self._deadletter.get(seq)
            if record is not None and record.get("batch") is None:
                return wire.error(
                    "bad_request",
                    f"dead-letter seq {seq} kept no payload (evicted before quarantine) — purge it",
                )
            if record is not None:
                del self._deadletter[seq]
                self._quarantined.discard(seq)
        if record is None:
            return wire.error(
                "not_found", f"stream {self.spec.name} has no dead-letter record for seq {seq}"
            )
        self._persist_deadletter()
        reply = self._offer_at_watermark(record["batch"])
        if not reply.get("ok"):
            with self._lock:
                self._deadletter[seq] = record
                self._quarantined.add(seq)
            self._persist_deadletter()
            return reply
        return wire.ok(
            stream=self.spec.name, requeued=seq, as_seq=reply["as_seq"], next_seq=reply["next_seq"]
        )

    def _offer_at_watermark(self, batch: Any, deadline_s: float = 5.0) -> Dict[str, Any]:
        """Admit ``batch`` at whatever ``next_seq`` is when the slot opens —
        the requeue path must reserve its seq atomically (racing a concurrent
        client offer for a fixed seq could silently orphan the payload)."""
        try:
            decoded = decode_batch(batch)
        except wire.WireError as err:
            return wire.error("bad_request", str(err))
        bad = self._check_payload(decoded)
        if bad is not None:
            return bad
        deadline = time.monotonic() + deadline_s
        while True:
            with self._lock:
                if self.state == "failed":
                    return wire.error("failed", f"stream {self.spec.name} failed: {self.failure}")
                if self.state in ("draining", "drained"):
                    return wire.error("draining", f"stream {self.spec.name} is {self.state}")
                seq = self.next_seq
                try:
                    self._queue.put_nowait(("batch", (seq, decoded)))
                except queue.Full:
                    pass
                else:
                    self._admit_locked(seq, batch, decoded)
                    return wire.ok(stream=self.spec.name, as_seq=seq, next_seq=self.next_seq)
            if time.monotonic() >= deadline:
                return wire.error(
                    "backpressure",
                    f"stream {self.spec.name} ingest queue is full ({self.spec.queue_max})",
                    retry_after_s=0.05,
                )
            time.sleep(0.005)

    def deadletter_purge(self, seq: Any) -> Dict[str, Any]:
        """Drop a quarantined record for good; its batch counts as dropped
        (acked, never applied, now unrecoverable)."""
        if not isinstance(seq, int) or isinstance(seq, bool):
            return wire.error("bad_request", f"seq must be an int, got {seq!r}")
        with self._lock:
            record = self._deadletter.pop(seq, None)
            if record is not None:
                self._quarantined.discard(seq)
                self.dropped += 1
        if record is None:
            return wire.error(
                "not_found", f"stream {self.spec.name} has no dead-letter record for seq {seq}"
            )
        _obs_counters.inc("serve.dropped_batches")
        self._persist_deadletter()
        with self._lock:
            depth = len(self._deadletter)
        return wire.ok(stream=self.spec.name, purged=seq, depth=depth)

    # -------------------------------------------------------------- status
    def status(self) -> Dict[str, Any]:
        with self._lock:
            info: Dict[str, Any] = {
                "name": self.spec.name,
                "state": self.state,
                "cursor": self.evaluator.cursor,
                "next_seq": self.next_seq,
                "pending": max(0, self.next_seq - self.evaluator.cursor),
                "queue_depth": self._queue.qsize(),
                "queue_max": self.spec.queue_max,
                "dropped": self.dropped,
                "kind": self.evaluator._kind(),
                "restarts": self.restarts,
                "circuit": self.circuit,
                "deadletter_depth": len(self._deadletter),
                "durable": bool(self._durable and not self._dl_dirty),
                "write_failures": self.write_failures,
            }
            if self.failure is not None:
                info["failure"] = self.failure
            if self.last_failure is not None:
                info["last_failure"] = self.last_failure
            if self.result is not None:
                info["results"] = self.result
            guard_metric = self._guard_metric
        if guard_metric is not None:
            guard_info: Dict[str, Any] = {"policy": getattr(guard_metric, "_guard_policy", None)}
            try:
                from torchmetrics_tpu_torch.robustness.guard import guard_counters

                guard_info.update(guard_counters(guard_metric))
            except Exception:
                pass  # a mid-trace read must never take status down
            # cumulative stream-side counts LAST: guard_counters' "poisoned"
            # is the latch (always 0 again after a successful rollback)
            guard_info["rollbacks"] = self.guard_rollbacks
            guard_info["poisoned"] = self.guard_poisoned_total
            info["guard"] = guard_info
        return info

    def health_code(self) -> int:
        """0 ok … 3 stalled (the ``serve.<name>.health_state`` gauge): a
        failed/parked stream is stalled; a queue ≥ 90% full is stalling
        (admission is about to push back); a degraded (in-memory-only)
        stream is degraded while it still serves. Watchdog-margin decay
        rides the evaluator's own runner probe, not this code."""
        with self._lock:
            code = _STATE_HEALTH.get(self.state, 0)
            if self.state == "serving" and self._queue.qsize() >= max(1, int(0.9 * self.spec.queue_max)):
                code = max(code, 1)
            if self.state in ("serving", "draining") and (not self._durable or self._dl_dirty):
                code = max(code, 2)
            return code

    def gauges(self) -> Dict[str, float]:
        """The ``serve.<name>.*`` gauge family (daemon probe fodder), plus
        the metric's own ``drift.<name>.*`` family when the target publishes
        serve gauges (the drift subsystem: psi/kl/ks/severity/cardinality)."""
        prefix = f"serve.{self.spec.name}."
        with self._lock:
            state, qsize = self.state, self._queue.qsize()
            next_seq, dropped = self.next_seq, self.dropped
            restarts, circuit = self.restarts, self.circuit
            deadletter_depth = len(self._deadletter)
            durable = self._durable and not self._dl_dirty
        out = {
            prefix + "health_state": float(self.health_code()),
            prefix + "state": float(STATE_CODES.get(state, 0)),
            prefix + "cursor": float(self.evaluator.cursor),
            prefix + "pending": float(max(0, next_seq - self.evaluator.cursor)),
            prefix + "queue_depth": float(qsize),
            prefix + "dropped": float(dropped),
            prefix + "restarts": float(restarts),
            prefix + "circuit_state": float(CIRCUIT_CODES.get(circuit, 0)),
            prefix + "deadletter_depth": float(deadletter_depth),
            prefix + "durability": 1.0 if durable else 0.0,
        }
        serve_fn = getattr(getattr(self.evaluator, "metric", None), "serve_gauges", None)
        if callable(serve_fn):
            try:
                for key, val in serve_fn().items():
                    out[f"drift.{self.spec.name}.{key}"] = float(val)
            except Exception:  # a gauge read must never take the probe down
                _obs_counters.inc("serve.gauge_read_failures")
        guard_metric = self._guard_metric
        if guard_metric is not None:
            gp = f"guard.{self.spec.name}."
            try:
                from torchmetrics_tpu_torch.robustness.guard import guard_counters

                counters = guard_counters(guard_metric)
                out[gp + "masked"] = float(counters["masked_rows"])
                out[gp + "rejected"] = float(counters["rejected_batches"])
                out[gp + "nan_rows"] = float(counters["nan_rows"])
                out[gp + "inf_rows"] = float(counters["inf_rows"])
                out[gp + "domain_rows"] = float(counters["domain_rows"])
                out[gp + "rollbacks"] = float(self.guard_rollbacks)
                out[gp + "poisoned"] = float(self.guard_poisoned_total)
                out[gp + "health_state"] = float(self._guard_health_code())
            except Exception:  # ditto: counters read device scalars
                _obs_counters.inc("serve.gauge_read_failures")
        return out
