# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Preemption-safe streaming evaluation (counterpart of
``torchmetrics_tpu/robustness/runner.py``).

On preemptible fleets a multi-hour evaluation WILL be killed mid-stream;
without durable progress a death at batch 1.9M restarts from zero.
:class:`StreamingEvaluator` closes that gap by wrapping a ``Metric``, a
``MetricCollection``, or a custom (e.g. sharded) update step over a batch
iterable with:

- an **exactly-once batch cursor**: every snapshot records the number of
  fully-applied batches; :meth:`resume` fast-forwards the (deterministically
  re-creatable) stream past exactly that many batches and continues, so no
  batch is ever double-counted or skipped relative to the restored state —
  batches applied after the last snapshot die with the process and are
  simply replayed.
- a **snapshot policy**: every N batches and/or every T seconds, the metric's
  deep self-validating checkpoint plus the cursor is persisted through a
  :class:`~torchmetrics_tpu_torch.robustness.store.CheckpointStore` (atomic,
  CRC'd, retention-pruned, rank-aware). The payload is the JAX package's:
  either package resumes the other's store.
- a **watchdog**: each update (and the final compute/sync) optionally runs
  under a wall-clock deadline; a stall raises
  :class:`~torchmetrics_tpu_torch.utilities.exceptions.StallError` instead of
  hanging the fleet — ``on_stall="snapshot_then_raise"`` persists the
  last-good state first so the supervisor can kill and resume.

The watchdog runs the step on a daemon worker thread (the same trade as
``Metric._sync_dist_bounded``): an abandoned step cannot be cancelled and
its state must be considered poisoned — which is why the stall snapshot is
taken from the checkpoint captured BEFORE the stalled step, never from the
live (possibly half-mutated) metric. The worker enters the metric's CUDA
device first (a new thread's current device is device 0), so a fused plan
built there captures and allocates on the metric's card. The deadline
bounds the host's issue time: CUDA work is asynchronous, so a hung kernel
passes ``join`` and surfaces at the next synchronizing call (a device read,
a fold-back, ``compute()``), as with the JAX package's async dispatch.

Mesh-replicated states: the checkpoint format does not carry the flag a
sharded fold sets, so a bare ``load_checkpoint`` yields a rank-local state.
A drive that knows its regime re-marks it: after a restore, a fused drive
over a mesh (``fused_options["mesh"]``) marks the restored members
mesh-replicated before its plan is built, as the snapshot's states already
covered every rank. In the replica regime every rank's state differs: give
each rank its own store directory and ``write_rank=None``.

Observability (:mod:`torchmetrics_tpu_torch.obs`): with tracing on, the
drive records the ``runner.run``/``runner.resume`` spans; with tracing or
the live plane on, it counts progress (``runner.progress.batches``/``.samples``),
publishes the ``runner.cursor`` and ``runner.throughput.samples_per_s``
gauges, the snapshot counters and ``runner.snapshot.bytes_last``, refreshes
the cost-attribution rows at every snapshot, and registers its live probe
(and the window ring's and the sliced plan's) while a drive is in flight.
``TM_TPU_PUBLISH=<dir-or-host:port>`` starts the live publisher when an
evaluator is built. Each hook is one flag check when both are off.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from torchmetrics_tpu_torch.obs import attribution as _obs_attr
from torchmetrics_tpu_torch.obs import counters as _obs_counters
from torchmetrics_tpu_torch.obs import live as _obs_live
from torchmetrics_tpu_torch.obs import trace as _obs_trace
from torchmetrics_tpu_torch.robustness import faults
from torchmetrics_tpu_torch.robustness.store import CheckpointStore
from torchmetrics_tpu_torch.utilities.exceptions import StallError, StateRestoreError

__all__ = ["StreamingEvaluator"]

#: payload layout version for the runner's snapshot dict
RUNNER_PAYLOAD_VERSION = 1

_ON_STALL = ("raise", "snapshot_then_raise")


def _default_update(target: Any, batch: Any) -> None:
    """Positional-splat convention: a tuple batch is ``update(*batch)``,
    anything else is ``update(batch)`` — matches how eval loops usually zip
    preds/targets. Pass ``update_fn`` for anything richer (kwargs, sharded
    steps: ``lambda m, b: sharded_update(m, mesh, *b)``)."""
    if isinstance(batch, tuple):
        target.update(*batch)
    else:
        target.update(batch)


class StreamingEvaluator:
    """Drive a metric over a batch stream with durable, resumable progress.

    Args:
        metric: a ``Metric`` or ``MetricCollection`` accumulating the stream.
        store: the durable :class:`CheckpointStore`; ``None`` runs without
            durability (the watchdog still works).
        snapshot_every_n: persist a snapshot after every N applied batches.
        snapshot_every_s: persist a snapshot when at least T seconds passed
            since the last one (checked after each batch; combines with
            ``snapshot_every_n`` as an OR).
        update_fn: ``update_fn(metric, batch)`` override for the per-batch
            step (sharded steps, kwargs batches).
        watchdog_timeout_s: wall-clock deadline per update and for the final
            compute/sync; ``None`` disables the watchdog.
        on_stall: ``"raise"`` surfaces :class:`StallError` immediately;
            ``"snapshot_then_raise"`` first persists the last-good state
            (pre-stall cursor) to ``store``.
        fused: drive the fused plan (``parallel/fused.py``): a
            ``FusedCollectionPlan`` is built from the metric at the first
            batch (after any resume restore, so the carry picks up the
            restored states) and every batch is one CUDA graph replay on the
            card regardless of collection size. Fold-back into the member
            metrics happens only at snapshot/compute boundaries — never per
            batch — so the exactly-once cursor, the snapshot payloads and the
            final ``compute()`` are the unfused protocol's. Mutually
            exclusive with ``update_fn``. Note
            ``on_stall="snapshot_then_raise"`` captures a payload per batch
            and therefore folds back per batch.
        fused_options: kwargs for the plan build (``cat_capacity``,
            ``example_batch``, ``donate``, ``mesh``, ``axis_name``);
            ``example_batch`` defaults to the first batch.
        window_ring: a :class:`~torchmetrics_tpu_torch.parallel.windowing.WindowRing`
            wrapping the SAME ``metric``: after every applied batch the ring
            observes the cursor and closes the open window when its
            ``every_n``/``every_s`` trigger fires; the ring's closed windows
            ride every snapshot payload (kill-and-resume restores them with
            the open state). Mutually exclusive with ``fused=True``: a
            rotation resets the metric mid-stream, which the fused plan's
            carry cannot observe.

    ``metric`` may also be a
    :class:`~torchmetrics_tpu_torch.parallel.sliced.SlicedPlan`: the
    evaluator then drives ``plan.update(*batch)`` per batch (batches are
    ``(keys, *arrays)`` tuples), snapshots the plan's whole carry (slice
    table included) through the store under ``kind="sliced"``, and the final
    result is ``plan.compute_all()``. Mutually exclusive with
    ``fused``/``update_fn``/``window_ring`` — the plan owns its own dispatch
    and state layout.

    One evaluator instance drives one pass: :meth:`run` starts from batch 0
    (and demands a fresh store), :meth:`resume` restores the newest valid
    snapshot — or starts from 0 on an empty store, so supervisors can always
    call ``resume()``. A long-lived service instead pumps the open-loop form
    (:meth:`serve_open` / :meth:`serve_step` / :meth:`serve_close`), where the
    FEED positions itself at the restored cursor rather than replaying the
    stream past it.
    """

    def __init__(
        self,
        metric: Any,
        store: Optional[CheckpointStore] = None,
        snapshot_every_n: Optional[int] = None,
        snapshot_every_s: Optional[float] = None,
        update_fn: Optional[Callable[[Any, Any], None]] = None,
        watchdog_timeout_s: Optional[float] = None,
        on_stall: str = "raise",
        fused: bool = False,
        fused_options: Optional[Dict[str, Any]] = None,
        window_ring: Optional[Any] = None,
    ) -> None:
        if snapshot_every_n is not None and snapshot_every_n < 1:
            raise ValueError(f"snapshot_every_n must be >= 1, got {snapshot_every_n}")
        if snapshot_every_s is not None and snapshot_every_s <= 0:
            raise ValueError(f"snapshot_every_s must be > 0, got {snapshot_every_s}")
        if watchdog_timeout_s is not None and watchdog_timeout_s <= 0:
            raise ValueError(f"watchdog_timeout_s must be > 0 (or None to disable), got {watchdog_timeout_s}")
        if on_stall not in _ON_STALL:
            raise ValueError(f"on_stall must be one of {_ON_STALL}, got {on_stall!r}")
        if store is not None and not isinstance(store, CheckpointStore):
            raise ValueError(f"store must be a CheckpointStore, got {type(store).__name__}")
        if fused and update_fn is not None:
            raise ValueError("fused=True drives the FusedCollectionPlan itself; it cannot combine with update_fn")
        self._is_plan = False
        if type(metric).__name__ == "SlicedPlan":  # cheap gate before the parallel import
            from torchmetrics_tpu_torch.parallel.sliced import SlicedPlan

            self._is_plan = isinstance(metric, SlicedPlan)
        if self._is_plan and (fused or update_fn is not None or window_ring is not None):
            raise ValueError(
                "a SlicedPlan target owns its own dispatch and state layout; it cannot"
                " combine with fused/update_fn/window_ring"
            )
        if window_ring is not None:
            from torchmetrics_tpu_torch.parallel.windowing import WindowRing

            if not isinstance(window_ring, WindowRing):
                raise ValueError(f"window_ring must be a WindowRing, got {type(window_ring).__name__}")
            if window_ring.target is not metric:
                raise ValueError("window_ring must wrap the SAME metric object this evaluator drives")
            if fused:
                raise ValueError(
                    "window_ring cannot combine with fused=True: a window rotation resets the"
                    " metric mid-stream, which the fused plane's donated carry cannot observe"
                )
        self.metric = metric
        self.store = store
        self.snapshot_every_n = snapshot_every_n
        self.snapshot_every_s = snapshot_every_s
        self.update_fn = update_fn or _default_update
        self.fused = bool(fused)
        self.fused_options = dict(fused_options or {})
        self.window_ring = window_ring
        #: the live FusedCollectionPlan while a fused drive is in flight
        self._fused_plan: Optional[Any] = None
        self.watchdog_timeout_s = watchdog_timeout_s
        self.on_stall = on_stall
        #: number of batches fully applied to the metric state
        self.cursor = 0
        self._last_snapshot_t: Optional[float] = None
        self._last_good_payload: Optional[Dict[str, Any]] = None
        #: optional veto over CADENCE snapshots only (explicit snapshot() is
        #: never gated): the serve plane's StateGuard points this at the
        #: poison probe so a just-corrupted state cannot reach disk in the
        #: window between the apply and the rollback
        self.snapshot_gate: Optional[Callable[[], bool]] = None
        # per-drive loop state, installed by _begin_drive (also the open-loop
        # serve_open): the hoisted apply callable, the stall-policy flag and
        # the CUDA device index the watchdog's worker thread enters
        self._apply_batch: Optional[Callable[[Any], None]] = None
        self._snapshotting_stalls = False
        self._cuda_index: Optional[int] = None
        # live-plane producer state (obs/live.py): deadline of the in-flight
        # bounded step (the watchdog-margin probe reads it while the step
        # runs), last persisted snapshot size, and the throughput EWMA
        self._watchdog_deadline: Optional[float] = None
        self._snapshot_bytes_last: Optional[int] = None
        self._ewma_sps: Optional[float] = None
        self._last_batch_t: Optional[float] = None
        # honor TM_TPU_PUBLISH exactly once per process (no-op when unset):
        # constructing an evaluator is the natural "a long run starts here"
        _obs_live.maybe_enable_from_env()
        if store is not None and store.fingerprint is None:
            # pin the metric's registry fingerprint into the manifest so a
            # drifted metric definition is refused with a NAMED error at the
            # store door, before any snapshot is even read
            store.fingerprint = self._fingerprint()

    # ----------------------------------------------------------- checkpoints
    def _is_collection(self) -> bool:
        if self._is_plan:
            return False
        from torchmetrics_tpu_torch.collections import MetricCollection

        return isinstance(self.metric, MetricCollection)

    def _kind(self) -> str:
        if self._is_plan:
            return "sliced"
        return "collection" if self._is_collection() else "metric"

    def _members(self) -> List[Tuple[str, Any]]:
        """``(name, metric)`` of every top-level metric the evaluator drives
        (a plan's template members)."""
        if self._is_plan:
            return sorted(self.metric.members.items())
        if self._is_collection():
            return self.metric.items(keep_base=True, copy_state=False)
        return [("", self.metric)]

    def _fingerprint(self) -> str:
        """Registry fingerprint of the wrapped target: the metric's deep
        checkpoint fingerprint, a digest over every member's for a
        collection, or the plan's stable fingerprint for a ``SlicedPlan``
        target (the JAX package's, so stores cross over)."""
        from torchmetrics_tpu_torch.robustness.checkpoint import checkpoint_fingerprint

        if self._is_plan:
            return self.metric.stable_fingerprint()
        if self._is_collection():
            import hashlib
            import json

            canon = sorted((name, checkpoint_fingerprint(m)) for name, m in self._members())
            return hashlib.sha256(json.dumps(canon, separators=(",", ":")).encode()).hexdigest()[:16]
        return checkpoint_fingerprint(self.metric)

    def _checkpoint(self) -> Dict[str, Any]:
        if self._is_plan:
            return self.metric.save_checkpoint()  # the whole carry, table included
        if self._is_collection():
            # copy_state=True materializes per-member states out of compute-
            # group aliasing, so each member checkpoints its own (equal) state
            return {name: m.save_checkpoint() for name, m in self.metric.items(keep_base=True, copy_state=True)}
        return self.metric.save_checkpoint()

    def _restore_checkpoint(self, checkpoint: Dict[str, Any]) -> None:
        if self._is_plan:
            self.metric.load_checkpoint(checkpoint)  # validate-ALL-then-apply
            return
        if not self._is_collection():
            self.metric.load_checkpoint(checkpoint)  # validate-ALL-then-apply
            return
        live = dict(self._members())
        missing = sorted(set(live) - set(checkpoint))
        extra = sorted(set(checkpoint) - set(live))
        if missing or extra:
            raise StateRestoreError(
                "snapshot does not match the MetricCollection:"
                + (f" missing member(s) {missing}" if missing else "")
                + (f" unexpected member(s) {extra}" if extra else "")
            )
        # each member's load_checkpoint is atomic, but a member failing after
        # an earlier one applied would half-restore the COLLECTION — snapshot
        # every member first and roll the group back together on any failure
        prior = [
            (
                m,
                m._copy_state_dict(),
                m._update_count,
                m._mesh_replicated,
                {attr: getattr(m, attr) for attr in getattr(m, "_host_counters", ())},
            )
            for m in live.values()
        ]
        try:
            for name, member in live.items():
                member.load_checkpoint(checkpoint[name])
        except Exception:
            for member, tree, count, replicated, host_counters in prior:
                member._install_state_tree(tree)  # self-snapshot: trusted
                member._update_count = count
                member._mesh_replicated = replicated
                member._computed = None
                for attr, val in host_counters.items():
                    setattr(member, attr, val)
            raise

    def _payload(self) -> Dict[str, Any]:
        if self._fused_plan is not None:
            # a payload is a host boundary: the carried fused totals fold
            # back into the member metrics first, so every snapshot (periodic,
            # stall capture, final) serializes exactly the applied batches
            self._fused_plan.fold_back()
        payload = {
            "payload_version": RUNNER_PAYLOAD_VERSION,
            "cursor": self.cursor,
            "kind": self._kind(),
            "checkpoint": self._checkpoint(),
        }
        if self.window_ring is not None:
            # the closed windows travel WITH the open state + cursor: a
            # resumed run's ring is exactly the killed run's at that snapshot
            payload["window"] = self.window_ring.payload()
        return payload

    def _validate_payload(self, payload: Dict[str, Any]) -> None:
        """``CheckpointStore.latest`` hook: raise ``StateRestoreError`` for a
        payload this evaluator cannot resume from. Restores the metric as a
        side effect when valid — ``load_checkpoint`` is validate-ALL-then-
        apply, so a raising payload leaves the metric untouched and the
        store's recovery ladder moves on to an older snapshot."""
        missing = [k for k in ("payload_version", "cursor", "checkpoint") if k not in payload]
        if missing:
            raise StateRestoreError(f"runner snapshot is missing key(s) {missing} — truncated payload?")
        version = payload["payload_version"]
        if not isinstance(version, int) or version < 1 or version > RUNNER_PAYLOAD_VERSION:
            raise StateRestoreError(
                f"runner snapshot payload_version {version!r} is not supported"
                f" (this build reads <= {RUNNER_PAYLOAD_VERSION})"
            )
        cursor = payload["cursor"]
        if not isinstance(cursor, int) or cursor < 0:
            raise StateRestoreError(f"runner snapshot cursor {cursor!r} is not a non-negative int")
        kind = self._kind()
        if payload.get("kind") != kind:
            raise StateRestoreError(
                f"runner snapshot was written for a {payload.get('kind')!r} target, this"
                f" evaluator wraps a {kind!r}"
            )
        ring_parts = None
        if self.window_ring is None and "window" in payload:
            raise StateRestoreError(
                "runner snapshot carries a window-ring payload but this evaluator has no"
                " window_ring attached — resuming would silently DROP the closed windows"
                " (and the next snapshot would erase them from the store); attach the ring"
                " or point at an un-windowed store"
            )
        if self.window_ring is not None:
            if "window" not in payload:
                raise StateRestoreError(
                    "runner snapshot carries no window-ring payload but this evaluator has a"
                    " window_ring attached — the snapshot came from an un-windowed run"
                )
            # validate WITHOUT applying: if the metric checkpoint below is
            # rejected, the live ring must not be left holding this
            # snapshot's closed windows (validate-ALL-then-apply holds
            # across BOTH restores)
            ring_parts = self.window_ring.validated_parts(payload["window"])
        self._restore_checkpoint(payload["checkpoint"])
        if ring_parts is not None:
            self.window_ring.apply_parts(ring_parts)

    def _restore_latest(self) -> int:
        """Restore the newest valid snapshot (if any) and return its cursor (0 without one)."""
        restored = self.store.latest(validate=self._validate_payload) if self.store is not None else None
        if _obs_trace.ENABLED or _obs_live.ENABLED:
            _obs_counters.inc("runner.resume")
        if _obs_trace.ENABLED:
            cursor = 0 if restored is None else int(restored[1]["cursor"])
            _obs_trace.instant("runner.resume", cursor=cursor, restored=restored is not None)
        if restored is None:
            return 0
        _step, payload = restored  # _validate_payload already installed the checkpoint
        if self.fused and self.fused_options.get("mesh") is not None:
            # the snapshot was taken from a mesh plan's fold-back: its states
            # cover every rank, which the format does not record
            from torchmetrics_tpu_torch.parallel.sharded import _walk_metrics

            for _name, member in self._members():
                for _path, m in _walk_metrics(member):
                    m._mesh_replicated = True
        return int(payload["cursor"])

    # -------------------------------------------------------------- snapshot
    def snapshot(self) -> Optional[int]:
        """Persist the current state + cursor now; returns the step written
        (the cursor), or ``None`` without a store / on non-writer ranks / when
        the store already holds this step (idempotent re-snapshot)."""
        if self.store is None or not self.store.is_writer:
            return None  # non-writer ranks skip even the host-copy of the payload
        last = self.store.last_step()
        if last is not None and self.cursor <= last:
            return None
        name = self.store.save(self._payload(), step=self.cursor)
        if name is None:
            return None
        self._last_snapshot_t = time.monotonic()
        if _obs_trace.ENABLED or _obs_live.ENABLED:
            _obs_counters.inc("runner.snapshot")
            self._attribution_boundary()
            try:
                self._snapshot_bytes_last = os.path.getsize(os.path.join(self.store.directory, name))
            except OSError:
                self._snapshot_bytes_last = None
            if self._snapshot_bytes_last is not None:
                # "what would survive a kill" next to "where the run is"
                _obs_counters.set_gauge("runner.snapshot.bytes_last", self._snapshot_bytes_last)
        return self.cursor

    def _attribution_boundary(self) -> None:
        """Refresh the per-metric ``metric.<Class>.state_bytes`` gauges (and
        the cost-ledger registry) at a snapshot boundary, so the live plane
        shows the state-memory footprint next to throughput. Callers guard
        with the trace/live flags."""
        if self._is_plan:
            self.metric.publish_gauges()  # slice.table.* + the plan's state-bytes row
            return
        if self._is_collection():
            for name, member in self.metric.items(keep_base=True, copy_state=False):
                _obs_attr.note_instance(type(member).__name__, name)
                _obs_attr.metric_boundary(member)
        else:
            _obs_attr.metric_boundary(self.metric)

    def _maybe_snapshot(self) -> None:
        if self.store is None:
            return
        if self.snapshot_gate is not None and not self.snapshot_gate():
            return
        due_n = self.snapshot_every_n is not None and self.cursor % self.snapshot_every_n == 0
        due_s = (
            self.snapshot_every_s is not None
            and self._last_snapshot_t is not None
            and time.monotonic() - self._last_snapshot_t >= self.snapshot_every_s
        )
        if due_n or due_s:
            self.snapshot()

    # -------------------------------------------------------------- watchdog
    def _drive_cuda_index(self) -> Optional[int]:
        """The CUDA device index of the driven metric, or ``None`` off the card."""
        members = self._members()
        device = members[0][1].device if members else None
        if device is None or device.type != "cuda":
            return None
        return device.index if device.index is not None else torch.cuda.current_device()

    def _bounded(self, fn: Callable[..., Any], what: str, *args: Any) -> Any:
        """Run ``fn(*args)`` under the watchdog deadline (same daemon-thread
        trade as ``Metric._sync_dist_bounded``: a timed-out step cannot be
        cancelled and its state is poisoned — the caller must treat a
        StallError as fatal for this process and resume in a fresh one).
        The worker runs on the metric's CUDA device. The deadline bounds the
        host's issue time, not the device's work (see the module docstring)."""
        if not self.watchdog_timeout_s:
            return fn(*args)
        box: Dict[str, Any] = {}
        index = self._cuda_index

        def _worker() -> None:
            try:
                if index is None:
                    box["value"] = fn(*args)
                else:
                    with torch.cuda.device(index):
                        box["value"] = fn(*args)
            except BaseException as err:
                box["err"] = err

        thread = threading.Thread(target=_worker, daemon=True, name=f"tm-torch-runner-{what}")
        # published BEFORE the step starts so the live watchdog-margin probe
        # decays across the whole deadline window; NOT cleared on a stall
        self._watchdog_deadline = time.monotonic() + self.watchdog_timeout_s
        thread.start()
        thread.join(self.watchdog_timeout_s)
        if thread.is_alive():
            if _obs_trace.ENABLED or _obs_live.ENABLED:
                _obs_counters.inc("runner.watchdog_stall")
            if _obs_trace.ENABLED:
                _obs_trace.instant("runner.watchdog_stall", what=what, cursor=self.cursor)
            saved = None
            if self.on_stall == "snapshot_then_raise" and self.store is not None:
                saved = self._stall_snapshot()
            raise StallError(
                f"evaluation {what} at batch cursor {self.cursor} exceeded the"
                f" {self.watchdog_timeout_s}s watchdog deadline"
                + (f" — last-good state saved at step {saved}" if saved is not None else "")
                + "; the stalled step cannot be cancelled, resume in a fresh process"
            )
        if "err" in box:
            raise box["err"]
        return box.get("value")

    def _stall_snapshot(self) -> Optional[int]:
        """Persist the pre-stall payload captured before the stalled step —
        NEVER the live metric, which the abandoned worker thread may still be
        mutating."""
        if self._last_good_payload is None:
            return None
        payload = self._last_good_payload
        last = self.store.last_step() if self.store.is_writer else None
        if last is not None and int(payload["cursor"]) <= last:
            return None  # the periodic policy already persisted this step
        if self.store.save(payload, step=int(payload["cursor"])) is None:
            return None
        return int(payload["cursor"])

    # ------------------------------------------------------------------ run
    def run(self, batches: Iterable[Any]) -> Any:
        """Evaluate the stream from batch 0 and return ``compute()``.

        Demands a fresh position: if the store already holds snapshots, this
        raises (use :meth:`resume`, or point the evaluator at a new
        directory) — silently re-running from 0 over a dirty store would
        violate step monotonicity at the first snapshot anyway.
        """
        if self.store is not None and self.store.is_writer and self.store.last_step() is not None:
            raise ValueError(
                f"store {self.store.directory} already holds snapshots up to step"
                f" {self.store.last_step()} — use resume() to continue, or a fresh directory"
            )
        if _obs_trace.ENABLED:
            with _obs_trace.span("runner.run", metric=type(self.metric).__name__):
                return self._drive(batches, skip=0)
        return self._drive(batches, skip=0)

    def resume(self, batches: Iterable[Any]) -> Any:
        """Restore the newest valid snapshot, fast-forward ``batches`` past
        the recorded cursor, evaluate the remainder and return ``compute()``.

        ``batches`` must be the SAME deterministic stream the interrupted run
        consumed (same order, same content) — the exactly-once guarantee is
        relative to the stream, and the fast-forward is positional. On an
        empty (or entirely-invalid) store the evaluation starts from batch 0.
        """
        if _obs_trace.ENABLED:
            with _obs_trace.span("runner.resume", metric=type(self.metric).__name__):
                self.cursor = self._restore_latest()
                return self._drive(batches, skip=self.cursor)
        self.cursor = self._restore_latest()
        return self._drive(batches, skip=self.cursor)

    # ------------------------------------------------------------ live plane
    def _live_probe(self) -> Dict[str, Any]:
        """Sampled by the :mod:`~torchmetrics_tpu_torch.obs.live` publisher
        thread (and every ``/metrics``/``/healthz`` request) while a drive is
        in flight: the exactly-once cursor, snapshot freshness and size, and
        the REAL-TIME watchdog margin (reads of immutable floats and ints)."""
        now = time.monotonic()
        gauges: Dict[str, Any] = {"runner.cursor": self.cursor}
        if self._last_snapshot_t is not None:
            gauges["runner.snapshot.age_s"] = now - self._last_snapshot_t
        if self._snapshot_bytes_last is not None:
            gauges["runner.snapshot.bytes_last"] = self._snapshot_bytes_last
        if self.watchdog_timeout_s:
            gauges["runner.watchdog.timeout_s"] = self.watchdog_timeout_s
            deadline = self._watchdog_deadline
            gauges["runner.watchdog.margin_s"] = self.watchdog_timeout_s if deadline is None else deadline - now
        if self._ewma_sps is not None:
            gauges["runner.throughput.samples_per_s"] = self._ewma_sps
        return gauges

    @staticmethod
    def _batch_size(batch: Any) -> int:
        """Best-effort samples-per-batch for the progress counters: leading
        dim of the first tuple element (the preds), else ``len``, else 1."""
        head = batch[0] if isinstance(batch, tuple) and batch else batch
        try:
            return int(head.shape[0])
        except Exception:
            try:
                return len(head)
            except Exception:
                return 1

    def _record_progress(self, batch: Any) -> None:
        """Per-batch producer: progress counters and the EWMA throughput
        gauge (host clock). Callers guard with the live/trace flags."""
        n = self._batch_size(batch)
        _obs_counters.inc("runner.progress.batches")
        _obs_counters.inc("runner.progress.samples", n)
        # also a registry gauge (not just the live probe) so the cursor rides
        # every published payload, the final flush included
        _obs_counters.set_gauge("runner.cursor", self.cursor)
        now = time.monotonic()
        if self._last_batch_t is not None and now > self._last_batch_t:
            inst = n / (now - self._last_batch_t)
            self._ewma_sps = inst if self._ewma_sps is None else 0.2 * inst + 0.8 * self._ewma_sps
            _obs_counters.set_gauge("runner.throughput.samples_per_s", self._ewma_sps)
        self._last_batch_t = now

    def _register_probes(self, force: bool = False) -> None:
        """Per-instance probe names: two evaluators driving concurrently in
        one process must not clobber (or, on finish, unregister) each
        other's probes. ``force`` registers even with the live plane off (a
        service answers ``/healthz`` itself)."""
        if not (force or _obs_live.ENABLED):
            return
        _obs_live.register_probe(f"runner-{id(self)}", self._live_probe)
        if self.window_ring is not None:
            _obs_live.register_probe(f"window-{id(self)}", self.window_ring.probe)
        if self._is_plan:
            _obs_live.register_probe(f"sliced-{id(self)}", self.metric.live_probe)

    def _unregister_probes(self) -> None:
        for prefix in ("runner", "window", "sliced"):
            _obs_live.unregister_probe(f"{prefix}-{id(self)}")

    def _make_apply(self) -> Callable[[Any], None]:
        """The per-batch step, hoisted to ONE per-drive callable. Fused
        drives build the plan lazily at the first batch, so ``resume()``
        restores state first and the plan's carry seeds from the restored
        members."""
        if self._is_plan:
            plan = self.metric
            return lambda batch: plan.update(*batch) if isinstance(batch, tuple) else plan.update(batch)
        if not self.fused:
            update_fn, metric = self.update_fn, self.metric
            return lambda batch: update_fn(metric, batch)

        def apply_fused(batch: Any) -> None:
            plan = self._fused_plan
            if plan is None:
                plan = self._build_fused_plan(batch)
            if isinstance(batch, tuple):
                plan.update(*batch)
            else:
                plan.update(batch)

        return apply_fused

    def _build_fused_plan(self, batch: Any) -> Any:
        from torchmetrics_tpu_torch.parallel.fused import FusedCollectionPlan

        options = dict(self.fused_options)
        options.setdefault("example_batch", batch if isinstance(batch, tuple) else (batch,))
        self._fused_plan = FusedCollectionPlan(self.metric, **options)
        return self._fused_plan

    def _begin_drive(self, start: int) -> None:
        self.cursor = start
        self._last_snapshot_t = time.monotonic()
        # one plan per drive, built at the first batch; a later drive's plan
        # adopts the first one's captured graphs from the compiled-step cache
        self._fused_plan = None
        self._snapshotting_stalls = bool(
            self.on_stall == "snapshot_then_raise" and self.watchdog_timeout_s
        )
        self._apply_batch = self._make_apply()
        self._cuda_index = self._drive_cuda_index()

    def _step_impl(self, batch: Any) -> None:
        if self._snapshotting_stalls:
            # the stall snapshot must pre-date the (possibly half-applied)
            # stalled update; capture costs one host round-trip per batch
            # (plus a fused fold-back) and is only paid when the policy
            # asks for it
            self._last_good_payload = self._payload()
        self._bounded(self._apply_batch, "update", batch)
        self.cursor += 1
        if _obs_live.ENABLED or _obs_trace.ENABLED:
            self._record_progress(batch)
        if self.window_ring is not None:
            # rotation happens AFTER the batch fully applied and BEFORE
            # its snapshot, so every snapshot's ring is cursor-consistent
            self.window_ring.observe(self.cursor)
        if faults._ACTIVE:  # preemption drill: die after batch k, before its snapshot
            faults.fire("runner.preempt")
        self._maybe_snapshot()

    def _finish_drive(self) -> Any:
        if self._fused_plan is not None:
            # the drive is over: fold the carried totals into the members so
            # the final snapshot AND compute() see them (non-writer ranks
            # never reach _payload, so this fold cannot ride it)
            self._fused_plan.fold_back()
        # final snapshot so a completed pass is restorable/auditable ...
        self.snapshot()
        if self._snapshotting_stalls:
            self._last_good_payload = self._payload()
        # ... then compute (which may sync across the process group) under the
        # same watchdog deadline
        compute = self.metric.compute_all if self._is_plan else self.metric.compute
        result = self._bounded(compute, "compute")
        if _obs_trace.ENABLED:
            # the evaluation is over: every plane is final; emit the cost
            # ledger (covers custom update_fn targets too, newest write wins)
            _obs_attr.maybe_emit()
        return result

    def _drive(self, batches: Iterable[Any], skip: int) -> Any:
        if _obs_live.ENABLED:
            self._register_probes()
            try:
                return self._drive_impl(batches, skip)
            finally:
                self._unregister_probes()
        return self._drive_impl(batches, skip)

    def _drive_impl(self, batches: Iterable[Any], skip: int) -> Any:
        self._begin_drive(skip)
        stream = iter(batches)
        skipped = 0
        while skipped < skip:
            try:
                next(stream)
            except StopIteration:
                raise ValueError(
                    f"cannot fast-forward: the stream ended after {skipped} batch(es) but the"
                    f" snapshot cursor is {skip} — resume() needs the same stream the"
                    " interrupted run consumed"
                ) from None
            skipped += 1
        for batch in stream:
            self._step_impl(batch)
        return self._finish_drive()

    # --------------------------------------------------------- open-loop serve
    def serve_open(self) -> int:
        """Open the evaluator for open-loop (service) driving; returns the
        cursor to serve from.

        Unlike :meth:`resume`, no fast-forward happens: the newest valid
        snapshot (if any) is restored through the same validate-all-then-apply
        ladder, and the CALLER positions its feed at the returned cursor. A
        fresh store opens at 0. Pair every open with :meth:`serve_close`;
        batches arrive one at a time through :meth:`serve_step`.
        """
        start = self._restore_latest()
        self._begin_drive(start)
        # forced: a service's /healthz reads these probes even when the live
        # publisher is off
        self._register_probes(force=True)
        return start

    def serve_step(self, batch: Any) -> None:
        """Apply ONE batch under the drive invariants (watchdog, cadence
        snapshots, fault points) — the service's per-ingest step."""
        self._step_impl(batch)

    def serve_skip(self) -> None:
        """Advance the cursor past ONE batch WITHOUT applying it — the serve
        plane's poison-batch escape hatch. The skipped seq still moves the
        durable watermark (window rotation + cadence snapshot run as if the
        batch had been applied), so a restore after the skip does not ask the
        client to replay the quarantined batch."""
        self.cursor += 1
        if self.window_ring is not None:
            self.window_ring.observe(self.cursor)
        self._maybe_snapshot()

    def serve_close(self) -> Any:
        """Final snapshot + compute; returns :meth:`~SlicedPlan.compute_all`
        for plan targets, ``metric.compute()`` otherwise — the same contract
        as :meth:`run`. Releases the live probes."""
        try:
            return self._finish_drive()
        finally:
            self._unregister_probes()
