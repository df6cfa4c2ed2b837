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

Not ported yet (ROADMAP): ``window_ring=`` and a ``SlicedPlan`` target (A10)
raise ``NotImplementedError``; the trace spans, counters and live probes
(A12) are left out.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

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
        window_ring: not ported yet (ROADMAP A10); anything but ``None`` raises.

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
        if type(metric).__name__ == "SlicedPlan":
            raise NotImplementedError("a SlicedPlan target is not ported yet (ROADMAP A10)")
        if window_ring is not None:
            raise NotImplementedError("window_ring (the windowed plane) is not ported yet (ROADMAP A10)")
        self.metric = metric
        self.store = store
        self.snapshot_every_n = snapshot_every_n
        self.snapshot_every_s = snapshot_every_s
        self.update_fn = update_fn or _default_update
        self.fused = bool(fused)
        self.fused_options = dict(fused_options or {})
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
        if store is not None and store.fingerprint is None:
            # pin the metric's registry fingerprint into the manifest so a
            # drifted metric definition is refused with a NAMED error at the
            # store door, before any snapshot is even read
            store.fingerprint = self._fingerprint()

    # ----------------------------------------------------------- checkpoints
    def _is_collection(self) -> bool:
        from torchmetrics_tpu_torch.collections import MetricCollection

        return isinstance(self.metric, MetricCollection)

    def _kind(self) -> str:
        return "collection" if self._is_collection() else "metric"

    def _members(self) -> List[Tuple[str, Any]]:
        """``(name, metric)`` of every top-level metric the evaluator drives."""
        if self._is_collection():
            return self.metric.items(keep_base=True, copy_state=False)
        return [("", self.metric)]

    def _fingerprint(self) -> str:
        """Registry fingerprint of the wrapped target: the metric's deep
        checkpoint fingerprint, or a digest over every member's for a
        collection (the JAX package's digest, so stores cross over)."""
        from torchmetrics_tpu_torch.robustness.checkpoint import checkpoint_fingerprint

        if self._is_collection():
            import hashlib
            import json

            canon = sorted((name, checkpoint_fingerprint(m)) for name, m in self._members())
            return hashlib.sha256(json.dumps(canon, separators=(",", ":")).encode()).hexdigest()[:16]
        return checkpoint_fingerprint(self.metric)

    def _checkpoint(self) -> Dict[str, Any]:
        if self._is_collection():
            # copy_state=True materializes per-member states out of compute-
            # group aliasing, so each member checkpoints its own (equal) state
            return {name: m.save_checkpoint() for name, m in self.metric.items(keep_base=True, copy_state=True)}
        return self.metric.save_checkpoint()

    def _restore_checkpoint(self, checkpoint: Dict[str, Any]) -> None:
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
        return {
            "payload_version": RUNNER_PAYLOAD_VERSION,
            "cursor": self.cursor,
            "kind": self._kind(),
            "checkpoint": self._checkpoint(),
        }

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
        if "window" in payload:
            raise StateRestoreError(
                "runner snapshot carries a window-ring payload, and window rings are not ported yet"
                " (ROADMAP A10) — resuming would silently DROP the closed windows (and the next"
                " snapshot would erase them from the store); point at an un-windowed store"
            )
        self._restore_checkpoint(payload["checkpoint"])

    def _restore_latest(self) -> int:
        """Restore the newest valid snapshot (if any) and return its cursor (0 without one)."""
        restored = self.store.latest(validate=self._validate_payload) if self.store is not None else None
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
        if self.store.save(self._payload(), step=self.cursor) is None:
            return None
        self._last_snapshot_t = time.monotonic()
        return self.cursor

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
        thread.start()
        thread.join(self.watchdog_timeout_s)
        if thread.is_alive():
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
        return self._drive(batches, skip=0)

    def resume(self, batches: Iterable[Any]) -> Any:
        """Restore the newest valid snapshot, fast-forward ``batches`` past
        the recorded cursor, evaluate the remainder and return ``compute()``.

        ``batches`` must be the SAME deterministic stream the interrupted run
        consumed (same order, same content) — the exactly-once guarantee is
        relative to the stream, and the fast-forward is positional. On an
        empty (or entirely-invalid) store the evaluation starts from batch 0.
        """
        self.cursor = self._restore_latest()
        return self._drive(batches, skip=self.cursor)

    def _make_apply(self) -> Callable[[Any], None]:
        """The per-batch step, hoisted to ONE per-drive callable. Fused
        drives build the plan lazily at the first batch, so ``resume()``
        restores state first and the plan's carry seeds from the restored
        members."""
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
        self._fused_plan = None  # one plan per drive, built at the first batch
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
        return self._bounded(self.metric.compute, "compute")

    def _drive(self, batches: Iterable[Any], skip: int) -> Any:
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
        return start

    def serve_step(self, batch: Any) -> None:
        """Apply ONE batch under the drive invariants (watchdog, cadence
        snapshots, fault points) — the service's per-ingest step."""
        self._step_impl(batch)

    def serve_skip(self) -> None:
        """Advance the cursor past ONE batch WITHOUT applying it — the serve
        plane's poison-batch escape hatch. The skipped seq still moves the
        durable watermark (the cadence snapshot runs as if the batch had been
        applied), so a restore after the skip does not ask the client to
        replay the quarantined batch."""
        self.cursor += 1
        self._maybe_snapshot()

    def serve_close(self) -> Any:
        """Final snapshot + compute; returns ``metric.compute()``, the same
        contract as :meth:`run`."""
        return self._finish_drive()
