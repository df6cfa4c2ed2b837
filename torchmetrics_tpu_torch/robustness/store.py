# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Durable, atomic, self-verifying checkpoint store (counterpart of
``torchmetrics_tpu/robustness/store.py``).

A :class:`CheckpointStore` owns one directory of snapshots (see
:mod:`~torchmetrics_tpu_torch.robustness.store_format` for the on-disk
contract, the same as the JAX package's: either package reads the other's
stores) and guarantees:

- **Atomicity** — every snapshot and every manifest update lands via
  temp-file + fsync + ``os.replace``; a preemption at ANY instruction leaves
  the store readable (a crash between temp and rename leaves debris the
  manifest never references — a "torn write").
- **Integrity** — each payload's CRC32 and byte count ride in the manifest;
  bitrot and truncation are detected at read time, not merged into results.
- **Monotonic recovery** — steps strictly increase, and :meth:`latest` walks
  newest→oldest, skipping torn/corrupt/missing/invalid snapshots with one
  named :class:`~torchmetrics_tpu_torch.utilities.exceptions.CheckpointStoreWarning`
  each, returning the newest snapshot that passes BOTH the file-level checks
  and the caller's semantic validation (typically ``Metric.load_checkpoint``'s
  validate-all-then-apply, which raises ``StateRestoreError`` without
  half-restoring).
- **Rank-awareness** — in an initialised ``torch.distributed`` group only
  ``write_rank`` (default rank 0) persists; other ranks' :meth:`save`
  calls are no-ops, so replicated evaluations don't trample one directory.
  Pass ``write_rank=None`` (every rank writes — give each its own directory)
  for replica-regime metrics whose per-rank states differ.

Inspect a store without a Python process that can import torch with
``python tools/metricdoctor.py verify|list|prune <dir>``.
"""
from __future__ import annotations

import errno
import os
import pickle
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

from torchmetrics_tpu_torch.obs import counters as _obs_counters
from torchmetrics_tpu_torch.obs import live as _obs_live
from torchmetrics_tpu_torch.obs import trace as _obs_trace
from torchmetrics_tpu_torch.robustness import faults
from torchmetrics_tpu_torch.robustness import store_format as _fmt
from torchmetrics_tpu_torch.utilities.exceptions import CheckpointStoreWarning, StateRestoreError

__all__ = ["CheckpointStore"]


def _process_index() -> int:
    """This process's rank in the default ``torch.distributed`` group, else 0."""
    return faults._rank()


class CheckpointStore:
    """Atomic snapshot store for one evaluation's checkpoint payloads.

    Args:
        directory: store root; created on first write.
        keep_last: retention — after every save, only the newest ``keep_last``
            snapshots survive (``None`` keeps everything).
        fingerprint: optional registry fingerprint pinned into the manifest;
            a later :meth:`save` or :meth:`latest` against a store written
            with a DIFFERENT fingerprint raises :class:`StateRestoreError`
            naming both (metric definition drift).
        write_rank: the ``torch.distributed`` rank that persists snapshots
            (default 0); ``None`` makes every rank a writer.
    """

    def __init__(
        self,
        directory: str,
        keep_last: Optional[int] = 3,
        fingerprint: Optional[str] = None,
        write_rank: Optional[int] = 0,
    ) -> None:
        if keep_last is not None and keep_last < 1:
            raise ValueError(f"keep_last must be >= 1 (or None to keep everything), got {keep_last}")
        self.directory = str(directory)
        self.keep_last = keep_last
        self.fingerprint = fingerprint
        self.write_rank = write_rank

    # ------------------------------------------------------------------ misc
    @property
    def is_writer(self) -> bool:
        """Whether THIS process persists snapshots (rank-aware gate)."""
        return self.write_rank is None or _process_index() == self.write_rank

    def _manifest(self) -> Dict[str, Any]:
        manifest = _fmt.read_manifest(self.directory)
        if manifest is None:
            return _fmt.empty_manifest(self.fingerprint)
        if (
            self.fingerprint is not None
            and manifest["fingerprint"] is not None
            and manifest["fingerprint"] != self.fingerprint
        ):
            raise StateRestoreError(
                f"checkpoint store {self.directory} was written with registry fingerprint"
                f" {manifest['fingerprint']}, this evaluation declares {self.fingerprint} —"
                " the metric definition changed; start a fresh store directory"
            )
        return manifest

    def steps(self) -> List[int]:
        """Manifest snapshot steps, ascending (no file-level validation)."""
        return [int(e["step"]) for e in self._manifest()["snapshots"]]

    def last_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def verify(self) -> Dict[str, Any]:
        """Full integrity report (see :func:`store_format.verify_store`)."""
        return _fmt.verify_store(self.directory)

    # ------------------------------------------------------------------ save
    def save(self, payload: Dict[str, Any], step: int) -> Optional[str]:
        """Persist ``payload`` (a plain picklable dict) as the snapshot at
        ``step``; returns the file name, or ``None`` on non-writer ranks.

        Steps are strictly monotonic per store: saving at ``step <=`` the
        newest manifest step raises. The snapshot file is published before
        the manifest references it, so every manifest entry always points at
        a fully-written file.
        """
        if not self.is_writer:
            return None
        if _obs_trace.ENABLED:
            with _obs_trace.span("robustness.store.save", step=step):
                return self._save(payload, step)
        return self._save(payload, step)

    def _save(self, payload: Dict[str, Any], step: int) -> str:
        step = int(step)
        manifest = self._manifest()
        last = manifest["snapshots"][-1]["step"] if manifest["snapshots"] else None
        if last is not None and step <= int(last):
            raise ValueError(
                f"snapshot steps must be strictly monotonic: store {self.directory} is at"
                f" step {last}, refusing step {step}"
            )
        os.makedirs(self.directory, exist_ok=True)
        data = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        crc = _fmt.payload_crc(data)
        if faults._ACTIVE:
            # bitrot drill: the manifest records the TRUE crc, the file gets
            # the mangled bytes — exactly what at-rest corruption looks like
            data = faults.mutate_bytes("store.payload", data)
        name = _fmt.snapshot_filename(step)
        path = os.path.join(self.directory, name)
        # torn-write drill: crash between the temp write and the rename. The
        # real atomic_write keeps temp+rename inseparable, so the drill plants
        # the temp file itself and dies where a preempted process would.
        if faults._ACTIVE:
            try:
                faults.fire("store.write.torn")
            except BaseException:
                with open(path + ".tmp-torn", "wb") as fh:
                    fh.write(data)
                raise
            # disk-exhaustion drill: a full filesystem fails the write with
            # ENOSPC before anything lands
            try:
                faults.fire("store.write.enospc")
            except faults.FaultInjected as err:
                raise OSError(errno.ENOSPC, f"injected disk exhaustion: {err}") from None
        _fmt.atomic_write(path, data)
        manifest["snapshots"].append({"step": step, "file": name, "crc32": crc, "bytes": len(data)})
        if manifest["fingerprint"] is None:
            manifest["fingerprint"] = self.fingerprint
        # apply keep_last retention in memory BEFORE the single manifest
        # write (one fsync per save, not two), manifest-first so a crash
        # mid-unlink leaves unreferenced files, never dangling references
        victims: List[Dict[str, Any]] = []
        if self.keep_last is not None and len(manifest["snapshots"]) > self.keep_last:
            victims = manifest["snapshots"][: len(manifest["snapshots"]) - self.keep_last]
            manifest["snapshots"] = manifest["snapshots"][len(manifest["snapshots"]) - self.keep_last:]
        _fmt.write_manifest(self.directory, manifest)
        for entry in victims:
            try:
                os.unlink(os.path.join(self.directory, entry["file"]))
            except OSError:
                pass  # already gone — the manifest no longer references it
        # the store health counters also feed the live plane (obs/live.py):
        # they count when either recorder is on
        if _obs_trace.ENABLED or _obs_live.ENABLED:
            _obs_counters.inc("robustness.store.save")
            _obs_counters.set_gauge("robustness.store.snapshot_bytes", len(data))
        return name

    # ------------------------------------------------------------------ load
    def latest(
        self, validate: Optional[Callable[[Dict[str, Any]], None]] = None
    ) -> Optional[Tuple[int, Dict[str, Any]]]:
        """The newest valid snapshot as ``(step, payload)``, or ``None``.

        Walks the manifest newest→oldest. A snapshot is skipped — with one
        :class:`CheckpointStoreWarning` naming the step and the defect — when
        its file is missing (deleted), its size/CRC32 disagree with the
        manifest (torn content, bitrot), it fails to unpickle, or the
        caller's ``validate(payload)`` hook raises ``StateRestoreError``
        (schema drift, truncated dict). The recovery ladder therefore never
        half-restores: it returns the newest snapshot that is valid END TO
        END, or ``None`` when none is.
        """
        if _obs_trace.ENABLED or _obs_live.ENABLED:
            _obs_counters.inc("robustness.store.load")
        if _obs_trace.ENABLED:
            with _obs_trace.span("robustness.store.load"):
                return self._latest(validate)
        return self._latest(validate)

    def _latest(self, validate: Optional[Callable[[Dict[str, Any]], None]]) -> Optional[Tuple[int, Dict[str, Any]]]:
        manifest = self._manifest()
        for entry in reversed(manifest["snapshots"]):
            step = int(entry["step"])
            try:
                data = _fmt.read_snapshot_bytes(self.directory, entry)
            except FileNotFoundError:
                self._skip(step, "manifest points at a deleted snapshot file")
                continue
            except (OSError, _fmt.StoreFormatError) as err:
                self._skip(step, str(err))
                continue
            try:
                payload = pickle.loads(data)
            except Exception as err:
                self._skip(step, f"payload does not unpickle ({type(err).__name__}: {err})")
                continue
            if not isinstance(payload, dict):
                self._skip(step, f"payload is a {type(payload).__name__}, expected a dict")
                continue
            if validate is not None:
                try:
                    validate(payload)
                except StateRestoreError as err:
                    self._skip(step, f"payload fails validation ({err})")
                    continue
            return step, payload
        return None

    def _skip(self, step: int, why: str) -> None:
        if _obs_trace.ENABLED or _obs_live.ENABLED:
            _obs_counters.inc("robustness.store.recovery_skipped")
        warnings.warn(
            f"checkpoint store {self.directory}: skipping snapshot at step {step} — {why};"
            " falling back to the next-newest snapshot",
            CheckpointStoreWarning,
            stacklevel=4,
        )

    # ----------------------------------------------------------------- prune
    def prune(self, keep_last: Optional[int] = None) -> List[str]:
        """Drop snapshots beyond the newest ``keep_last`` (default: the
        store's own retention) plus any torn-write temp debris; returns the
        removed file names. No-op on non-writer ranks."""
        if not self.is_writer:
            return []
        keep = self.keep_last if keep_last is None else keep_last
        manifest = _fmt.read_manifest(self.directory)
        if manifest is None:
            return []
        _, removed = _fmt.prune_entries(self.directory, manifest, keep, drop_temp=True)
        return removed
