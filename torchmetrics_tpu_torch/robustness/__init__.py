# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Robustness layer of the port (counterpart of ``torchmetrics_tpu/robustness``).

- :mod:`~torchmetrics_tpu_torch.robustness.spec`: per-state specs, the
  registry fingerprint and restore-time validation behind
  ``Metric.load_state_tree``;
- :mod:`~torchmetrics_tpu_torch.robustness.checkpoint`: self-validating
  ``Metric.save_checkpoint()`` / ``load_checkpoint()`` dicts, in the JAX
  package's format;
- :mod:`~torchmetrics_tpu_torch.robustness.sync_config` /
  :mod:`~torchmetrics_tpu_torch.robustness.faults`: :class:`SyncConfig`
  (timeout, retries, backoff, degrade-to-local) threaded through
  ``Metric.sync()``, and the deterministic fault-injection harness the tests
  drive it with.

And the durability layer on top:

- :mod:`~torchmetrics_tpu_torch.robustness.store`: :class:`CheckpointStore`:
  atomic (temp + fsync + ``os.replace``), CRC32-verified, retention-pruned,
  rank-aware snapshot directory with a torn/corrupt-skipping ``latest()``
  recovery ladder, on the JAX package's on-disk format
  (:mod:`~torchmetrics_tpu_torch.robustness.store_format`, a stdlib-only
  copy; inspect a store offline with ``tools/metricdoctor.py``);
- :mod:`~torchmetrics_tpu_torch.robustness.runner`: :class:`StreamingEvaluator`:
  preemption-safe evaluation over a batch stream with an exactly-once batch
  cursor, snapshot-every-N/T policies, ``resume()`` fast-forward, a stall
  watchdog and the fused drive.

Not ported yet (ROADMAP): StateGuard (A11).
"""
from torchmetrics_tpu_torch.robustness import faults
from torchmetrics_tpu_torch.robustness.checkpoint import (
    CHECKPOINT_FORMAT_VERSION,
    checkpoint_fingerprint,
    load_checkpoint,
    save_checkpoint,
)
from torchmetrics_tpu_torch.robustness.runner import StreamingEvaluator
from torchmetrics_tpu_torch.robustness.spec import StateSpec, build_state_specs, spec_fingerprint, validate_state_tree
from torchmetrics_tpu_torch.robustness.store import CheckpointStore
from torchmetrics_tpu_torch.robustness.sync_config import DEFAULT_SYNC_CONFIG, SyncConfig

__all__ = [
    "CHECKPOINT_FORMAT_VERSION",
    "CheckpointStore",
    "DEFAULT_SYNC_CONFIG",
    "StateSpec",
    "StreamingEvaluator",
    "SyncConfig",
    "build_state_specs",
    "checkpoint_fingerprint",
    "faults",
    "load_checkpoint",
    "save_checkpoint",
    "spec_fingerprint",
]
