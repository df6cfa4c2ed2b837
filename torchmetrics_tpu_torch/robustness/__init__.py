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

And the input plane:

- :mod:`~torchmetrics_tpu_torch.robustness.guard`: StateGuard, the domain
  contracts run inside the update step under the ``mask``, ``reject`` and
  ``propagate`` policies, with the verdict counters and the poison latch
  as registered states.
"""
from torchmetrics_tpu_torch.robustness import faults
from torchmetrics_tpu_torch.robustness.checkpoint import (
    CHECKPOINT_FORMAT_VERSION,
    checkpoint_fingerprint,
    load_checkpoint,
    save_checkpoint,
)
from torchmetrics_tpu_torch.robustness.guard import (
    GUARD_POLICIES,
    GUARD_STATES,
    ArgSpec,
    DomainContract,
    GuardVerdict,
    check_batch,
    enable_guard,
    guard_counters,
    guard_ineligibility,
    guarded_policy,
    state_finiteness,
)
from torchmetrics_tpu_torch.robustness.runner import StreamingEvaluator
from torchmetrics_tpu_torch.robustness.spec import StateSpec, build_state_specs, spec_fingerprint, validate_state_tree
from torchmetrics_tpu_torch.robustness.store import CheckpointStore
from torchmetrics_tpu_torch.robustness.sync_config import DEFAULT_SYNC_CONFIG, SyncConfig

__all__ = [
    "CHECKPOINT_FORMAT_VERSION",
    "ArgSpec",
    "CheckpointStore",
    "DEFAULT_SYNC_CONFIG",
    "DomainContract",
    "GUARD_POLICIES",
    "GUARD_STATES",
    "GuardVerdict",
    "StateSpec",
    "StreamingEvaluator",
    "SyncConfig",
    "build_state_specs",
    "check_batch",
    "checkpoint_fingerprint",
    "enable_guard",
    "faults",
    "guard_counters",
    "guard_ineligibility",
    "guarded_policy",
    "load_checkpoint",
    "save_checkpoint",
    "spec_fingerprint",
    "state_finiteness",
]
