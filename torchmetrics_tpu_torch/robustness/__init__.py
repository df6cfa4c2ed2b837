# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Robustness layer of the port (counterpart of ``torchmetrics_tpu/robustness``).

- :mod:`~torchmetrics_tpu_torch.robustness.spec`: per-state specs, the
  registry fingerprint and restore-time validation behind
  ``Metric.load_state_tree``;
- :mod:`~torchmetrics_tpu_torch.robustness.sync_config` /
  :mod:`~torchmetrics_tpu_torch.robustness.faults`: :class:`SyncConfig`
  (timeout, retries, backoff, degrade-to-local) threaded through
  ``Metric.sync()``, and the deterministic fault-injection harness the tests
  drive it with.

Not ported yet (ROADMAP): checkpoints, the durable store and runner (A8),
StateGuard (A11).
"""
from torchmetrics_tpu_torch.robustness import faults
from torchmetrics_tpu_torch.robustness.sync_config import DEFAULT_SYNC_CONFIG, SyncConfig

__all__ = ["DEFAULT_SYNC_CONFIG", "SyncConfig", "faults"]
