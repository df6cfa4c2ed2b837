# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""User-facing exception types (counterpart of ``torchmetrics_tpu/utilities/exceptions.py``)."""


class TorchMetricsUserError(Exception):
    """Error raised when a misuse of the metrics API is detected."""


class StateRestoreError(TorchMetricsUserError):
    """A state tree failed validation against the metric's state registry.

    Raised by :meth:`Metric.load_state_tree` and :func:`interop.state_from_numpy`
    when a tree carries unknown or missing states, a list-vs-array kind
    mismatch, an incompatible dtype or shape, or a registry fingerprint that
    differs from the metric's. The message names the offending state and
    expected-vs-got.
    """


class TorchMetricsUserWarning(UserWarning):
    """Warning raised for recoverable misuses of the metrics API."""


class SyncError(TorchMetricsUserError):
    """Cross-process state synchronization failed.

    Raised by :meth:`Metric.sync` when all attempts are exhausted (see
    :class:`~torchmetrics_tpu_torch.robustness.SyncConfig`), by the object
    gather in ``utilities/distributed.py`` when a payload arrives truncated,
    fails its CRC32 check or does not unpickle (naming the offending rank),
    and by a collective that the process group's backend refuses (naming the
    op and the backend).
    """


class SyncWarning(TorchMetricsUserWarning):
    """Warning raised when a sync failure degrades to local-only state
    (``SyncConfig(on_error="local")``)."""
