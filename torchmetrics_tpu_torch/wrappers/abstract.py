# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Abstract base of wrapper metrics (counterpart of ``torchmetrics_tpu/wrappers/abstract.py``)."""
from __future__ import annotations

from typing import Any, Callable

from torchmetrics_tpu_torch.metric import Metric


class WrapperMetric(Metric):
    """Base class of metrics that wrap another metric.

    The wrapped metric does its own synchronization and bookkeeping, so the
    wrapper's ``update`` and ``compute`` run unwrapped.
    """

    def _wrap_update(self, update: Callable) -> Callable:
        return update

    def _wrap_compute(self, compute: Callable) -> Callable:
        return compute

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        raise NotImplementedError
