# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Abstract base of wrapper metrics (counterpart of ``torchmetrics_tpu/wrappers/abstract.py``)."""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Union

import torch

from torchmetrics_tpu_torch.metric import Metric, _child_device


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


def _wrapped_device(owner: str, children: List[Any], device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """A wrapper's device: that of the metrics it wraps (metrics or
    collections of them). An explicit ``device`` must agree with it."""
    devices = []
    for child in children:
        devices.extend([child.device] if isinstance(child, Metric) else [m.device for m in child.values(copy_state=False)])
    return _child_device(owner, devices, device)
