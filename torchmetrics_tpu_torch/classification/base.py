# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Task-dispatch base for classification metrics (counterpart of
``torchmetrics_tpu/classification/base.py``): ``Accuracy(task=...)`` and its
kind are ``__new__`` factories returning the task-specific class."""
from __future__ import annotations

from typing import Any

from torchmetrics_tpu_torch.metric import Metric


class _ClassificationTaskWrapper(Metric):
    """Base for task-dispatching classification metrics."""

    def __new__(cls, *args: Any, **kwargs: Any) -> "Metric":
        raise NotImplementedError(f"`{cls.__name__}` must implement `__new__` returning a task-specific metric.")

    def update(self, *args: Any, **kwargs: Any) -> None:
        raise NotImplementedError(f"{self.__class__.__name__} metric does not have an `update` method.")

    def compute(self) -> None:
        raise NotImplementedError(f"{self.__class__.__name__} metric does not have a `compute` method.")
