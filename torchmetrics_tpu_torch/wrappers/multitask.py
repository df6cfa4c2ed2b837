# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""MultitaskWrapper (counterpart of ``torchmetrics_tpu/wrappers/multitask.py``)."""
from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, Optional, Union

from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric, _wrapped_device


class MultitaskWrapper(WrapperMetric):
    """Route per-task preds/targets dicts to per-task metrics (all on one device)."""

    is_differentiable = False

    def __init__(
        self,
        task_metrics: Dict[str, Union[Metric, MetricCollection]],
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        device: Any = None,
    ) -> None:
        self._check_task_metrics_type(task_metrics)
        super().__init__(device=_wrapped_device(type(self).__name__, list(task_metrics.values()), device))
        self.task_metrics = task_metrics
        self._prefix = prefix or ""
        self._postfix = postfix or ""

    @staticmethod
    def _check_task_metrics_type(task_metrics: Dict[str, Union[Metric, MetricCollection]]) -> None:
        """Validate the metrics dict."""
        if not isinstance(task_metrics, dict):
            raise TypeError(f"Expected argument `task_metrics` to be a dict. Found task_metrics = {task_metrics}")
        for metric in task_metrics.values():
            if not (isinstance(metric, (Metric, MetricCollection))):
                raise TypeError(
                    "Expected each task's metric to be a Metric or a MetricCollection. "
                    f"Found a metric of type {type(metric)}"
                )

    def items(self, flatten: bool = True):
        """Iterate over task-name/metric pairs."""
        for task_name, metric in self.task_metrics.items():
            if flatten and isinstance(metric, MetricCollection):
                for sub_name, sub_metric in metric.items():
                    yield f"{self._prefix}{task_name}_{sub_name}{self._postfix}", sub_metric
            else:
                yield f"{self._prefix}{task_name}{self._postfix}", metric

    def keys(self, flatten: bool = True):
        """Iterate over task names."""
        for name, _ in self.items(flatten=flatten):
            yield name

    def values(self, flatten: bool = True):
        """Iterate over metrics."""
        for _, metric in self.items(flatten=flatten):
            yield metric

    def update(self, task_preds: Dict[str, Any], task_targets: Dict[str, Any]) -> None:
        """Update each task's metric."""
        if not self.task_metrics.keys() == task_preds.keys() == task_targets.keys():
            raise ValueError(
                "Expected arguments `task_preds` and `task_targets` to have the same keys as the wrapped `task_metrics`."
                f" Found task_preds.keys() = {task_preds.keys()}, task_targets.keys() = {task_targets.keys()} "
                f"and self.task_metrics.keys() = {self.task_metrics.keys()}"
            )
        for task_name, metric in self.task_metrics.items():
            pred, target = task_preds[task_name], task_targets[task_name]
            metric.update(pred, target)

    def compute(self) -> Dict[str, Any]:
        """Per-task values."""
        return {f"{self._prefix}{name}{self._postfix}": metric.compute() for name, metric in self.task_metrics.items()}

    def forward(self, task_preds: Dict[str, Any], task_targets: Dict[str, Any]) -> Dict[str, Any]:
        """Per-task batch values while accumulating."""
        return {
            f"{self._prefix}{name}{self._postfix}": metric(task_preds[name], task_targets[name])
            for name, metric in self.task_metrics.items()
        }

    def reset(self) -> None:
        """Reset every task's metric."""
        for metric in self.task_metrics.values():
            metric.reset()
        super().reset()

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MultitaskWrapper":
        """Deep copy with optional new prefix/postfix."""
        multitask_copy = deepcopy(self)
        if prefix is not None:
            multitask_copy._prefix = prefix
        if postfix is not None:
            multitask_copy._postfix = postfix
        return multitask_copy

    def plot(self, val: Any = None, axes: Any = None) -> Any:
        """One plot per task value, on ``axes[i]`` where given."""
        from torchmetrics_tpu_torch.utilities.plot import plot_single_or_multi_val

        if val is None:
            val = self.compute()
        results = []
        for i, (name, sub_val) in enumerate(val.items()):
            ax = axes[i] if axes is not None else None
            results.append(plot_single_or_multi_val(sub_val, ax=ax, name=name))
        return results
