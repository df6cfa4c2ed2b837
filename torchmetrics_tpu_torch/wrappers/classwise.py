# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""ClasswiseWrapper (counterpart of ``torchmetrics_tpu/wrappers/classwise.py``)."""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric, _wrapped_device


class ClasswiseWrapper(WrapperMetric):
    """Unwrap a per-class metric vector into a labeled dict, on the wrapped metric's device."""

    def __init__(
        self,
        metric: Metric,
        labels: Optional[List[str]] = None,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        device: Any = None,
    ) -> None:
        if not isinstance(metric, Metric):
            raise ValueError(f"Expected argument `metric` to be an instance of `torchmetrics.Metric` but got {metric}")
        super().__init__(device=_wrapped_device(type(self).__name__, [metric], device))
        self.metric = metric
        if labels is not None and not (isinstance(labels, list) and all(isinstance(lab, str) for lab in labels)):
            raise ValueError(f"Expected argument `labels` to either be `None` or a list of strings but got {labels}")
        self.labels = labels
        if prefix is not None and not isinstance(prefix, str):
            raise ValueError(f"Expected argument `prefix` to either be `None` or a string but got {prefix}")
        self._prefix = prefix
        if postfix is not None and not isinstance(postfix, str):
            raise ValueError(f"Expected argument `postfix` to either be `None` or a string but got {postfix}")
        self._postfix = postfix
        self._update_count = 1

    def _convert_output(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Label each element of the per-class vector."""
        if not self._prefix and not self._postfix:
            prefix = f"{self.metric.__class__.__name__.lower()}_"
            postfix = ""
        else:
            prefix = self._prefix or ""
            postfix = self._postfix or ""
        if self.labels is None:
            return {f"{prefix}{i}{postfix}": val for i, val in enumerate(x)}
        return {f"{prefix}{lab}{postfix}": val for lab, val in zip(self.labels, x)}

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Labeled batch value."""
        return self._convert_output(self.metric(*args, **kwargs))

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Delegate to the wrapped metric."""
        self.metric.update(*args, **kwargs)

    def compute(self) -> Dict[str, torch.Tensor]:
        """Labeled final value."""
        return self._convert_output(self.metric.compute())

    def reset(self) -> None:
        """Reset the wrapped metric."""
        self.metric.reset()
