# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Input-transforming wrappers (counterpart of ``torchmetrics_tpu/wrappers/transformations.py``)."""
from __future__ import annotations

from typing import Any, Callable, Optional, Union

import torch

from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import _to_tensor
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric, _wrapped_device


class MetricInputTransformer(WrapperMetric):
    """Base class: transform inputs, forward everything to the wrapped metric
    (or collection), on its device."""

    def __init__(self, wrapped_metric: Union[Metric, MetricCollection], **kwargs: Any) -> None:
        if not isinstance(wrapped_metric, (Metric, MetricCollection)):
            raise TypeError(
                f"Expected wrapped metric to be an instance of `torchmetrics.Metric` or"
                f" `torchmetrics.MetricsCollection`but received {wrapped_metric}"
            )
        super().__init__(device=_wrapped_device(type(self).__name__, [wrapped_metric], kwargs.pop("device", None)), **kwargs)
        self.wrapped_metric = wrapped_metric

    def transform_pred(self, pred: torch.Tensor) -> torch.Tensor:
        """Identity by default."""
        return pred

    def transform_target(self, target: torch.Tensor) -> torch.Tensor:
        """Identity by default."""
        return target

    def _wrap_transform(self, *args: torch.Tensor) -> tuple:
        """Dispatch args to their transform functions."""
        if len(args) == 1:
            return (self.transform_pred(args[0]),)
        if len(args) == 2:
            return self.transform_pred(args[0]), self.transform_target(args[1])
        return (self.transform_pred(args[0]), self.transform_target(args[1]), *args[2:])

    def update(self, *args: torch.Tensor, **kwargs: Any) -> None:
        """Transform, then update."""
        args = self._wrap_transform(*args)
        self.wrapped_metric.update(*args, **kwargs)

    def compute(self) -> Any:
        """Delegate compute."""
        return self.wrapped_metric.compute()

    def forward(self, *args: torch.Tensor, **kwargs: Any) -> Any:
        """Transform, then forward."""
        args = self._wrap_transform(*args)
        return self.wrapped_metric.forward(*args, **kwargs)

    def reset(self) -> None:
        self.wrapped_metric.reset()
        super().reset()


class LambdaInputTransformer(MetricInputTransformer):
    """Transform inputs with user-provided callables."""

    def __init__(
        self,
        wrapped_metric: Union[Metric, MetricCollection],
        transform_pred: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        transform_target: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(wrapped_metric, **kwargs)
        if transform_pred is not None:
            if not callable(transform_pred):
                raise TypeError(f"Expected `transform_pred` to be a Callable but received {transform_pred}")
            self.transform_pred = transform_pred  # type: ignore[method-assign]
        if transform_target is not None:
            if not callable(transform_target):
                raise TypeError(f"Expected `transform_target` to be a Callable but received {transform_target}")
            self.transform_target = transform_target  # type: ignore[method-assign]


class BinaryTargetTransformer(MetricInputTransformer):
    """Threshold targets to {0, 1}."""

    def __init__(self, wrapped_metric: Union[Metric, MetricCollection], threshold: float = 0, **kwargs: Any) -> None:
        super().__init__(wrapped_metric, **kwargs)
        if not isinstance(threshold, (int, float)):
            raise TypeError(f"Expected `threshold` to be a float but received {threshold}")
        self.threshold = threshold

    def transform_target(self, target: torch.Tensor) -> torch.Tensor:
        """Targets above the threshold as int32 ones, the rest zeros (the JAX
        package's dtype, not the int64 of ``.long()``)."""
        return (_to_tensor(target, self._device) > self.threshold).to(torch.int32)
