# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""MinMaxMetric wrapper (counterpart of ``torchmetrics_tpu/wrappers/minmax.py``)."""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric, _wrapped_device


class MinMaxMetric(WrapperMetric):
    """Track the min and max of a base metric over compute calls.

    As in the JAX package, the bounds are registered states (``dist_reduce_fx``
    min/max): ``reset()`` resets them and they round-trip through
    ``state_dict``. A metric that wraps another never joins a compute group
    (``MetricCollection``), so two of them over different bases stay apart.
    The wrapper lives on its base metric's device.
    """

    full_state_update = True

    def __init__(self, base_metric: Metric, **kwargs: Any) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(f"Expected base metric to be an instance of `torchmetrics.Metric` but received {base_metric}")
        super().__init__(device=_wrapped_device(type(self).__name__, [base_metric], kwargs.pop("device", None)), **kwargs)
        self._base_metric = base_metric
        self.add_state("min_val", float("inf"), dist_reduce_fx="min")
        self.add_state("max_val", float("-inf"), dist_reduce_fx="max")

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Delegate update to the base metric."""
        self._base_metric.update(*args, **kwargs)

    def compute(self) -> Dict[str, torch.Tensor]:
        """The base value and the running min and max over compute calls."""
        val = self._base_metric.compute()
        if not self._is_suitable_val(val):
            raise RuntimeError(f"Returned value from base metric should be a float or scalar tensor, but got {val}.")
        val = val if isinstance(val, torch.Tensor) else torch.tensor(val, dtype=torch.float32, device=self._device)
        # a NaN value keeps the bounds, as jnp.where does (torch.maximum would take the NaN)
        self.max_val = torch.where(self.max_val < val, val, self.max_val)
        self.min_val = torch.where(self.min_val > val, val, self.min_val)
        return {"raw": val, "max": self.max_val, "min": self.min_val}

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """The ``Metric`` base's forward."""
        return super(WrapperMetric, self).forward(*args, **kwargs)

    def reset(self) -> None:
        """Reset the bounds and the base metric."""
        super().reset()
        self._base_metric.reset()

    @staticmethod
    def _is_suitable_val(val: Union[float, torch.Tensor]) -> bool:
        """True for scalars."""
        if isinstance(val, (int, float)):
            return True
        if isinstance(val, torch.Tensor):
            return val.numel() == 1
        if isinstance(val, np.ndarray):
            return val.size == 1
        return False
