# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""MetricTracker (counterpart of ``torchmetrics_tpu/wrappers/tracker.py``)."""
from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn


def _stack_steps(values: List[Any]) -> torch.Tensor:
    """One value per step stacked along a new first axis; a value that is not a
    tensor or a number (a dict, a tuple of curves) raises ``TypeError``, as
    ``jnp.asarray`` does for it."""
    tensors = []
    for v in values:
        if isinstance(v, torch.Tensor):
            tensors.append(v)
        elif isinstance(v, (bool, int, float, np.ndarray, np.generic)):
            tensors.append(torch.as_tensor(v))
        else:
            raise TypeError(f"cannot stack a {type(v).__name__} value")
    return torch.stack(tensors, dim=0)


class MetricTracker:
    """Track a metric (or collection) over time steps. A plain class, not a ``Metric``.

    ``increment()`` starts a new step by appending a fresh copy of the base
    metric; ``update``/``forward``/``compute`` act on the latest copy;
    ``compute_all``/``best_metric`` aggregate over the history
    (``best_metric`` reads the values to the host).
    """

    def __init__(self, metric: Union[Metric, MetricCollection], maximize: Union[bool, List[bool], None] = True) -> None:
        if not isinstance(metric, (Metric, MetricCollection)):
            raise TypeError(
                "Metric arg need to be an instance of a torchmetrics `Metric` or `MetricCollection`"
                f" but got {metric}"
            )
        self._base_metric = metric
        self._metrics: List[Union[Metric, MetricCollection]] = []

        if maximize is None:
            if isinstance(metric, Metric):
                if getattr(metric, "higher_is_better", None) is None:
                    raise AttributeError(
                        f"The metric '{metric.__class__.__name__}' does not have a 'higher_is_better' attribute."
                        " Please provide the `maximize` argument explicitly."
                    )
                self.maximize: Union[bool, List[bool]] = metric.higher_is_better
            else:
                self.maximize = []
                for name, m in metric.items():
                    if getattr(m, "higher_is_better", None) is None:
                        raise AttributeError(
                            f"The metric '{name}' does not have a 'higher_is_better' attribute."
                            " Please provide the `maximize` argument explicitly."
                        )
                    self.maximize.append(m.higher_is_better)
        else:
            if not isinstance(maximize, (bool, list)):
                raise ValueError("Argument `maximize` should either be a single bool or list of bool")
            if isinstance(maximize, list) and not all(isinstance(m, bool) for m in maximize):
                raise ValueError("Argument `maximize` should be a list of bool")
            if isinstance(maximize, list) and isinstance(metric, MetricCollection) and len(maximize) != len(metric):
                raise ValueError("The len of argument `maximize` should match the length of the metric collection")
            if isinstance(metric, Metric) and not isinstance(maximize, bool):
                raise ValueError("Argument `maximize` should be a single bool when `metric` is a single Metric")
            self.maximize = maximize
        self._increment_called = False

    @property
    def n_steps(self) -> int:
        """Number of tracked steps."""
        return len(self._metrics)

    def increment(self) -> None:
        """Start a new tracking step."""
        self._increment_called = True
        self._metrics.append(deepcopy(self._base_metric))

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Forward on the latest copy."""
        self._check_for_increment("forward")
        return self._metrics[-1](*args, **kwargs)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update the latest copy."""
        self._check_for_increment("update")
        self._metrics[-1].update(*args, **kwargs)

    def compute(self) -> Any:
        """Compute the latest copy."""
        self._check_for_increment("compute")
        return self._metrics[-1].compute()

    def compute_all(self) -> Any:
        """Compute every tracked step."""
        self._check_for_increment("compute_all")
        res = [metric.compute() for metric in self._metrics]
        try:
            if isinstance(self._base_metric, MetricCollection):
                keys = res[0].keys()
                return {k: _stack_steps([r[k] for r in res]) for k in keys}
            return _stack_steps(res)
        except TypeError:  # ragged outputs
            return res

    def reset(self) -> None:
        """Reset the latest copy."""
        if self._metrics:
            self._metrics[-1].reset()

    def reset_all(self) -> None:
        """Reset every tracked copy."""
        for metric in self._metrics:
            metric.reset()

    def best_metric(
        self, return_step: bool = False
    ) -> Union[
        None,
        float,
        Tuple[float, int],
        Tuple[None, None],
        Dict[str, Optional[float]],
        Tuple[Dict[str, Optional[float]], Dict[str, Optional[int]]],
    ]:
        """Best value (and optionally its step) over the history."""
        res = self.compute_all()
        if isinstance(self._base_metric, Metric):
            try:
                arr = _host_array(res)
                idx = int(np.argmax(arr)) if self.maximize else int(np.argmin(arr))
                value = float(arr[idx])
                if return_step:
                    return value, idx
                return value
            except (ValueError, TypeError) as error:
                rank_zero_warn(
                    f"Encountered the following error when trying to get the best metric: {error}"
                    "this is probably due to the 'best' not being defined for this metric."
                    "Returning `None` instead.",
                    UserWarning,
                )
                if return_step:
                    return None, None
                return None
        maximize = self.maximize if isinstance(self.maximize, list) else len(res) * [self.maximize]
        value, idx = {}, {}
        for i, (k, v) in enumerate(res.items()):
            try:
                arr = _host_array(v)
                best = int(np.argmax(arr)) if maximize[i] else int(np.argmin(arr))
                value[k] = float(arr[best])
                idx[k] = best
            except (ValueError, TypeError) as error:
                rank_zero_warn(
                    f"Encountered the following error when trying to get the best metric for metric {k}:"
                    f"{error} this is probably due to the 'best' not being defined for this metric."
                    "Returning `None` instead.",
                    UserWarning,
                )
                value[k], idx[k] = None, None
        if return_step:
            return value, idx
        return value

    def _check_for_increment(self, method: str) -> None:
        """Guard against use before ``increment``."""
        if not self._increment_called:
            raise ValueError(f"`{method}` cannot be called before `.increment()` has been called.")

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        """Plot the tracked values over the steps."""
        from torchmetrics_tpu_torch.utilities.plot import plot_single_or_multi_val

        val = val if val is not None else self.compute_all()
        return plot_single_or_multi_val(val, ax=ax, name=self.__class__.__name__)


def _host_array(value: Any) -> np.ndarray:
    """A tracked value on the host (``.cpu()``); a list of per-step values
    that do not stack raises ``ValueError``, as ``np.asarray`` does."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray([v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v for v in value])
