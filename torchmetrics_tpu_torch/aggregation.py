# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Aggregation metrics (counterpart of ``torchmetrics_tpu/aggregation.py``):
``BaseAggregator`` with its NaN strategies, ``MaxMetric``, ``MinMetric``,
``SumMetric``, ``CatMetric``, the weighted ``MeanMetric`` and the windowed
``RunningMean``/``RunningSum``, and the streaming ``Quantile``/``Median``
over a KLL sketch (a ``dist_reduce_fx="merge"`` state).

Values of any kind (Python scalars, numpy arrays, tensors) become float32
tensors on the metric's device. The ``"ignore"`` and float-imputation
strategies are ``torch.where`` selections, so a CUDA graph captures them.
``"error"`` and ``"warn"`` probe the values on the host, and eagerly drop
the NaN entries with boolean indexing. Inside a fused plan's step (captured
on the card, eager on the CPU) the probe is skipped and NaNs pass unmasked,
as under the JAX package's ``jit``: dropping them would make the value's
shape depend on its data.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.sketch.quantile import kll_error_bound, kll_geometry, kll_init, kll_levels_for, kll_quantile, kll_update
from torchmetrics_tpu_torch.utilities.checks import _in_fused_step, _is_concrete
from torchmetrics_tpu_torch.utilities.data import _to_tensor, dim_zero_cat
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn
from torchmetrics_tpu_torch.wrappers.running import Running

Tensor = torch.Tensor


class BaseAggregator(Metric):
    """Base of the aggregation metrics.

    ``nan_strategy``: ``"error"``, ``"warn"``, ``"ignore"``, ``"disable"`` or
    a float that replaces every NaN.
    """

    is_differentiable = None
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        fn: Union[Callable, str],
        default_value: Union[Tensor, List, float],
        nan_strategy: Union[str, float] = "error",
        state_name: str = "value",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed_nan_strategy = ("error", "warn", "ignore", "disable")
        if nan_strategy not in allowed_nan_strategy and not isinstance(nan_strategy, (int, float)):
            raise ValueError(
                f"Arg `nan_strategy` should either be a float or one of {allowed_nan_strategy} but got {nan_strategy}."
            )
        self.nan_strategy = nan_strategy
        self.add_state(state_name, default=default_value, dist_reduce_fx=fn)
        self.state_name = state_name

    def _cast_and_nan_check_input(
        self, x: Union[float, Tensor], weight: Optional[Union[float, Tensor]] = None
    ) -> Tuple[Tensor, Tensor]:
        """``x`` and its weight (ones by default, broadcast to ``x``) as float32
        on the metric's device, NaNs handled by the strategy."""
        x = _to_tensor(x, self._device).to(torch.float32)
        if isinstance(weight, (int, float)):
            # a Python number fills on the device: no upload, so a CUDA graph captures it
            weight = torch.full_like(x, float(weight))
        elif weight is not None:
            weight = torch.broadcast_to(_to_tensor(weight, self._device).to(torch.float32), x.shape)
        else:
            weight = torch.ones_like(x)
        if self.nan_strategy == "disable":
            return x, weight
        nan_mask = torch.isnan(x)
        if self.nan_strategy in ("error", "warn"):
            if _is_concrete(x) and not _in_fused_step() and bool(nan_mask.any()):
                if self.nan_strategy == "error":
                    raise RuntimeError("Encountered `nan` values in tensor")
                rank_zero_warn("Encountered `nan` values in tensor. Will be removed.", UserWarning)
                x = x[~nan_mask]
                weight = weight[~nan_mask]
            return x, weight
        if self.nan_strategy == "ignore":
            # zero weight and value on the NaN entries
            weight = torch.where(nan_mask, torch.zeros_like(weight), weight)
            x = torch.where(nan_mask, torch.zeros_like(x), x)
            return x, weight
        x = torch.where(nan_mask, torch.full_like(x, float(self.nan_strategy)), x)
        return x, weight

    def update(self, value: Union[float, Tensor]) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def compute(self) -> Tensor:
        return getattr(self, self.state_name)


class MaxMetric(BaseAggregator):
    """Running maximum."""

    full_state_update = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("max", -float("inf"), nan_strategy, state_name="max_value", **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value, _ = self._cast_and_nan_check_input(value)
        if self.nan_strategy == "ignore":
            value = torch.where(torch.isnan(value), torch.full_like(value, -float("inf")), value)
        if value.numel():
            self.max_value = torch.maximum(self.max_value, torch.max(value))


class MinMetric(BaseAggregator):
    """Running minimum."""

    full_state_update = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("min", float("inf"), nan_strategy, state_name="min_value", **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value, _ = self._cast_and_nan_check_input(value)
        if self.nan_strategy == "ignore":
            value = torch.where(torch.isnan(value), torch.full_like(value, float("inf")), value)
        if value.numel():
            self.min_value = torch.minimum(self.min_value, torch.min(value))


class SumMetric(BaseAggregator):
    """Running sum."""

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", 0.0, nan_strategy, state_name="sum_value", **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value, _ = self._cast_and_nan_check_input(value)
        if value.numel():
            self.sum_value = self.sum_value + torch.sum(value)


class CatMetric(BaseAggregator):
    """Every value seen, concatenated."""

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("cat", [], nan_strategy, state_name="value", **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value, _ = self._cast_and_nan_check_input(value)
        if value.numel():
            self.value.append(value)

    def compute(self) -> Union[Tensor, List]:
        return dim_zero_cat(self.value) if isinstance(self.value, list) and self.value else self.value


class MeanMetric(BaseAggregator):
    """Weighted running mean; ``weight`` broadcasts to the value's shape."""

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", 0.0, nan_strategy, state_name="mean_value", **kwargs)
        self.add_state("weight", default=0.0, dist_reduce_fx="sum")

    def update(self, value: Union[float, Tensor], weight: Union[float, Tensor] = 1.0) -> None:
        value, weight = self._cast_and_nan_check_input(value, weight)
        if value.numel() == 0:
            return
        self.mean_value = self.mean_value + torch.sum(value * weight)
        self.weight = self.weight + torch.sum(weight)

    def compute(self) -> Tensor:
        return self.mean_value / self.weight


class Quantile(BaseAggregator):
    """Streaming quantile(s) in bounded memory via a KLL sketch.

    The ``dist_reduce_fx="merge"`` counterpart of ``CatMetric`` plus a
    quantile: the state is a fixed-shape
    :class:`~torchmetrics_tpu_torch.sketch.KLLSketch` (it rides the fused
    plan and the captured step, syncs by pairwise merge and checkpoints like
    any state), and every query's rank error is bounded by ``eps * n``; the
    live bound for the current stream is :meth:`error_bound`.

    Args:
        q: quantile (or sequence of quantiles) in ``[0, 1]`` to report.
        eps: target worst-case rank-error fraction; the sketch geometry is
            sized from it (ignored when ``capacity`` is given).
        max_n: stream length the ``eps`` sizing must hold for.
        capacity/levels: explicit sketch geometry.
        nan_strategy: as every aggregator (``"error"|"warn"|"ignore"|float``);
            ``"ignore"`` drops NaNs on the host, so it cannot run inside a
            fused plan's or a captured step.
    """

    full_state_update = False

    def __init__(
        self,
        q: Union[float, Sequence[float]] = 0.5,
        eps: float = 0.01,
        max_n: float = 1e8,
        capacity: Optional[int] = None,
        levels: Optional[int] = None,
        nan_strategy: Union[str, float] = "warn",
        **kwargs: Any,
    ) -> None:
        q_arr = torch.as_tensor(q, dtype=torch.float32)
        if bool(torch.any((q_arr < 0) | (q_arr > 1))):
            raise ValueError(f"Expected quantile(s) `q` in [0, 1], but got {q}")
        if capacity is None:
            capacity, sized_levels = kll_geometry(eps, max_n)
            levels = sized_levels if levels is None else levels
        elif levels is None:
            # levels come from the GIVEN capacity: a smaller buffer needs MORE
            # levels to absorb max_n before the overflow latch voids the bound
            levels = kll_levels_for(capacity, max_n)
        # built on the CPU; add_state copies the default to the metric's device
        default = kll_init(capacity=capacity, levels=levels, device="cpu")
        super().__init__("merge", default, nan_strategy, state_name="sketch", **kwargs)
        self.q = q_arr.to(self._device)
        self.eps = eps

    def update(self, value: Union[float, Tensor]) -> None:
        if self.nan_strategy == "ignore":
            # a sketch point has no weight channel to zero: dropping NaNs makes
            # the batch's size depend on its values, which only an eager update can do
            value = _to_tensor(value, self._device).to(torch.float32).reshape(-1)
            if _in_fused_step() or not _is_concrete(value):
                raise ValueError(
                    "Quantile(nan_strategy='ignore') cannot run inside a traced update (dropping"
                    " NaNs is data-dependent-shape); use a float imputation strategy or pre-filter"
                )
            value = value[~torch.isnan(value)]
        else:
            value, _ = self._cast_and_nan_check_input(value)
        if value.numel():
            self.sketch = kll_update(self.sketch, value)

    def compute(self) -> Tensor:
        """The ``q``-quantile(s) of everything streamed so far."""
        return kll_quantile(self.sketch, self.q)

    def error_bound(self) -> Tensor:
        """Hard deterministic bound on the rank error of :meth:`compute`
        (``sum_l compactions[l] * 2**l``; divide by ``n`` for the fraction)."""
        return kll_error_bound(self.sketch)

    def _apply(self, fn: Callable[[Tensor], Tensor]) -> None:
        super()._apply(fn)
        self.q = self.q.to(self._device)


class Median(Quantile):
    """Streaming median in bounded memory: ``Quantile(q=0.5)``."""

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__(q=0.5, nan_strategy=nan_strategy, **kwargs)


class RunningMean(Running):
    """Mean over the last ``window`` updates."""

    def __init__(self, window: int = 5, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__(base_metric=MeanMetric(nan_strategy=nan_strategy, **kwargs), window=window)


class RunningSum(Running):
    """Sum over the last ``window`` updates."""

    def __init__(self, window: int = 5, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__(base_metric=SumMetric(nan_strategy=nan_strategy, **kwargs), window=window)


__all__ = [
    "CatMetric",
    "MaxMetric",
    "MeanMetric",
    "Median",
    "MinMetric",
    "Quantile",
    "RunningMean",
    "RunningSum",
    "SumMetric",
]
