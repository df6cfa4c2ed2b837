# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""BootStrapper wrapper (counterpart of ``torchmetrics_tpu/wrappers/bootstrapping.py``)."""
from __future__ import annotations

from copy import deepcopy
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import _to_tensor
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric, _wrapped_device


def _apply_to_tensors(data: Any, fn: Callable) -> Any:
    """Apply ``fn`` to every tensor or array leaf in args/kwargs collections."""
    if isinstance(data, (torch.Tensor, np.ndarray)):
        return fn(data)
    if isinstance(data, tuple):
        return tuple(_apply_to_tensors(d, fn) for d in data)
    if isinstance(data, list):
        return [_apply_to_tensors(d, fn) for d in data]
    if isinstance(data, dict):
        return {k: _apply_to_tensors(v, fn) for k, v in data.items()}
    return data


def _bootstrap_sampler(size: int, sampling_strategy: str = "poisson", rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Resampling indices, drawn on the host with numpy as the JAX package
    draws them: one seed gives the same indices in both packages."""
    rng = rng or np.random.default_rng()
    if sampling_strategy == "poisson":
        n = rng.poisson(1, size=size)
        return np.repeat(np.arange(size), n)
    if sampling_strategy == "multinomial":
        return rng.integers(0, size, size=size)
    raise ValueError("Unknown sampling strategy")


class BootStrapper(WrapperMetric):
    """Bootstrapped confidence intervals for any metric, on the base metric's device.

    Keeps ``num_bootstraps`` copies of the base metric; every ``update``
    resamples the batch (with replacement) along dim 0 for each copy: the
    indices are drawn on the host (``np.random.default_rng(seed)``), uploaded
    once per copy and gathered on the device with ``index_select``.
    """

    full_state_update: Optional[bool] = True

    #: the host RNG draws new indices at every update, which no captured or
    #: sharded step can replay: refused there with the JAX package's reason
    _sharded_update_unsupported = (
        "BootStrapper resamples with a host RNG per update; a traced sharded step "
        "would freeze the resample indices at trace time. Shard the wrapped metric "
        "instead, or run BootStrapper in the replica regime."
    )

    def __init__(
        self,
        base_metric: Metric,
        num_bootstraps: int = 10,
        mean: bool = True,
        std: bool = True,
        quantile: Optional[Union[float, torch.Tensor]] = None,
        raw: bool = False,
        sampling_strategy: str = "poisson",
        seed: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(f"Expected base metric to be an instance of torchmetrics.Metric but received {base_metric}")
        super().__init__(device=_wrapped_device(type(self).__name__, [base_metric], kwargs.pop("device", None)), **kwargs)
        self.metrics = [deepcopy(base_metric) for _ in range(num_bootstraps)]
        self.num_bootstraps = num_bootstraps
        self.mean = mean
        self.std = std
        self.quantile = quantile
        self.raw = raw
        allowed_sampling = ("poisson", "multinomial")
        if sampling_strategy not in allowed_sampling:
            raise ValueError(
                f"Expected argument ``sampling_strategy`` to be one of {allowed_sampling}"
                f" but received {sampling_strategy}"
            )
        self.sampling_strategy = sampling_strategy
        self._rng = np.random.default_rng(seed)

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Resample the batch per bootstrap copy and update it."""
        sizes = []
        _apply_to_tensors(args, lambda a: sizes.append(len(a)))
        _apply_to_tensors(kwargs, lambda a: sizes.append(len(a)))
        if not sizes:
            raise ValueError("None of the input contained tensors, so could not determine the sampling size")
        size = sizes[0]
        device = self._device

        def on_device(a: Any) -> torch.Tensor:
            return _to_tensor(a, device)

        args, kwargs = _apply_to_tensors(args, on_device), _apply_to_tensors(kwargs, on_device)
        for idx in range(self.num_bootstraps):
            sample_idx = _bootstrap_sampler(size, self.sampling_strategy, self._rng)
            if sample_idx.size == 0:
                continue
            index = torch.from_numpy(sample_idx).to(device)  # one upload per copy

            def gather(a: torch.Tensor) -> torch.Tensor:
                return a.index_select(0, index)

            self.metrics[idx].update(*_apply_to_tensors(args, gather), **_apply_to_tensors(kwargs, gather))

    def compute(self) -> Dict[str, torch.Tensor]:
        """Mean, std (ddof=1), quantile (linear interpolation) and raw values over the copies."""
        computed_vals = torch.stack([torch.as_tensor(m.compute()) for m in self.metrics], dim=0)
        output_dict = {}
        if self.mean:
            output_dict["mean"] = computed_vals.mean(dim=0)
        if self.std:
            # two passes, as jnp.std computes it: torch.std's one-pass CUDA reduction read 8.8e-7
            # relative off a float64 reference over 10 copies on an H100
            centered = computed_vals - computed_vals.mean(dim=0)
            output_dict["std"] = ((centered * centered).sum(dim=0) / (computed_vals.shape[0] - 1)).sqrt()
        if self.quantile is not None:
            q = torch.as_tensor(self.quantile, dtype=computed_vals.dtype, device=computed_vals.device)
            output_dict["quantile"] = torch.quantile(computed_vals, q, dim=0, interpolation="linear")
        if self.raw:
            output_dict["raw"] = computed_vals
        return output_dict

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """The ``Metric`` base's forward: update every copy, return the batch value."""
        return super(WrapperMetric, self).forward(*args, **kwargs)

    def reset(self) -> None:
        """Reset every bootstrap copy."""
        for m in self.metrics:
            m.reset()
        super().reset()
