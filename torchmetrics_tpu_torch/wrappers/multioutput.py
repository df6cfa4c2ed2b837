# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""MultioutputWrapper (counterpart of ``torchmetrics_tpu/wrappers/multioutput.py``)."""
from __future__ import annotations

from copy import deepcopy
from typing import Any, List, Tuple

import torch

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import _to_tensor
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric, _wrapped_device
from torchmetrics_tpu_torch.wrappers.bootstrapping import _apply_to_tensors


def _get_nan_indices(*tensors: torch.Tensor) -> torch.Tensor:
    """Rows where any tensor has a NaN."""
    if len(tensors) == 0:
        raise ValueError("Must pass at least one tensor as argument")
    sentinel = tensors[0]
    nan_idxs = torch.zeros(len(sentinel), dtype=torch.bool, device=sentinel.device)
    for tensor in tensors:
        permuted_tensor = tensor.reshape(len(sentinel), -1)
        nan_idxs = nan_idxs | torch.isnan(permuted_tensor).any(dim=1)
    return nan_idxs


class MultioutputWrapper(WrapperMetric):
    """Evaluate one copy of a base metric per output dimension, on the base metric's device.

    With ``remove_nans=True`` the rows holding a NaN are dropped by boolean
    indexing, whose result size the host reads: one device sync per output
    and update.
    """

    is_differentiable = False

    def __init__(
        self,
        base_metric: Metric,
        num_outputs: int,
        output_dim: int = -1,
        remove_nans: bool = True,
        squeeze_outputs: bool = True,
        device: Any = None,
    ) -> None:
        super().__init__(device=_wrapped_device(type(self).__name__, [base_metric], device))
        self.metrics = [deepcopy(base_metric) for _ in range(num_outputs)]
        self.output_dim = output_dim
        self.remove_nans = remove_nans
        self.squeeze_outputs = squeeze_outputs
        # the output indices on the device: each output's select slices one, no upload per update
        self._outputs = torch.arange(num_outputs, device=self._device)
        if remove_nans:
            self._sharded_update_unsupported = (
                "remove_nans=True drops NaN rows with data-dependent boolean indexing, which has no"
                " static shape under a traced step. Construct with remove_nans=False to shard."
            )

    def _get_args_kwargs_by_output(self, *args: Any, **kwargs: Any) -> List[Tuple[tuple, dict]]:
        """Slice args/kwargs per output dim, optionally dropping NaN rows."""
        def on_device(a: Any) -> torch.Tensor:
            return _to_tensor(a, self._device)

        args, kwargs = _apply_to_tensors(args, on_device), _apply_to_tensors(kwargs, on_device)
        args_kwargs_by_output = []
        for i in range(len(self.metrics)):
            index = self._outputs[i : i + 1]

            def select(a: torch.Tensor, index: torch.Tensor = index) -> torch.Tensor:
                return a.index_select(self.output_dim, index)

            selected_args = _apply_to_tensors(args, select)
            selected_kwargs = _apply_to_tensors(kwargs, select)
            if self.remove_nans:
                args_kwargs = tuple(selected_args) + tuple(selected_kwargs.values())
                nan_idxs = _get_nan_indices(*args_kwargs)
                selected_args = tuple(arg[~nan_idxs] for arg in selected_args)
                selected_kwargs = {k: v[~nan_idxs] for k, v in selected_kwargs.items()}
            if self.squeeze_outputs:
                selected_args = tuple(arg.squeeze(self.output_dim) for arg in selected_args)
                selected_kwargs = {k: v.squeeze(self.output_dim) for k, v in selected_kwargs.items()}
            args_kwargs_by_output.append((selected_args, selected_kwargs))
        return args_kwargs_by_output

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update each output's metric."""
        reshaped_args_kwargs = self._get_args_kwargs_by_output(*args, **kwargs)
        for metric, (selected_args, selected_kwargs) in zip(self.metrics, reshaped_args_kwargs):
            metric.update(*selected_args, **selected_kwargs)

    def compute(self) -> torch.Tensor:
        """Stack the per-output values."""
        return torch.stack([torch.as_tensor(m.compute()) for m in self.metrics], 0)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Per-output batch values."""
        reshaped_args_kwargs = self._get_args_kwargs_by_output(*args, **kwargs)
        results = [
            metric(*selected_args, **selected_kwargs)
            for metric, (selected_args, selected_kwargs) in zip(self.metrics, reshaped_args_kwargs)
        ]
        if any(res is None for res in results):
            return None
        return torch.stack([torch.as_tensor(r) for r in results], 0)

    def reset(self) -> None:
        """Reset every per-output metric."""
        for metric in self.metrics:
            metric.reset()
        super().reset()
