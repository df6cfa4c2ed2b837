# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""SpearmanCorrCoef (counterpart of ``torchmetrics_tpu/regression/spearman.py``).

The exact mode keeps the whole stream in ``cat`` states (float32) and ranks
it at ``compute``. The bounded mode of the JAX package (``num_bins=``)
needs the KLL sketch and its ``"merge"`` sync, which are not ported yet
(ROADMAP A9): asking for it raises.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.regression.spearman import (
    _spearman_corrcoef_compute,
    _spearman_corrcoef_update,
)
from torchmetrics_tpu_torch.functional.regression.utils import _jnp_dtype
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

Tensor = torch.Tensor


class SpearmanCorrCoef(Metric):
    """Spearman rank correlation over the whole stream, per output."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = -1.0
    plot_upper_bound = 1.0

    def __init__(self, num_outputs: int = 1, num_bins: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(num_outputs, int) or num_outputs < 1:
            raise ValueError(f"Expected argument `num_outputs` to be an int larger than 0, but got {num_outputs}")
        self.num_outputs = num_outputs
        if num_bins is not None and (not isinstance(num_bins, int) or num_bins < 2):
            raise ValueError(f"Expected argument `num_bins` to be an int larger than 1 or None, but got {num_bins}")
        if num_bins is not None:
            raise NotImplementedError(
                "SpearmanCorrCoef(num_bins=...) keeps KLL sketches synced by 'merge', which are not ported yet"
                " (ROADMAP A9); leave num_bins=None for the exact mode"
            )
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Append a batch."""
        preds, target = self._inputs(preds, target)
        preds, target = _spearman_corrcoef_update(_jnp_dtype(preds), _jnp_dtype(target), self.num_outputs)
        self.preds.append(preds.to(torch.float32))
        self.target.append(target.to(torch.float32))

    def compute(self) -> Tensor:
        """Rank the whole stream and correlate the ranks."""
        return _spearman_corrcoef_compute(dim_zero_cat(self.preds), dim_zero_cat(self.target))
