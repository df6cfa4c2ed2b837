# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""SpearmanCorrCoef (counterpart of ``torchmetrics_tpu/regression/spearman.py``).

Two regimes:

- **exact** (default): the whole stream stays in ``cat`` states (float32)
  and is ranked at ``compute``;
- **bounded** (``num_bins=``): two KLL sketches (``"merge"`` states) track
  the marginal CDFs, each batch is ranked through the sketch CDF into a
  fixed ``(num_bins, num_bins)`` float32 joint histogram (``"sum"``), and
  compute runs the midrank Spearman formula over the grid. The grid's
  scatter-add of 1.0 is exact below 2**24 per cell, and the grid product
  ``dp @ counts @ dt`` is written as reductions, so it never runs in TF32
  on the card.
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
from torchmetrics_tpu_torch.sketch.quantile import kll_cdf, kll_geometry, kll_init, kll_update
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

Tensor = torch.Tensor


class SpearmanCorrCoef(Metric):
    """Spearman rank correlation, exact or over a bounded state (``num_bins``)."""

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
        self.num_bins = num_bins
        if num_bins is None:
            self.add_state("preds", default=[], dist_reduce_fx="cat")
            self.add_state("target", default=[], dist_reduce_fx="cat")
            return
        if num_outputs != 1:
            raise ValueError(
                "`num_bins` (bounded-state mode) currently supports `num_outputs=1`; run one"
                " metric per output for multioutput streams"
            )
        # the sketch's rank error only needs to resolve below the bin width
        capacity, levels = kll_geometry(eps=min(0.02, 1.0 / num_bins), max_n=1e8)
        self.add_state("preds_sketch", default=kll_init(capacity, levels, device="cpu"), dist_reduce_fx="merge")
        self.add_state("target_sketch", default=kll_init(capacity, levels, device="cpu"), dist_reduce_fx="merge")
        self.add_state("joint", default=torch.zeros((num_bins, num_bins), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Exact: append the batch. Bounded: fold it into the sketches, then
        bin each pair by its rank through the just-updated sketch CDFs."""
        preds, target = self._inputs(preds, target)
        preds, target = _spearman_corrcoef_update(_jnp_dtype(preds), _jnp_dtype(target), self.num_outputs)
        preds, target = preds.to(torch.float32), target.to(torch.float32)
        if self.num_bins is None:
            self.preds.append(preds)
            self.target.append(target)
            return
        self.preds_sketch = kll_update(self.preds_sketch, preds)
        self.target_sketch = kll_update(self.target_sketch, target)
        bins = self.num_bins
        ip = (kll_cdf(self.preds_sketch, preds) * bins).to(torch.int32).clamp(0, bins - 1)
        it = (kll_cdf(self.target_sketch, target) * bins).to(torch.int32).clamp(0, bins - 1)
        flat = (ip.to(torch.int64) * bins + it).reshape(-1)
        ones = torch.ones((), dtype=torch.float32, device=flat.device).expand(flat.numel())
        self.joint = self.joint.reshape(-1).index_add(0, flat, ones).reshape(bins, bins)

    def compute(self) -> Tensor:
        """Exact: rank the whole stream and correlate the ranks. Bounded: the
        midrank Spearman over the joint grid."""
        if self.num_bins is None:
            return _spearman_corrcoef_compute(dim_zero_cat(self.preds), dim_zero_cat(self.target))
        counts = self.joint
        n = torch.sum(counts)
        marg_p = torch.sum(counts, dim=1)
        marg_t = torch.sum(counts, dim=0)
        # midrank of every value in bin b: ranks are 1..n in bin order, and
        # the members of a bin tie at the average of the ranks it spans
        rank_p = torch.cumsum(marg_p, 0) - marg_p + (marg_p + 1.0) / 2.0
        rank_t = torch.cumsum(marg_t, 0) - marg_t + (marg_t + 1.0) / 2.0
        rbar = (n + 1.0) / 2.0
        dp = torch.where(marg_p > 0, rank_p - rbar, 0.0)
        dt = torch.where(marg_t > 0, rank_t - rbar, 0.0)
        # dp @ counts @ dt as column sums and a dot product: reductions, so
        # TF32 never applies on the card
        cov = torch.sum(torch.sum(dp[:, None] * counts, dim=0) * dt)
        var_p = torch.sum(marg_p * dp * dp)
        var_t = torch.sum(marg_t * dt * dt)
        denom = torch.sqrt(var_p * var_t)
        rho = cov / torch.where(denom > 0, denom, 1.0)
        return torch.clamp(torch.where((n > 1) & (denom > 0), rho, float("nan")), -1.0, 1.0)
