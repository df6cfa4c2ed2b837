# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Dice module metric (counterpart of ``torchmetrics_tpu/classification/dice.py``)."""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.classification.dice import (
    _dice_compute,
    _dice_format,
    _dice_update,
    _dice_update_samplewise,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor


class Dice(Metric):
    """Dice score, ``2 tp / (2 tp + fp + fn)``.

    States: per-class float32 tp/fp/fn sums, or, for ``average='samples'``,
    the summed per-sample dice and the sample count. Without ``num_classes``
    the per-class states are sized on the first update from its inputs (a
    host read, once), and that size becomes the defaults ``reset()``
    returns to, as in JAX. Scores ``(N, C, ...)`` give the class count by
    their shape, so a plan built after the first update replays with no
    host read.
    """

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    full_state_update = False

    def __init__(
        self,
        zero_division: float = 0.0,
        num_classes: Optional[int] = None,
        threshold: float = 0.5,
        average: Optional[str] = "micro",
        ignore_index: Optional[int] = None,
        top_k: int = 1,
        **kwargs: Any,
    ) -> None:
        mdmc_average = kwargs.pop("mdmc_average", None)
        multiclass = kwargs.pop("multiclass", None)
        if mdmc_average is not None or multiclass is not None:
            rank_zero_warn(
                "Arguments `mdmc_average` and `multiclass` are accepted for API parity but not implemented:"
                " Dice always uses global (flattened) reduction. Results may differ from the legacy reference"
                " for samplewise mdmc averaging.",
                UserWarning,
            )
        super().__init__(**kwargs)
        allowed_average = ("micro", "macro", "weighted", "samples", "none", None)
        if average not in allowed_average:
            raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")
        self.zero_division = zero_division
        self.num_classes = num_classes
        self.threshold = threshold
        self.average = average
        self.ignore_index = ignore_index
        self.top_k = top_k
        if average == "samples":
            self.add_state("samples_total", 0.0, dist_reduce_fx="sum")
            self.add_state("samples_count", 0.0, dist_reduce_fx="sum")
        else:
            n_states = num_classes if num_classes is not None and num_classes > 2 else 2
            for name in ("tp", "fp", "fn"):
                self.add_state(name, torch.zeros(n_states, dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Fold per-class tp/fp/fn counts (or per-sample dice) into the state."""
        preds, target = self._inputs(preds, target)
        preds_oh, target_oh = _dice_format(preds, target, self.threshold, self.num_classes, self.top_k)
        if self.average == "samples":
            total, count = _dice_update_samplewise(preds_oh, target_oh, self.zero_division, self.ignore_index)
            self.samples_total = self.samples_total + total
            self.samples_count = self.samples_count + count
            return
        tp, fp, fn = _dice_update(preds_oh, target_oh)
        if self.tp.shape != tp.shape:
            # num_classes was not given: size the states from the first batch
            if not bool((self.tp.sum() + self.fp.sum() + self.fn.sum()) == 0):
                raise ValueError(
                    f"Inconsistent number of classes between updates: state has {self.tp.shape[0]}, "
                    f"batch has {tp.shape[0]}. Pass `num_classes` explicitly."
                )
            for name in ("tp", "fp", "fn"):
                self._defaults[name] = torch.zeros_like(tp)
            self.tp, self.fp, self.fn = tp, fp, fn
            return
        self.tp = self.tp + tp
        self.fp = self.fp + fp
        self.fn = self.fn + fn

    def compute(self) -> Tensor:
        """The Dice score."""
        if self.average == "samples":
            return self.samples_total / torch.clamp(self.samples_count, min=1.0)
        return _dice_compute(self.tp, self.fp, self.fn, self.average, self.zero_division, self.ignore_index)


__all__ = ["Dice"]
