# A float-prediction metric with no domain_contract(): enable_guard() has
# nothing to mask or reject invalid rows with.
# PINNED: ML013 must fire here (and nothing else may).
import torch

from torchmetrics_tpu_torch import Metric

Tensor = torch.Tensor


class Unguardable(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.total = self.total + (preds - target).abs().sum()

    def compute(self):
        return self.total
