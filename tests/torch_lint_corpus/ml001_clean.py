# Clean twin of ml001_unregistered: both attributes are registered states.
# PINNED: no rule may fire here.
import torch

from torchmetrics_tpu_torch import Metric


class Registered(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("peak", torch.full((), float("-inf")), dist_reduce_fx="max")

    def update(self, values) -> None:
        self.total = self.total + values.sum()
        self.peak = torch.maximum(self.peak, values.max())

    def compute(self):
        return self.total
