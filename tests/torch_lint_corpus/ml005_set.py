# Child metrics held in a set: _walk_metrics cannot traverse an unordered
# container, so the deep snapshot/reset/restore misses them.
# PINNED: ML005 must fire here (and nothing else may).
import torch

from torchmetrics_tpu_torch import Metric


class Child(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, values) -> None:
        self.total = self.total + values.sum()

    def compute(self):
        return self.total


class Parent(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
        self.children_set = {Child()}

    def update(self, values) -> None:
        self.total = self.total + values.sum()

    def compute(self):
        return self.total
