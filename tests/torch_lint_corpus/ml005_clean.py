# Clean twin of ml005_set: the children in a list.
# PINNED: no rule may fire here.
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
        self.children_list = [Child()]

    def update(self, values) -> None:
        self.total = self.total + values.sum()

    def compute(self):
        return self.total
