# Clean twin of ml007_collection: a positional update.
# PINNED: no rule may fire here.
import torch

from torchmetrics_tpu_torch import Metric, MetricCollection


class Positional(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, values) -> None:
        self.total = self.total + values.sum()

    def compute(self):
        return self.total


def build():
    return MetricCollection({"pos": Positional()})
