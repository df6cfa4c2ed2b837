# An attribute written in update() that add_state never registered: reset,
# snapshots and the fused carry cannot see it.
# PINNED: ML001 must fire here (and nothing else may).
import torch

from torchmetrics_tpu_torch import Metric


class Unregistered(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, values) -> None:
        self.total = self.total + values.sum()
        self.peak = values.max()

    def compute(self):
        return self.total
