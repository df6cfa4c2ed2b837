# An add_state whose reduction is no valid name, and a list state reduced
# by an arithmetic reduction.
# PINNED: ML003 must fire here (and nothing else may).
import torch

from torchmetrics_tpu_torch import Metric


class BadReduction(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="avg")
        self.add_state("rows", [], dist_reduce_fx="mean")

    def update(self, values) -> None:
        self.total = self.total + values.sum()
        self.rows.append(values)

    def compute(self):
        return self.total
