# Clean twin of ml003_bad_reduction: a valid reduction and a cat list state.
# PINNED: no rule may fire here.
import torch

from torchmetrics_tpu_torch import Metric


class GoodReduction(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("rows", [], dist_reduce_fx="cat")

    def update(self, values) -> None:
        self.total = self.total + values.sum()
        self.rows.append(values)

    def compute(self):
        return self.total
