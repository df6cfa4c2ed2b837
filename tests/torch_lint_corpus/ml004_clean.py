# Clean twin of ml004_numpy: the torch op on the tensor.
# PINNED: no rule may fire here.
import torch

from torchmetrics_tpu_torch import Metric

Tensor = torch.Tensor


class TorchInUpdate(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, values: Tensor) -> None:
        self.total = self.total + torch.sum(values)

    def compute(self):
        return self.total
