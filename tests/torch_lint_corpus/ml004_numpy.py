# numpy on a device tensor inside update: a host copy (or an error for a
# CUDA tensor) where torch has the same op.
# PINNED: ML004 must fire here (and nothing else may).
import numpy as np
import torch

from torchmetrics_tpu_torch import Metric

Tensor = torch.Tensor


class NumpyInUpdate(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, values: Tensor) -> None:
        self.total = self.total + np.sum(values)

    def compute(self):
        return self.total
