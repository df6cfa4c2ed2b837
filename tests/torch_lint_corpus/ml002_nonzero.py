# `torch.nonzero` inside update: its output is sized by the values.
# PINNED: ML002 must fire here (and nothing else may); the capture fails.
import torch

from torchmetrics_tpu_torch import Metric

Tensor = torch.Tensor
CAPTURES = False


class Fixture(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, x: Tensor) -> None:
        self.total = self.total + x[torch.nonzero(x > 0).reshape(-1)].sum()

    def compute(self):
        return self.total


def batches(device):
    gen = torch.Generator().manual_seed(4)
    return [(torch.randn(64, generator=gen).to(device),) for _ in range(3)]
