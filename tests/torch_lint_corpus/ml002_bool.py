# `bool(t)` inside update: the truth value of a device tensor is read on
# the host.
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
        if bool(x.sum() > 0):
            self.total = self.total + x.sum()

    def compute(self):
        return self.total


def batches(device):
    gen = torch.Generator().manual_seed(1)
    return [(torch.randn(64, generator=gen).to(device),) for _ in range(3)]
