# `.item()` inside update: the host read syncs the stream, so capturing the
# step ends with the port's capture error.
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
        scale = x.abs().max().item()
        self.total = self.total + x.sum() / scale

    def compute(self):
        return self.total


def batches(device):
    gen = torch.Generator().manual_seed(0)
    return [(torch.randn(64, generator=gen).to(device),) for _ in range(3)]
