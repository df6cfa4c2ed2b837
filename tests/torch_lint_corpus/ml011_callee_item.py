# A host read one call away: update itself is clean, but the helper it calls
# reads the tensor with `.item()`, which ends the capture all the same.
# PINNED: ML011 must fire here (and nothing else may); the capture fails.
import torch

from torchmetrics_tpu_torch import Metric

CAPTURES = False


def _normalize(v):
    scale = v.abs().sum().item()
    return v / scale


class Fixture(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, x) -> None:
        self.total = self.total + _normalize(x).sum()

    def compute(self):
        return self.total


def batches(device):
    gen = torch.Generator().manual_seed(6)
    return [(torch.randn(64, generator=gen).to(device),) for _ in range(3)]
