# Clean twin of ml011_callee_item: the helper keeps the scale on the device.
# PINNED: no rule may fire here; the step captures and replays.
import torch

from torchmetrics_tpu_torch import Metric

CAPTURES = True


def _normalize(v):
    scale = v.abs().sum()
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
