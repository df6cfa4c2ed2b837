# Clean twin of ml002_item: the same host read, run only where `_is_concrete`
# holds (eager updates), as the port's value checks run.
# PINNED: no rule may fire here; the step captures and replays.
import torch

from torchmetrics_tpu_torch import Metric
from torchmetrics_tpu_torch.utilities.checks import _is_concrete

Tensor = torch.Tensor
CAPTURES = True


class Fixture(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, x: Tensor) -> None:
        if _is_concrete(x) and x.abs().max().item() > 1e6:
            raise ValueError("values out of range")
        self.total = self.total + x.sum()

    def compute(self):
        return self.total


def batches(device):
    gen = torch.Generator().manual_seed(0)
    return [(torch.randn(64, generator=gen).to(device),) for _ in range(3)]
