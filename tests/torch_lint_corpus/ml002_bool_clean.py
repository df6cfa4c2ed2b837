# Clean twin of ml002_bool: the branch becomes a `torch.where` on the device.
# PINNED: no rule may fire here; the step captures and replays.
import torch

from torchmetrics_tpu_torch import Metric

Tensor = torch.Tensor
CAPTURES = True


class Fixture(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, x: Tensor) -> None:
        total = x.sum()
        self.total = self.total + torch.where(total > 0, total, torch.zeros_like(total))

    def compute(self):
        return self.total


def batches(device):
    gen = torch.Generator().manual_seed(1)
    return [(torch.randn(64, generator=gen).to(device),) for _ in range(3)]
