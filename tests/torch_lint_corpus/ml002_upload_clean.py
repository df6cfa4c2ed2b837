# Clean twin of ml002_upload: the constant stays a Python scalar, which the
# kernel takes as an argument.
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
        self.total = self.total + x.clamp(min=0.5).sum()

    def compute(self):
        return self.total


def batches(device):
    gen = torch.Generator().manual_seed(5)
    return [(torch.randn(64, generator=gen).to(device),) for _ in range(3)]
