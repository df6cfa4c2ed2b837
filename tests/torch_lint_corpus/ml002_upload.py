# `torch.tensor(..., device=...)` inside update: a pageable host-to-device
# copy on every call.
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
        floor = torch.tensor(0.5, dtype=x.dtype, device=x.device)
        self.total = self.total + torch.maximum(x, floor).sum()

    def compute(self):
        return self.total


def batches(device):
    gen = torch.Generator().manual_seed(5)
    return [(torch.randn(64, generator=gen).to(device),) for _ in range(3)]
