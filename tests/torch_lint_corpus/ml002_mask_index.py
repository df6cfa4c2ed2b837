# Boolean-mask indexing inside update: the output is sized by the mask's
# values, which the host reads.
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
        self.total = self.total + x[x > 0].sum()

    def compute(self):
        return self.total


def batches(device):
    gen = torch.Generator().manual_seed(2)
    return [(torch.randn(64, generator=gen).to(device),) for _ in range(3)]
