# `torch.bincount` inside update: on a card it reads its input's max on the
# host to size its output.
# PINNED: ML002 must fire here (and nothing else may); the capture fails.
import torch

from torchmetrics_tpu_torch import Metric

Tensor = torch.Tensor
CAPTURES = False


class Fixture(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("hist", torch.zeros(4, dtype=torch.int64), dist_reduce_fx="sum")

    def update(self, x: Tensor) -> None:
        self.hist = self.hist + torch.bincount(x, minlength=4)[:4]

    def compute(self):
        return self.hist


def batches(device):
    gen = torch.Generator().manual_seed(3)
    return [(torch.randint(0, 4, (64,), generator=gen).to(device),) for _ in range(3)]
