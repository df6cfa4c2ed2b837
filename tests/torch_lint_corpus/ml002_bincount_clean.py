# Clean twin of ml002_bincount: the port's `_bincount`, sized by `minlength`
# alone.
# PINNED: no rule may fire here; the step captures and replays.
import torch

from torchmetrics_tpu_torch import Metric
from torchmetrics_tpu_torch.utilities.data import _bincount

Tensor = torch.Tensor
CAPTURES = True


class Fixture(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("hist", torch.zeros(4, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, x: Tensor) -> None:
        self.hist = self.hist + _bincount(x, 4)

    def compute(self):
        return self.hist


def batches(device):
    gen = torch.Generator().manual_seed(3)
    return [(torch.randint(0, 4, (64,), generator=gen).to(device),) for _ in range(3)]
