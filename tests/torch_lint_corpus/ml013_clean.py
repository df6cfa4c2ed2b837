# Clean twin of ml013_no_contract: the class registers its domain contract.
# PINNED: no rule may fire here.
import torch

from torchmetrics_tpu_torch import Metric
from torchmetrics_tpu_torch.robustness.guard import ArgSpec, DomainContract

Tensor = torch.Tensor


class Guardable(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def domain_contract(self):
        return DomainContract(args=(ArgSpec(name="preds", finite=True), ArgSpec(name="target", finite=True)), family="fixture")

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.total = self.total + (preds - target).abs().sum()

    def compute(self):
        return self.total
