# A kwargs-only update built inline into a MetricCollection: the fused plan
# passes the batch positionally and refuses the member.
# PINNED: ML007 must fire here (and nothing else may).
import torch

from torchmetrics_tpu_torch import Metric, MetricCollection


class KwOnly(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, *, values=None) -> None:
        self.total = self.total + values.sum()

    def compute(self):
        return self.total


def build():
    return MetricCollection({"kw": KwOnly()})
