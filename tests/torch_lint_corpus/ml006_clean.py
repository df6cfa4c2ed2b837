# Clean twin of ml006_unbounded_cat: the cat state without the claim (the
# documented exact regime).
# PINNED: no rule may fire here.
from torchmetrics_tpu_torch import Metric


class ExactRows(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("rows", [], dist_reduce_fx="cat")

    def update(self, values) -> None:
        self.rows.append(values)

    def compute(self):
        return self.rows
