# A cat list state on a class that claims its state folds cheaply
# (full_state_update = False): the state grows without bound.
# PINNED: ML006 must fire here (and nothing else may).
from torchmetrics_tpu_torch import Metric


class Unbounded(Metric):
    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("rows", [], dist_reduce_fx="cat")

    def update(self, values) -> None:
        self.rows.append(values)

    def compute(self):
        return self.rows
