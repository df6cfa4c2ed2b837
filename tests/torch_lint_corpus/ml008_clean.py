# Clean twin of ml008_sliced: integer sizing and integer keys.
# PINNED: no rule may fire here.
import torch

from torchmetrics_tpu_torch.parallel import SlicedPlan


def build(metric, n_cohorts):
    return SlicedPlan(metric, num_cells=n_cohorts // 2, example_keys=torch.tensor([1, 2], dtype=torch.int32))
