# A slice table sized by a true division, and float cohort keys.
# PINNED: ML008 must fire here (and nothing else may).
import torch

from torchmetrics_tpu_torch.parallel import SlicedPlan


def build(metric, n_cohorts):
    return SlicedPlan(metric, num_cells=n_cohorts / 2, example_keys=torch.tensor([1.5, 2.5]))
