# A port module that reaches jax at module level through a sibling.
# PINNED: ML010 must fire here (and nothing else may).
import torch

import ml010_jax_backend  # noqa: F401


def total(x):
    return torch.sum(x)
