# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Utility layer (counterpart of ``torchmetrics_tpu/utilities``): reductions,
safe math, checks, distributed primitives, rank-zero printing."""
from torchmetrics_tpu_torch.utilities.checks import check_forward_full_state_property
from torchmetrics_tpu_torch.utilities.data import (
    allclose,
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
    select_topk,
    to_categorical,
    to_onehot,
)
from torchmetrics_tpu_torch.utilities.distributed import class_reduce, gather_all_arrays, reduce
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError, TorchMetricsUserWarning
from torchmetrics_tpu_torch.utilities.prints import rank_zero_debug, rank_zero_info, rank_zero_print, rank_zero_warn

__all__ = [
    "check_forward_full_state_property",
    "allclose",
    "dim_zero_cat",
    "dim_zero_max",
    "dim_zero_mean",
    "dim_zero_min",
    "dim_zero_sum",
    "select_topk",
    "to_categorical",
    "to_onehot",
    "class_reduce",
    "gather_all_arrays",
    "reduce",
    "TorchMetricsUserError",
    "TorchMetricsUserWarning",
    "rank_zero_debug",
    "rank_zero_info",
    "rank_zero_print",
    "rank_zero_warn",
]
