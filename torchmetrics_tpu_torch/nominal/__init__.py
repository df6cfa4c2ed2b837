# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Nominal module metrics (counterpart of ``torchmetrics_tpu/nominal``)."""
from torchmetrics_tpu_torch.nominal.metrics import (
    CramersV,
    FleissKappa,
    PearsonsContingencyCoefficient,
    TheilsU,
    TschuprowsT,
)

__all__ = [
    "CramersV",
    "FleissKappa",
    "PearsonsContingencyCoefficient",
    "TheilsU",
    "TschuprowsT",
]
