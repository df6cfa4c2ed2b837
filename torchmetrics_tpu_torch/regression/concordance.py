# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""ConcordanceCorrCoef (counterpart of ``torchmetrics_tpu/regression/concordance.py``);
it rides the Pearson statistics states."""
from __future__ import annotations

import torch

from torchmetrics_tpu_torch.functional.regression.concordance import _concordance_corrcoef_compute
from torchmetrics_tpu_torch.regression.pearson import PearsonCorrCoef

Tensor = torch.Tensor


class ConcordanceCorrCoef(PearsonCorrCoef):
    """Concordance correlation coefficient, per output."""

    def compute(self) -> Tensor:
        """CCC."""
        return _concordance_corrcoef_compute(*self._merged_states())
