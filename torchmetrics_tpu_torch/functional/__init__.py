# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Functional metrics of the port: a flat namespace, as the JAX package's."""
from torchmetrics_tpu_torch.functional.classification import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.classification import __all__ as _classification_all
from torchmetrics_tpu_torch.functional.regression import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.regression import __all__ as _regression_all

__all__ = list(_classification_all) + list(_regression_all)
