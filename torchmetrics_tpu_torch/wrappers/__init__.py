# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Wrapper metrics of the port (counterpart of ``torchmetrics_tpu/wrappers/``):
so far the abstract base and the running window; the rest waits for ROADMAP A7c."""
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric
from torchmetrics_tpu_torch.wrappers.running import Running

__all__ = ["Running", "WrapperMetric"]
