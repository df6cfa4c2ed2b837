# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Wrapper metrics of the port (counterpart of ``torchmetrics_tpu/wrappers/``):
meta-metrics that wrap a base metric, with the JAX package's names."""
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric
from torchmetrics_tpu_torch.wrappers.bootstrapping import BootStrapper
from torchmetrics_tpu_torch.wrappers.classwise import ClasswiseWrapper
from torchmetrics_tpu_torch.wrappers.feature_share import FeatureShare
from torchmetrics_tpu_torch.wrappers.minmax import MinMaxMetric
from torchmetrics_tpu_torch.wrappers.multioutput import MultioutputWrapper
from torchmetrics_tpu_torch.wrappers.multitask import MultitaskWrapper
from torchmetrics_tpu_torch.wrappers.running import Running
from torchmetrics_tpu_torch.wrappers.tracker import MetricTracker
from torchmetrics_tpu_torch.wrappers.transformations import (
    BinaryTargetTransformer,
    LambdaInputTransformer,
    MetricInputTransformer,
)

__all__ = [
    "WrapperMetric",
    "BootStrapper",
    "ClasswiseWrapper",
    "FeatureShare",
    "MinMaxMetric",
    "MultioutputWrapper",
    "MultitaskWrapper",
    "Running",
    "MetricTracker",
    "BinaryTargetTransformer",
    "LambdaInputTransformer",
    "MetricInputTransformer",
]
