# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Package metadata: the values of ``torchmetrics_tpu/__about__.py``."""
__version__ = "0.1.0"
__author__ = "TorchMetrics-TPU contributors"
__license__ = "Apache-2.0"
__docs__ = "TPU-native (JAX/XLA/Pallas) machine-learning metrics framework"
