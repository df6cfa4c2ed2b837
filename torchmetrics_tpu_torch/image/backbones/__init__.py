# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Feature towers of the image metrics (counterpart of ``torchmetrics_tpu/image/backbones``)."""
