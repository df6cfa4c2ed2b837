# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Test-only stream-target factories for the port's serve tests (referenced
by ``module:callable`` path, the same declarative mechanism deployments
use; counterpart of ``tests/unittests/serve/_targets.py``)."""
from __future__ import annotations

import threading
from typing import Any

#: gate for :func:`blocking_accuracy` — tests set it to unstick the update
BLOCK = threading.Event()


def blocking_accuracy(device: Any = "cuda") -> Any:
    """A metric whose first update hangs until :data:`BLOCK` is set — a stand-in
    for a wedged device step, so watchdog-margin health decay is observable."""
    from torchmetrics_tpu_torch.classification import BinaryAccuracy

    metric = BinaryAccuracy(validate_args=False, device=device)
    orig = metric.update

    def update(*args: Any, **kwargs: Any) -> None:
        BLOCK.wait()
        orig(*args, **kwargs)

    metric.update = update
    return metric


def bf16_sum(device: Any = "cuda") -> Any:
    """A ``SumMetric`` narrowed to bfloat16 that narrows its sum again after
    each update, so its state stays bfloat16 (the export's ``"bfloat16"``
    marker)."""
    import torch

    from torchmetrics_tpu_torch import SumMetric

    class Bf16Sum(SumMetric):
        def update(self, value: Any) -> None:
            super().update(value)
            self.sum_value = self.sum_value.to(torch.bfloat16)

    return Bf16Sum(device=device).set_dtype(torch.bfloat16)


def jax_bf16_sum() -> Any:
    """The JAX package's counterpart of :func:`bf16_sum` (tests only)."""
    import jax.numpy as jnp

    from torchmetrics_tpu import SumMetric

    class Bf16Sum(SumMetric):
        def update(self, value: Any) -> None:
            super().update(value)
            self.sum_value = self.sum_value.astype(jnp.bfloat16)

    return Bf16Sum().set_dtype(jnp.bfloat16)
