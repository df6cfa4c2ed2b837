# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""PESQ (counterpart of ``torchmetrics_tpu/functional/audio/callbacks.py``).

The C ``pesq`` library scores each sample on the host. JAX reaches it
through ``jax.pure_callback``; the port calls it directly, and a CUDA graph
cannot hold it (the module metric says so). Without ``pesq`` installed it
raises ``ModuleNotFoundError`` with JAX's message.
"""
from __future__ import annotations

import numpy as np
import torch

from torchmetrics_tpu_torch.utilities.data import _to_tensors
from torchmetrics_tpu_torch.utilities.imports import _PESQ_AVAILABLE

Tensor = torch.Tensor


def perceptual_evaluation_speech_quality(
    preds: Tensor,
    target: Tensor,
    fs: int,
    mode: str,
    keep_same_device: bool = False,
    n_processes: int = 1,
) -> Tensor:
    """PESQ of each ``(..., time)`` sample by the ``pesq`` library on the host, float32."""
    if not _PESQ_AVAILABLE:
        raise ModuleNotFoundError(
            "PESQ metric requires that pesq is installed. Either install as `pip install torchmetrics[audio]`"
            " or `pip install pesq`."
        )
    if fs not in (8000, 16000):
        raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
    if mode not in ("wb", "nb"):
        raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
    import pesq as pesq_backend

    preds, target = (t.to(torch.float32) for t in _to_tensors(preds, target))
    p = preds.detach().cpu().numpy().reshape(-1, preds.shape[-1])
    t = target.detach().cpu().numpy().reshape(-1, target.shape[-1])
    scores = [pesq_backend.pesq(fs, tt, pp, mode) for pp, tt in zip(p, t)]
    return torch.tensor(np.asarray(scores, np.float32).reshape(tuple(preds.shape[:-1])), device=preds.device)
