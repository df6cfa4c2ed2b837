# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The SNR family (counterpart of ``torchmetrics_tpu/functional/audio/snr.py``)."""
from __future__ import annotations

import torch

from torchmetrics_tpu_torch.functional.audio.sdr import scale_invariant_signal_distortion_ratio
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.data import _to_tensors

Tensor = torch.Tensor


def signal_noise_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """SNR = 10 log10(||target||² / ||target - preds||²)."""
    preds, target = (t.to(torch.float32) for t in _to_tensors(preds, target))
    _check_same_shape(preds, target)
    eps = torch.finfo(preds.dtype).eps
    if zero_mean:
        target = target - torch.mean(target, dim=-1, keepdim=True)
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)
    noise = target - preds
    snr_value = (torch.sum(target**2, dim=-1) + eps) / (torch.sum(noise**2, dim=-1) + eps)
    return 10 * torch.log10(snr_value)


def scale_invariant_signal_noise_ratio(preds: Tensor, target: Tensor) -> Tensor:
    """SI-SNR: SI-SDR with zero mean."""
    return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=True)


def complex_scale_invariant_signal_noise_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """C-SI-SNR over complex STFTs: complex ``(..., frequency, time)`` or
    real ``(..., frequency, time, 2)`` inputs (``torch.view_as_real``)."""
    preds, target = _to_tensors(preds, target)
    if preds.is_complex():
        preds = torch.view_as_real(preds)
    if target.is_complex():
        target = torch.view_as_real(target)
    if preds.ndim < 3 or preds.shape[-1] != 2 or target.ndim < 3 or target.shape[-1] != 2:
        raise RuntimeError(
            "Predictions and targets are expected to have the shape (..., frequency, time, 2),"
            " but got {} and {}.".format(tuple(preds.shape), tuple(target.shape))
        )
    preds = preds.reshape(*preds.shape[:-3], -1)
    target = target.reshape(*target.shape[:-3], -1)
    return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=zero_mean)
