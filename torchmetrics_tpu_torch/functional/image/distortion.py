# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Pan-sharpening distortion indices: D_lambda, D_s, QNR (counterpart of
``torchmetrics_tpu/functional/image/distortion.py``).

JAX runs UQI once per band pair (D_lambda) or per band (D_s); here the pairs
go through one UQI map as channels, one K7 launch for all of them, and each
pair's UQI is the mean of its channel. D_s degrades ``pan`` as JAX does:
the uniform filter, then ``jax.image.resize(..., "bilinear")``, which
antialiases when it downsamples (:func:`~.helpers.resize_bilinear`).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from torchmetrics_tpu_torch.functional.image.helpers import (
    _as_float,
    _check_image_pair,
    _uniform_filter,
    reduce,
    resize_bilinear,
)
from torchmetrics_tpu_torch.functional.image.metrics import _uqi_map
from torchmetrics_tpu_torch.utilities.data import _to_tensor, _to_tensors

Tensor = torch.Tensor


def _band_uqi(x: Tensor, y: Tensor, kernel_size: Sequence[int] = (11, 11), sigma: Sequence[float] = (1.5, 1.5)) -> Tensor:
    """``(C,)``: UQI of each channel pair ``(x[:, c], y[:, c])``, averaged over its batch and pixels."""
    return torch.mean(_uqi_map(x, y, kernel_size, sigma), dim=(0, 2, 3))


def _spectral_distortion_index_update(preds, target) -> Tuple[Tensor, Tensor]:
    """Validate inputs: batch and channel sizes must match, spatial sizes may differ."""
    preds, target = (_as_float(t) for t in _to_tensors(preds, target))
    if preds.dtype != target.dtype:
        raise TypeError(
            f"Expected `ms` and `fused` to have the same data type. Got ms: {preds.dtype} and fused: {target.dtype}."
        )
    if preds.ndim != 4 or target.ndim != 4:
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    if preds.shape[:2] != target.shape[:2]:
        raise ValueError(
            "Expected `preds` and `target` to have same batch and channel sizes."
            f"Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    if not preds.dtype.is_floating_point:
        preds, target = preds.to(torch.float32), target.to(torch.float32)
    return preds, target


def _spectral_distortion_index_compute(preds: Tensor, target: Tensor, p: int = 1, reduction: str = "elementwise_mean") -> Tensor:
    """The band-pair UQI difference matrix, every pair ``k < r`` in one UQI map."""
    length = preds.shape[1]
    m1 = torch.zeros((length, length), dtype=torch.float32, device=preds.device)
    m2 = torch.zeros_like(m1)
    ks, rs = torch.triu_indices(length, length, offset=1, device=preds.device)
    if ks.numel():
        m1[ks, rs] = _band_uqi(target[:, ks], target[:, rs]).to(torch.float32)
        m2[ks, rs] = _band_uqi(preds[:, ks], preds[:, rs]).to(torch.float32)
    m1 = m1 + m1.T
    m2 = m2 + m2.T
    diff = torch.abs(m1 - m2) ** p
    if length == 1:
        output = diff ** (1.0 / p)
    else:
        output = (1.0 / (length * (length - 1)) * torch.sum(diff)) ** (1.0 / p)
    return reduce(output, reduction)


def spectral_distortion_index(preds: Tensor, target: Tensor, p: int = 1, reduction: str = "elementwise_mean") -> Tensor:
    """D_lambda."""
    if not isinstance(p, int) or p <= 0:
        raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
    preds, target = _spectral_distortion_index_update(preds, target)
    return _spectral_distortion_index_compute(preds, target, p, reduction)


def spatial_distortion_index(
    preds: Tensor,
    ms: Tensor,
    pan: Tensor,
    pan_lr: Optional[Tensor] = None,
    norm_order: int = 1,
    window_size: int = 7,
    reduction: str = "elementwise_mean",
) -> Tensor:
    """D_s."""
    preds, pan = _check_image_pair(preds, pan)
    ms = _to_tensor(ms, preds.device).to(preds.dtype)
    if ms.ndim != 4:
        raise ValueError(f"Expected `ms` to have BxCxHxW shape. Got ms: {tuple(ms.shape)}.")
    if preds.shape[:2] != ms.shape[:2]:
        raise ValueError(
            f"Expected `preds` and `ms` to have the same batch and channel sizes."
            f" Got preds: {tuple(preds.shape)} and ms: {tuple(ms.shape)}."
        )
    if not isinstance(norm_order, int) or norm_order <= 0:
        raise ValueError(f"Expected `norm_order` to be a positive integer. Got norm_order: {norm_order}.")
    ms_h, ms_w = ms.shape[-2:]
    if preds.shape[-2] % ms_h != 0 or preds.shape[-1] % ms_w != 0:
        raise ValueError(
            f"Expected height and width of `preds` to be multiple of height and width of `ms`."
            f" Got preds: {tuple(preds.shape)} and ms: {tuple(ms.shape)}."
        )
    if window_size >= ms_h or window_size >= ms_w:
        raise ValueError(f"Expected `window_size` to be smaller than dimension of `ms`. Got window_size: {window_size}.")
    if pan_lr is None:
        pan_degraded = _uniform_filter(pan, window_size=window_size)
        pan_degraded = resize_bilinear(pan_degraded, (ms_h, ms_w))
    else:
        pan_degraded = _to_tensor(pan_lr, preds.device).to(preds.dtype)

    m1 = _band_uqi(ms, pan_degraded)
    m2 = _band_uqi(preds, pan)
    diff = torch.abs(m1 - m2) ** norm_order
    return reduce(diff, reduction) ** (1 / norm_order)


def quality_with_no_reference(
    preds: Tensor,
    ms: Tensor,
    pan: Tensor,
    pan_lr: Optional[Tensor] = None,
    alpha: float = 1.0,
    beta: float = 1.0,
    norm_order: int = 1,
    window_size: int = 7,
    reduction: str = "elementwise_mean",
) -> Tensor:
    """QNR = (1 - D_lambda)^alpha * (1 - D_s)^beta."""
    if not isinstance(alpha, (int, float)) or alpha < 0:
        raise ValueError(f"Expected `alpha` to be a non-negative real number. Got alpha: {alpha}.")
    if not isinstance(beta, (int, float)) or beta < 0:
        raise ValueError(f"Expected `beta` to be a non-negative real number. Got beta: {beta}.")
    d_lambda = spectral_distortion_index(preds, ms, norm_order, reduction)
    d_s = spatial_distortion_index(preds, ms, pan, pan_lr, norm_order, window_size, reduction)
    return (1 - d_lambda) ** alpha * (1 - d_s) ** beta
