# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Shared image helpers (counterpart of ``torchmetrics_tpu/functional/image/helpers.py``).

The Gaussian tables are built as the JAX package builds them (float32,
the outer product of two 1-D tables); the windowed moments kernel (K7,
:mod:`torchmetrics_tpu_torch.ops.window_moments`) and its plain route take
the two 1-D tables themselves (:func:`_gaussian_factors`,
:func:`_uniform_factors`). Every convolution of the image domain goes through
:func:`conv2d`/:func:`conv3d` here, which run cuDNN with TF32 off for the
call (PyTorch lets cuDNN round float32 convolutions to TF32 by default;
JAX's convolutions are float32). The global flag is left as it was.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from torchmetrics_tpu_torch.ops.window_moments import window_moments
from torchmetrics_tpu_torch.utilities.data import _to_tensors

Tensor = torch.Tensor


@contextmanager
def fp32_convolutions() -> Iterator[None]:
    """cuDNN's float32 convolutions in float32 (TF32 off) for the block; the other flags as they are."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(
        enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic, allow_tf32=False
    ):
        yield


def conv2d(x: Tensor, weight: Tensor, bias: Optional[Tensor] = None, stride=1, padding=0, groups: int = 1) -> Tensor:
    """``F.conv2d`` (NCHW cross-correlation) with TF32 off."""
    with fp32_convolutions():
        return F.conv2d(x, weight, bias, stride=stride, padding=padding, groups=groups)


def conv3d(x: Tensor, weight: Tensor, groups: int = 1) -> Tensor:
    """``F.conv3d`` (NCDHW cross-correlation, VALID) with TF32 off."""
    with fp32_convolutions():
        return F.conv3d(x, weight, groups=groups)


def conv_transpose2d(x: Tensor, weight: Tensor, groups: int = 1) -> Tensor:
    """``F.conv_transpose2d`` (the adjoint of a VALID :func:`conv2d`) with TF32 off."""
    with fp32_convolutions():
        return F.conv_transpose2d(x, weight, groups=groups)


def _moments_2d(preds: Tensor, target: Tensor, col: Tensor, row: Tensor) -> Tuple[Tensor, ...]:
    """``(mu_x, mu_y, E[x²], E[y²], E[xy])`` of a padded 2-D batch through K7 under the window
    ``outer(col, row)``, in the inputs' dtype (SSIM's and UQI's filter)."""
    dtype = preds.dtype
    f32 = torch.float32
    out = window_moments(preds.to(f32), target.to(f32), col.to(f32), row.to(f32))
    return tuple(m.to(dtype) for m in out)


def reduce(x: Tensor, reduction: Optional[str]) -> Tensor:
    """``elementwise_mean``/``sum``/``none`` reduction."""
    if reduction == "elementwise_mean" or reduction == "mean":
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    if reduction in (None, "none"):
        return x
    raise ValueError("`reduction` must be 'elementwise_mean'/'mean', 'sum', 'none' or None")


def _gaussian(kernel_size: int, sigma: float, dtype=torch.float32, device=None) -> Tensor:
    """``(1, k)`` 1-D Gaussian table: ``exp(-(d/σ)²/2)`` over ``d = (1-k)/2 .. (k-1)/2``, normalised."""
    dist = torch.arange((1 - kernel_size) / 2, (1 + kernel_size) / 2, 1.0, dtype=dtype, device=device)
    gauss = torch.exp(-torch.pow(dist / sigma, 2) / 2)
    return (gauss / gauss.sum())[None, :]


def _gaussian_factors(
    kernel_size: Sequence[int], sigma: Sequence[float], dtype=torch.float32, device=None
) -> Tuple[Tensor, Tensor]:
    """K7's ``(col, row)`` of the 2-D Gaussian: JAX's ``_gaussian_kernel_2d`` table is their outer product."""
    return _gaussian(kernel_size[0], sigma[0], dtype, device)[0], _gaussian(kernel_size[1], sigma[1], dtype, device)[0]


def _uniform_factors(kernel_size: Sequence[int], area: float, dtype=torch.float32, device=None) -> Tuple[Tensor, Tensor]:
    """K7's ``(col, row)`` of the uniform window ``ones / area``: ``ones(kh) / area`` and ``ones(kw)``."""
    return (
        torch.ones(kernel_size[0], dtype=dtype, device=device) / area,
        torch.ones(kernel_size[1], dtype=dtype, device=device),
    )


def _gaussian_kernel_3d(
    channel: int, kernel_size: Sequence[int], sigma: Sequence[float], dtype=torch.float32, device=None
) -> Tensor:
    """``(C, 1, kh, kw, kd)`` depthwise Gaussian kernel."""
    kx = _gaussian(kernel_size[0], sigma[0], dtype, device)
    ky = _gaussian(kernel_size[1], sigma[1], dtype, device)
    kz = _gaussian(kernel_size[2], sigma[2], dtype, device)
    kernel_xy = kx.T @ ky
    kernel = kernel_xy[:, :, None] * kz[0][None, None, :]
    return kernel.expand(channel, 1, *kernel_size)


def avg_pool2d(x: Tensor, window: int = 2) -> Tensor:
    """Non-overlapping average pool (VALID)."""
    return F.avg_pool2d(x, window, window)


def avg_pool3d(x: Tensor, window: int = 2) -> Tensor:
    return F.avg_pool3d(x, window, window)


def _reflect_axis(x: Tensor, dim: int, pad: int) -> Tensor:
    """``jnp.pad(mode="reflect")`` of one axis: edge-exclusive, and a pad wider
    than the axis reflects again (``F.pad`` refuses that; MS-SSIM's coarsest
    scale can be narrower than its window's padding)."""
    n = x.shape[dim]
    if pad == 0:
        return x
    idx = torch.arange(-pad, n + pad, device=x.device)
    if n == 1:
        idx = torch.zeros_like(idx)
    else:
        idx = torch.remainder(idx, 2 * (n - 1))
        idx = torch.where(idx >= n, 2 * (n - 1) - idx, idx)
    return torch.index_select(x, dim, idx)


def reflect_pad_2d(x: Tensor, pad_h: int, pad_w: int) -> Tensor:
    """Edge-exclusive reflection pad of H by ``pad_h`` and W by ``pad_w``."""
    return _reflect_axis(_reflect_axis(x, 2, pad_h), 3, pad_w)


def reflect_pad_3d(x: Tensor, pad_d: int, pad_w: int, pad_h: int) -> Tensor:
    """Reflection pad of the three spatial dims by ``pad_d``, ``pad_w``, ``pad_h`` in that order (JAX's order)."""
    return _reflect_axis(_reflect_axis(_reflect_axis(x, 2, pad_d), 3, pad_w), 4, pad_h)


def symmetric_pad_2d(x: Tensor, top: int, bottom: int, left: int, right: int) -> Tensor:
    """Edge-inclusive mirror pad (``jnp.pad(mode="symmetric")``) of H and W; each pad at most the axis' size."""
    parts = [x[..., :, :left].flip(3)] if left else []
    parts += [x] + ([x[..., :, x.shape[3] - right :].flip(3)] if right else [])
    x = torch.cat(parts, dim=3)
    parts = [x[..., :top, :].flip(2)] if top else []
    parts += [x] + ([x[..., x.shape[2] - bottom :, :].flip(2)] if bottom else [])
    return torch.cat(parts, dim=2)


def _uniform_filter(x: Tensor, window_size: int) -> Tensor:
    """Scipy-compatible local mean: symmetric padding of ``window//2`` left and
    ``window//2 + window%2 - 1`` right, then a depthwise uniform conv."""
    pad = window_size // 2
    outer = window_size % 2
    x = symmetric_pad_2d(x, pad, pad + outer - 1, pad, pad + outer - 1)
    channels = x.shape[1]
    kernel = torch.ones((channels, 1, window_size, window_size), dtype=x.dtype, device=x.device) / (window_size**2)
    return conv2d(x, kernel, groups=channels)


def _as_float(x: Tensor) -> Tensor:
    """JAX's floating dtypes with 64-bit types off: float64 becomes float32, others stay."""
    return x.to(torch.float32) if x.dtype == torch.float64 else x


def _check_image_pair(preds, target, ndim: Tuple[int, ...] = (4,)) -> Tuple[Tensor, Tensor]:
    """Common dtype/shape validation for full-reference image metrics."""
    preds, target = _to_tensors(preds, target)
    preds, target = _as_float(preds), _as_float(target)
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {preds.dtype} and target: {target.dtype}."
        )
    if preds.shape != target.shape:
        raise ValueError(
            "Expected `preds` and `target` to have the same shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    if preds.ndim not in ndim:
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    if not preds.dtype.is_floating_point:
        preds = preds.to(torch.float32)
        target = target.to(torch.float32)
    return preds, target


def resize_bilinear(x: Tensor, size: Tuple[int, int]) -> Tensor:
    """``jax.image.resize(x, (*x.shape[:2], *size), "bilinear")`` of NCHW images.

    JAX antialiases by default when it downsamples (its triangle kernel is
    widened by the scale), which is ``F.interpolate(..., antialias=True)``'s
    filter; upsampling, both interpolate between the two nearest pixels.
    """
    x = x.to(torch.float32) if not x.dtype.is_floating_point else x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False, antialias=True)
