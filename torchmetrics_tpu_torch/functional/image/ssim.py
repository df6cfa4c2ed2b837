# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""SSIM and multi-scale SSIM (counterpart of ``torchmetrics_tpu/functional/image/ssim.py``).

The five windowed moments of a 2-D batch come from K7
(:func:`~torchmetrics_tpu_torch.ops.window_moments`), the filter JAX runs as
one depthwise convolution over the stacked ``(x, y, x², y², xy)``; the 3-D
branch keeps that convolution (``conv3d``, TF32 off). The cropping is JAX's:
the SSIM mean runs over the whole VALID map and only the contrast map is
cropped by the padding.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.image.helpers import (
    _check_image_pair,
    _gaussian_factors,
    _gaussian_kernel_3d,
    _moments_2d,
    _uniform_factors,
    avg_pool2d,
    avg_pool3d,
    conv3d,
    reduce,
    reflect_pad_2d,
    reflect_pad_3d,
)

Tensor = torch.Tensor


def _ssim_check_inputs(preds, target) -> Tuple[Tensor, Tensor]:
    """Validate shapes/dtypes: 4-D or 5-D (3-D SSIM) batches."""
    return _check_image_pair(preds, target, ndim=(4, 5))


def _window_area(kernel_size: Sequence[int]) -> float:
    """The uniform window's divisor, ``jnp.prod`` of the sides as float32 (small integers: exact).
    Computed on the host: ``torch.prod`` of a CUDA tensor compiles its kernel at run time, the first
    time in a process."""
    return float(math.prod(kernel_size))


def _prod_rows(x: Tensor) -> Tensor:
    """The product over dim 0, row after row (``torch.prod`` on a CUDA tensor compiles at run time)."""
    out = x[0]
    for row in x[1:]:
        out = out * row
    return out


def _ssim_update(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Per-image SSIM."""
    is_3d = preds.ndim == 5
    if not isinstance(kernel_size, Sequence):
        kernel_size = 3 * [kernel_size] if is_3d else 2 * [kernel_size]
    if not isinstance(sigma, Sequence):
        sigma = 3 * [sigma] if is_3d else 2 * [sigma]
    if len(kernel_size) != preds.ndim - 2:
        raise ValueError(
            f"`kernel_size` has dimension {len(kernel_size)}, but expected to be two less that target dimensionality,"
            f" which is: {preds.ndim}"
        )
    if len(kernel_size) not in (2, 3) or len(sigma) not in (2, 3):
        raise ValueError(
            f"Expected `kernel_size` dimension to be 2 or 3. `kernel_size` dimensionality: {len(kernel_size)}"
        )
    if return_full_image and return_contrast_sensitivity:
        raise ValueError("Arguments `return_full_image` and `return_contrast_sensitivity` are mutually exclusive.")
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")

    if data_range is None:
        data_range = torch.maximum(preds.max() - preds.min(), target.max() - target.min())
    elif isinstance(data_range, tuple):
        preds = torch.clamp(preds, data_range[0], data_range[1])
        target = torch.clamp(target, data_range[0], data_range[1])
        data_range = data_range[1] - data_range[0]

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    channel = preds.shape[1]
    dtype = preds.dtype
    device = preds.device
    gauss_kernel_size = [int(3.5 * s + 0.5) * 2 + 1 for s in sigma]

    if gaussian_kernel:
        pad_h = (gauss_kernel_size[0] - 1) // 2
        pad_w = (gauss_kernel_size[1] - 1) // 2
    else:
        pad_h = (kernel_size[0] - 1) // 2
        pad_w = (kernel_size[1] - 1) // 2

    b = preds.shape[0]
    if is_3d:
        pad_d = (kernel_size[2] - 1) // 2
        preds = reflect_pad_3d(preds, pad_d, pad_w, pad_h)
        target = reflect_pad_3d(target, pad_d, pad_w, pad_h)
        kernel = (
            _gaussian_kernel_3d(channel, gauss_kernel_size, sigma, dtype, device)
            if gaussian_kernel
            else torch.ones((channel, 1, *kernel_size), dtype=dtype, device=device)
            / _window_area(kernel_size)
        )
        # the five-way stacked input through one depthwise conv, as JAX computes it
        input_list = torch.cat([preds, target, preds * preds, target * target, preds * target])
        outputs = conv3d(input_list, kernel, groups=channel)
        mu_pred, mu_target, e_pred_sq, e_target_sq, e_pred_target = (outputs[i * b : (i + 1) * b] for i in range(5))
    else:
        preds = reflect_pad_2d(preds, pad_h, pad_w)
        target = reflect_pad_2d(target, pad_h, pad_w)
        col, row = (
            _gaussian_factors(gauss_kernel_size, sigma, dtype, device)
            if gaussian_kernel
            else _uniform_factors(kernel_size, _window_area(kernel_size), dtype, device)
        )
        mu_pred, mu_target, e_pred_sq, e_target_sq, e_pred_target = _moments_2d(preds, target, col, row)

    mu_pred_sq = mu_pred**2
    mu_target_sq = mu_target**2
    mu_pred_target = mu_pred * mu_target
    sigma_pred_sq = torch.clamp(e_pred_sq - mu_pred_sq, min=0.0)
    sigma_target_sq = torch.clamp(e_target_sq - mu_target_sq, min=0.0)
    sigma_pred_target = e_pred_target - mu_pred_target

    upper = 2 * sigma_pred_target.to(dtype) + c2
    lower = (sigma_pred_sq + sigma_target_sq).to(dtype) + c2
    ssim_full = ((2 * mu_pred_target + c1) * upper) / ((mu_pred_sq + mu_target_sq + c1) * lower)

    if return_contrast_sensitivity:
        contrast = upper / lower
        contrast = (
            contrast[..., pad_h:-pad_h, pad_w:-pad_w, pad_d:-pad_d] if is_3d else contrast[..., pad_h:-pad_h, pad_w:-pad_w]
        )
        return ssim_full.reshape(b, -1).mean(-1), contrast.reshape(b, -1).mean(-1)
    if return_full_image:
        return ssim_full.reshape(b, -1).mean(-1), ssim_full
    return ssim_full.reshape(b, -1).mean(-1)


def structural_similarity_index_measure(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """SSIM."""
    preds, target = _ssim_check_inputs(preds, target)
    out = _ssim_update(
        preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2,
        return_full_image, return_contrast_sensitivity,
    )
    if isinstance(out, tuple):
        return reduce(out[0], reduction), out[1]
    return reduce(out, reduction)


def _get_normalized_sim_and_cs(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool,
    sigma: Sequence[float],
    kernel_size: Sequence[int],
    data_range,
    k1: float,
    k2: float,
    normalize: Optional[str] = None,
) -> Tuple[Tensor, Tensor]:
    """Per-scale sim/cs with optional relu normalization."""
    sim, contrast_sensitivity = _ssim_update(
        preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2, return_contrast_sensitivity=True
    )
    if normalize == "relu":
        sim = torch.relu(sim)
        contrast_sensitivity = torch.relu(contrast_sensitivity)
    return sim, contrast_sensitivity


def _multiscale_ssim_update(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = None,
) -> Tensor:
    """Per-image MS-SSIM: SSIM at ``len(betas)`` scales, halved by a 2x2 average pool each time."""
    is_3d = preds.ndim == 5
    if not isinstance(kernel_size, Sequence):
        kernel_size = 3 * [kernel_size] if is_3d else 2 * [kernel_size]
    if not isinstance(sigma, Sequence):
        sigma = 3 * [sigma] if is_3d else 2 * [sigma]
    if preds.shape[-1] < 2 ** len(betas) or preds.shape[-2] < 2 ** len(betas):
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)}, the image height and width dimensions must be"
            f" larger than or equal to {2 ** len(betas)}."
        )
    _betas_div = max(1, (len(betas) - 1)) ** 2
    if preds.shape[-2] // _betas_div <= kernel_size[0] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kernel_size[0]},"
            f" the image height must be larger than {(kernel_size[0] - 1) * _betas_div}."
        )
    if preds.shape[-1] // _betas_div <= kernel_size[1] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kernel_size[1]},"
            f" the image width must be larger than {(kernel_size[1] - 1) * _betas_div}."
        )

    mcs_list: List[Tensor] = []
    sim = None
    for _ in range(len(betas)):
        sim, contrast_sensitivity = _get_normalized_sim_and_cs(
            preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2, normalize=normalize
        )
        mcs_list.append(contrast_sensitivity)
        preds = avg_pool3d(preds) if is_3d else avg_pool2d(preds)
        target = avg_pool3d(target) if is_3d else avg_pool2d(target)

    mcs_list[-1] = sim
    mcs_stack = torch.stack(mcs_list)
    if normalize == "simple":
        mcs_stack = (mcs_stack + 1) / 2
    betas_arr = torch.tensor(betas, dtype=torch.float32, device=mcs_stack.device).reshape(-1, 1)
    return _prod_rows(mcs_stack**betas_arr)


def multiscale_structural_similarity_index_measure(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = "relu",
) -> Tensor:
    """MS-SSIM."""
    if not isinstance(betas, tuple) or not all(isinstance(b, float) for b in betas):
        raise ValueError("Argument `betas` is expected to be of a type tuple of floats")
    if normalize is not None and normalize not in ("relu", "simple"):
        raise ValueError("Argument `normalize` to be expected either `None` or one of 'relu' or 'simple'")
    preds, target = _ssim_check_inputs(preds, target)
    mcs = _multiscale_ssim_update(preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2, betas, normalize)
    return reduce(mcs, reduction)
