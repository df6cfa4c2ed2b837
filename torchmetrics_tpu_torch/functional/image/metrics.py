# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Pure-math image metrics: PSNR, PSNRB, UQI, ERGAS, SAM, SCC, RASE, RMSE-SW,
TotalVariation, VIF and the image gradients (counterpart of
``torchmetrics_tpu/functional/image/metrics.py``).

UQI, VIF and SCC take their five windowed moments from K7
(:func:`~torchmetrics_tpu_torch.ops.window_moments`): UQI on the reflection
padded pair under a Gaussian window, SCC on the zero-padded high-passed pair
under a uniform window, VIF on the unpadded pair (VALID) under its own
Gaussian at each scale. The other filters (VIF's downsampling, SCC's high
pass, the uniform filter of RMSE-SW and RASE) are plain convolutions with
TF32 off. JAX's quirks are kept: UQI pads H by ``pad_w`` and W by ``pad_h``,
RASE's local mean is scaled by window², PSNRB's block masks are numpy.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.image.helpers import (
    _as_float,
    _check_image_pair,
    _gaussian_factors,
    _moments_2d,
    _uniform_factors,
    _uniform_filter,
    conv2d,
    reduce,
    reflect_pad_2d,
)
from torchmetrics_tpu_torch.ops.window_moments import window_moments
from torchmetrics_tpu_torch.utilities.data import _to_tensor, _to_tensors
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor


def _f32(value, device) -> Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


# ------------------------------------------------------------------- PSNR


def _psnr_update(preds: Tensor, target: Tensor, dim=None) -> Tuple[Tensor, Tensor]:
    """Summed squared error + observation count."""
    if dim is None:
        sum_squared_error = torch.sum((preds - target) ** 2)
        num_obs = _f32(target.numel(), target.device)
        return sum_squared_error, num_obs
    diff = preds - target
    sum_squared_error = torch.sum(diff * diff, dim=dim)
    dim_list = [dim] if isinstance(dim, int) else list(dim)
    kept = [d % target.ndim for d in dim_list]
    num = target.numel() / np.prod([target.shape[d] for d in range(target.ndim) if d not in kept])
    num_obs = torch.full_like(sum_squared_error, num)
    return sum_squared_error, num_obs


def _psnr_compute(
    sum_squared_error: Tensor,
    num_obs: Tensor,
    data_range: Tensor,
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """PSNR from the summed squared error."""
    psnr_base_e = 2 * torch.log(data_range) - torch.log(sum_squared_error / num_obs)
    psnr_vals = psnr_base_e * (10 / torch.log(_f32(base, psnr_base_e.device)))
    return reduce(psnr_vals, reduction)


def peak_signal_noise_ratio(
    preds: Tensor,
    target: Tensor,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
    dim=None,
) -> Tensor:
    """PSNR."""
    preds, target = (_as_float(t) for t in _to_tensors(preds, target))
    if dim is None and reduction != "elementwise_mean":
        rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")
    if data_range is None:
        if dim is not None:
            raise ValueError("The `data_range` must be given when `dim` is not None.")
        data_range = (target.max() - target.min()).to(torch.float32)
    elif isinstance(data_range, tuple):
        preds = torch.clamp(preds, data_range[0], data_range[1])
        target = torch.clamp(target, data_range[0], data_range[1])
        data_range = _f32(data_range[1] - data_range[0], preds.device)
    else:
        data_range = _f32(data_range, preds.device)
    sum_squared_error, num_obs = _psnr_update(preds, target, dim=dim)
    return _psnr_compute(sum_squared_error, num_obs, data_range, base=base, reduction=reduction)


# ------------------------------------------------------------------ PSNRB


def _compute_bef(x: Tensor, block_size: int = 8) -> Tensor:
    """Blocking effect factor of a grayscale image (the block masks are numpy, as in JAX)."""
    _, channels, height, width = x.shape
    if channels > 1:
        raise ValueError(f"`psnrb` metric expects grayscale images, but got images with {channels} channels.")
    h_b = np.arange(block_size - 1, width - 1, block_size)
    h_bc = np.setdiff1d(np.arange(width - 1), h_b)
    v_b = np.arange(block_size - 1, height - 1, block_size)
    v_bc = np.setdiff1d(np.arange(height - 1), v_b)

    def idx(a):
        return torch.as_tensor(a, dtype=torch.long, device=x.device)

    d_b = torch.sum((x[:, :, :, idx(h_b)] - x[:, :, :, idx(h_b + 1)]) ** 2)
    d_bc = torch.sum((x[:, :, :, idx(h_bc)] - x[:, :, :, idx(h_bc + 1)]) ** 2)
    d_b = d_b + torch.sum((x[:, :, idx(v_b), :] - x[:, :, idx(v_b + 1), :]) ** 2)
    d_bc = d_bc + torch.sum((x[:, :, idx(v_bc), :] - x[:, :, idx(v_bc + 1), :]) ** 2)

    n_hb = height * (width / block_size) - 1
    n_hbc = (height * (width - 1)) - n_hb
    n_vb = width * (height / block_size) - 1
    n_vbc = (width * (height - 1)) - n_vb
    d_b = d_b / (n_hb + n_vb)
    d_bc = d_bc / (n_hbc + n_vbc)
    t = math.log2(block_size) / math.log2(min(height, width))
    return torch.where(d_b > d_bc, t * (d_b - d_bc), torch.zeros_like(d_b))


def _psnrb_update(preds: Tensor, target: Tensor, block_size: int = 8) -> Tuple[Tensor, Tensor, Tensor]:
    """SSE, blocking effect, observation count."""
    sum_squared_error = torch.sum((preds - target) ** 2)
    bef = _compute_bef(preds, block_size=block_size)
    num_obs = _f32(target.numel(), target.device)
    return sum_squared_error, bef, num_obs


def _psnrb_compute(sum_squared_error: Tensor, bef: Tensor, num_obs: Tensor, data_range: Tensor) -> Tensor:
    """PSNR with the blocking-effect correction; a peak of 1.0 unless the data range exceeds 2 (JAX's quirk)."""
    sum_squared_error = sum_squared_error / num_obs + bef
    peak_sq = torch.where(data_range > 2, data_range**2, torch.ones_like(data_range))
    return 10 * torch.log10(peak_sq / sum_squared_error)


def peak_signal_noise_ratio_with_blocked_effect(preds: Tensor, target: Tensor, block_size: int = 8) -> Tensor:
    """PSNRB."""
    preds, target = _check_image_pair(preds, target)
    data_range = target.max() - target.min()
    sum_squared_error, bef, num_obs = _psnrb_update(preds, target, block_size=block_size)
    return _psnrb_compute(sum_squared_error, bef, num_obs, data_range)


# -------------------------------------------------------------------- UQI


def _uqi_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Validate inputs."""
    return _check_image_pair(preds, target)


def _uqi_map(
    preds: Tensor, target: Tensor, kernel_size: Sequence[int] = (11, 11), sigma: Sequence[float] = (1.5, 1.5)
) -> Tensor:
    """The cropped UQI map ``(B, C, H', W')``: JAX's ``_uqi_compute`` before its reduction."""
    if len(kernel_size) != 2 or len(sigma) != 2:
        raise ValueError(
            "Expected `kernel_size` and `sigma` to have the length of two."
            f" Got kernel_size: {len(kernel_size)} and sigma: {len(sigma)}."
        )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")

    dtype = preds.dtype
    col, row = _gaussian_factors(kernel_size, sigma, dtype, preds.device)
    pad_h = (kernel_size[0] - 1) // 2
    pad_w = (kernel_size[1] - 1) // 2
    preds = reflect_pad_2d(preds, pad_w, pad_h)
    target = reflect_pad_2d(target, pad_w, pad_h)
    mu_pred, mu_target, e_pred_sq, e_target_sq, e_pred_target = _moments_2d(preds, target, col, row)

    mu_pred_sq = mu_pred**2
    mu_target_sq = mu_target**2
    mu_pred_target = mu_pred * mu_target
    sigma_pred_sq = torch.clamp(e_pred_sq - mu_pred_sq, min=0.0)
    sigma_target_sq = torch.clamp(e_target_sq - mu_target_sq, min=0.0)
    sigma_pred_target = e_pred_target - mu_pred_target

    upper = 2 * sigma_pred_target
    lower = sigma_pred_sq + sigma_target_sq
    eps = torch.finfo(sigma_pred_sq.dtype).eps
    uqi_idx = ((2 * mu_pred_target) * upper) / ((mu_pred_sq + mu_target_sq) * lower + eps)
    return uqi_idx[..., pad_h:-pad_h, pad_w:-pad_w]


def _uqi_compute(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """UQI from the windowed moments."""
    return reduce(_uqi_map(preds, target, kernel_size, sigma), reduction)


def universal_image_quality_index(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """UQI."""
    preds, target = _uqi_update(preds, target)
    return _uqi_compute(preds, target, kernel_size, sigma, reduction)


# ------------------------------------------------------------------ ERGAS


def _ergas_compute(preds: Tensor, target: Tensor, ratio: float = 4, reduction: Optional[str] = "elementwise_mean") -> Tensor:
    """ERGAS score."""
    b, c, h, w = preds.shape
    preds = preds.reshape(b, c, h * w)
    target = target.reshape(b, c, h * w)
    diff = preds - target
    sum_squared_error = torch.sum(diff * diff, dim=2)
    rmse_per_band = torch.sqrt(sum_squared_error / (h * w))
    mean_target = torch.mean(target, dim=2)
    ergas_score = 100 / ratio * torch.sqrt(torch.sum((rmse_per_band / mean_target) ** 2, dim=1) / c)
    return reduce(ergas_score, reduction)


def error_relative_global_dimensionless_synthesis(
    preds: Tensor, target: Tensor, ratio: float = 4, reduction: Optional[str] = "elementwise_mean"
) -> Tensor:
    """ERGAS."""
    preds, target = _check_image_pair(preds, target)
    return _ergas_compute(preds, target, ratio, reduction)


# -------------------------------------------------------------------- SAM


def _sam_compute(preds: Tensor, target: Tensor, reduction: Optional[str] = "elementwise_mean") -> Tensor:
    """Per-pixel spectral angle."""
    dot_product = (preds * target).sum(dim=1)
    preds_norm = torch.sqrt(torch.sum(preds * preds, dim=1))  # jnp.linalg.norm's sum of squares
    target_norm = torch.sqrt(torch.sum(target * target, dim=1))
    sam_score = torch.arccos(torch.clamp(dot_product / (preds_norm * target_norm), -1, 1))
    return reduce(sam_score, reduction)


def spectral_angle_mapper(preds: Tensor, target: Tensor, reduction: Optional[str] = "elementwise_mean") -> Tensor:
    """SAM."""
    preds, target = _check_image_pair(preds, target)
    if preds.shape[1] <= 1:
        raise ValueError(f"Expected channel dimension of `preds` and `target` to be larger than 1. Got {preds.shape[1]}.")
    return _sam_compute(preds, target, reduction)


# -------------------------------------------------------------------- SCC


def _symmetric_reflect_pad_2d(x: Tensor, pad: Tuple[int, int, int, int]) -> Tensor:
    """Edge-inclusive mirror pad ``d c b a | a b c d | d c b a``, with JAX's slices
    (a pad of 0 on the right or bottom mirrors the whole axis: ``x[..., -0:]``)."""
    left, right, top, bottom = pad
    x = torch.cat([torch.flip(x[:, :, :, :left], (3,)), x, torch.flip(x[:, :, :, -right:], (3,))], dim=3)
    return torch.cat([torch.flip(x[:, :, :top, :], (2,)), x, torch.flip(x[:, :, -bottom:, :], (2,))], dim=2)


def _signal_convolve_2d(x: Tensor, kernel: Tensor) -> Tensor:
    """Scipy-style signal convolution of every channel: mirror pad + flipped kernel."""
    kh, kw = kernel.shape[2], kernel.shape[3]
    pad = (int(math.floor((kw - 1) / 2)), int(math.ceil((kw - 1) / 2)), int(math.floor((kh - 1) / 2)), int(math.ceil((kh - 1) / 2)))
    padded = _symmetric_reflect_pad_2d(x, pad)
    channels = x.shape[1]
    return conv2d(padded, torch.flip(kernel, (2, 3)).expand(channels, 1, kh, kw), groups=channels)


def _scc_map(preds: Tensor, target: Tensor, hp_filter: Tensor, window_size: int) -> Tensor:
    """Per-channel SCC map of every channel at once (JAX runs the same per channel)."""
    dtype = preds.dtype
    preds_hp = _signal_convolve_2d(preds, hp_filter) * 2.0
    target_hp = _signal_convolve_2d(target, hp_filter) * 2.0

    left = int(math.ceil((window_size - 1) / 2))
    right = int(math.floor((window_size - 1) / 2))
    p = torch.nn.functional.pad(preds_hp, (left, right, left, right))
    t = torch.nn.functional.pad(target_hp, (left, right, left, right))
    col, row = _uniform_factors((window_size, window_size), window_size**2, dtype, preds.device)
    preds_mean, target_mean, e_pp, e_tt, e_pt = window_moments(p, t, col, row)
    preds_var = torch.clamp(e_pp - preds_mean**2, min=0.0)
    target_var = torch.clamp(e_tt - target_mean**2, min=0.0)
    cov = e_pt - target_mean * preds_mean

    den = torch.sqrt(target_var) * torch.sqrt(preds_var)
    return torch.where(den == 0, torch.zeros_like(cov), cov / torch.where(den == 0, torch.ones_like(den), den))


def spatial_correlation_coefficient(
    preds: Tensor,
    target: Tensor,
    hp_filter: Optional[Tensor] = None,
    window_size: int = 8,
    reduction: Optional[str] = "mean",
) -> Tensor:
    """SCC."""
    preds, target = _to_tensors(preds, target)
    if preds.ndim == 3:
        preds = preds[:, None]
        target = target[:, None]
    if hp_filter is None:
        hp_filter = [[-1.0, -1.0, -1.0], [-1.0, 8.0, -1.0], [-1.0, -1.0, -1.0]]
    if reduction is None:
        reduction = "none"
    if reduction not in ("mean", "none"):
        raise ValueError(f"Expected reduction to be 'mean' or 'none', but got {reduction}")
    preds, target = _check_image_pair(preds, target)
    if not window_size > 0:
        raise ValueError(f"Expected `window_size` to be a positive integer. Got {window_size}.")
    if window_size > preds.shape[2] or window_size > preds.shape[3]:
        raise ValueError(
            f"Expected `window_size` to be less than or equal to the size of the image."
            f" Got window_size: {window_size} and image size: {preds.shape[2]}x{preds.shape[3]}."
        )
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    hp_filter = _to_tensor(hp_filter, preds.device).to(torch.float32)[None, None]
    scc = _scc_map(preds, target, hp_filter, window_size)
    if reduction == "none":
        return torch.mean(scc, dim=(1, 2, 3))
    return torch.mean(scc)


# ----------------------------------------------------------- RMSE-SW / RASE


def root_mean_squared_error_using_sliding_window(
    preds: Tensor, target: Tensor, window_size: int = 8, return_rmse_map: bool = False
):
    """RMSE over a sliding window."""
    preds, target = _check_image_pair(preds, target)
    if not isinstance(window_size, int) or isinstance(window_size, int) and window_size < 1:
        raise ValueError("Argument `window_size` is expected to be a positive integer.")
    if round(window_size / 2) >= target.shape[2] or round(window_size / 2) >= target.shape[3]:
        raise ValueError(
            f"Parameter `round(window_size / 2)` is expected to be smaller than"
            f" {min(target.shape[2], target.shape[3])} but got {round(window_size / 2)}."
        )
    error = (preds - target) ** 2
    error = _uniform_filter(error, window_size)
    rmse_map = torch.sqrt(error)
    crop = round(window_size / 2)
    rmse_val = torch.mean(rmse_map[:, :, crop:-crop, crop:-crop])
    if return_rmse_map:
        # the batch-averaged map
        return rmse_val, torch.mean(rmse_map, dim=0)
    return rmse_val


def relative_average_spectral_error(preds: Tensor, target: Tensor, window_size: int = 8) -> Tensor:
    """RASE."""
    preds, target = _check_image_pair(preds, target)
    if not isinstance(window_size, int) or isinstance(window_size, int) and window_size < 1:
        raise ValueError("Argument `window_size` is expected to be a positive integer.")
    _, rmse_map = root_mean_squared_error_using_sliding_window(preds, target, window_size, return_rmse_map=True)
    # the per-image mean of the (window²-scaled) local target mean, as JAX accumulates it
    target_mean_img = torch.mean(_uniform_filter(target, window_size) / (window_size**2), dim=0)
    target_mean = torch.mean(target_mean_img, dim=0)  # mean over channels -> (H, W)
    rase_map = 100 / target_mean * torch.sqrt(torch.mean(rmse_map**2, dim=0))
    crop = round(window_size / 2)
    return torch.mean(rase_map[crop:-crop, crop:-crop])


# ----------------------------------------------------------- total variation


def _total_variation_update(img: Tensor) -> Tuple[Tensor, int]:
    """Per-sample anisotropic TV."""
    img = _as_float(_to_tensor(img))
    if img.ndim != 4:
        raise RuntimeError(f"Expected input `img` to be an 4D tensor, but got {tuple(img.shape)}")
    diff1 = img[..., 1:, :] - img[..., :-1, :]
    diff2 = img[..., :, 1:] - img[..., :, :-1]
    res1 = torch.abs(diff1).sum(dim=(1, 2, 3))
    res2 = torch.abs(diff2).sum(dim=(1, 2, 3))
    return res1 + res2, img.shape[0]


def _total_variation_compute(score: Tensor, num_elements, reduction: Optional[str]) -> Tensor:
    """Final reduction."""
    if reduction == "mean":
        return score.sum() / num_elements
    if reduction == "sum":
        return score.sum()
    if reduction is None or reduction == "none":
        return score
    raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")


def total_variation(img: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    """TV."""
    score, num_elements = _total_variation_update(img)
    return _total_variation_compute(score, num_elements, reduction)


# -------------------------------------------------------------------- VIF


def _vif_filter(win_size: float, sigma: float, device=None) -> Tensor:
    coords = torch.arange(win_size, dtype=torch.float32, device=device) - (win_size - 1) / 2
    g = coords**2
    g = torch.exp(-(g[None, :] + g[:, None]) / (2.0 * sigma**2))
    return g / torch.sum(g)


def _vif_factor(win_size: float, sigma: float, device=None) -> Tensor:
    """K7's 1-D factor of :func:`_vif_filter` (both ``col`` and ``row``): ``exp(-a²/2σ²)``, normalised;
    its outer product is the 2-D table up to float32 rounding."""
    coords = torch.arange(win_size, dtype=torch.float32, device=device) - (win_size - 1) / 2
    g = torch.exp(-(coords**2) / (2.0 * sigma**2))
    return g / torch.sum(g)


def _vif_per_channel(preds: Tensor, target: Tensor, sigma_n_sq: float = 2.0) -> Tensor:
    """Pixel-domain VIF of each (image, channel): ``(B, C)`` (JAX runs one channel at a time)."""
    dtype = preds.dtype
    eps = torch.full((), 1e-10, dtype=dtype, device=preds.device)
    channels = preds.shape[1]

    preds_vif = torch.zeros(preds.shape[:2], dtype=dtype, device=preds.device)
    target_vif = torch.zeros(preds.shape[:2], dtype=dtype, device=preds.device)
    for scale in range(4):
        n = 2.0 ** (4 - scale) + 1
        if scale > 0:
            window = _vif_filter(n, n / 5, preds.device)
            kernel = window[None, None].expand(channels, 1, *window.shape)
            target = conv2d(target, kernel, groups=channels)[:, :, ::2, ::2]
            preds = conv2d(preds, kernel, groups=channels)[:, :, ::2, ::2]

        factor = _vif_factor(n, n / 5, preds.device)
        mu_target, mu_preds, e_target_sq, e_preds_sq, e_target_preds = window_moments(target, preds, factor, factor)
        mu_target_sq = mu_target**2
        mu_preds_sq = mu_preds**2
        mu_target_preds = mu_target * mu_preds

        sigma_target_sq = torch.clamp(e_target_sq - mu_target_sq, min=0.0)
        sigma_preds_sq = torch.clamp(e_preds_sq - mu_preds_sq, min=0.0)
        sigma_target_preds = e_target_preds - mu_target_preds

        g = sigma_target_preds / (sigma_target_sq + eps)
        sigma_v_sq = sigma_preds_sq - g * sigma_target_preds

        zero = torch.zeros_like(g)
        mask = sigma_target_sq < eps
        g = torch.where(mask, zero, g)
        sigma_v_sq = torch.where(mask, sigma_preds_sq, sigma_v_sq)
        sigma_target_sq = torch.where(mask, zero, sigma_target_sq)

        mask = sigma_preds_sq < eps
        g = torch.where(mask, zero, g)
        sigma_v_sq = torch.where(mask, zero, sigma_v_sq)

        mask = g < 0
        sigma_v_sq = torch.where(mask, sigma_preds_sq, sigma_v_sq)
        g = torch.where(mask, zero, g)
        sigma_v_sq = torch.clamp(sigma_v_sq, min=eps)

        preds_vif_scale = torch.log10(1.0 + (g**2.0) * sigma_target_sq / (sigma_v_sq + sigma_n_sq))
        preds_vif = preds_vif + torch.sum(preds_vif_scale, dim=(2, 3))
        target_vif = target_vif + torch.sum(torch.log10(1.0 + sigma_target_sq / sigma_n_sq), dim=(2, 3))
    return preds_vif / target_vif


def _vif_inputs(preds, target) -> Tuple[Tensor, Tensor]:
    preds, target = (t.to(torch.float32) for t in _to_tensors(preds, target))
    preds, target = _check_image_pair(preds, target)
    if preds.shape[-1] < 41 or preds.shape[-2] < 41:
        raise ValueError(f"Invalid size of preds. Expected at least 41x41, but got {preds.shape[-1]}x{preds.shape[-2]}!")
    return preds, target


def visual_information_fidelity(preds: Tensor, target: Tensor, sigma_n_sq: float = 2.0) -> Tensor:
    """Pixel-based VIF: the mean over every (channel, image) value."""
    preds, target = _vif_inputs(preds, target)
    return torch.mean(_vif_per_channel(preds, target, sigma_n_sq).T.reshape(-1))


# -------------------------------------------------------------- image gradients


def image_gradients(img: Tensor) -> Tuple[Tensor, Tensor]:
    """Finite-difference image gradients ``(dy, dx)``, zero-padded at the far edge."""
    img = _as_float(_to_tensor(img))
    if img.ndim != 4:
        raise RuntimeError(f"The `img` expects a 4D tensor but got {img.ndim}D tensor")
    dy = img[..., 1:, :] - img[..., :-1, :]
    dx = img[..., :, 1:] - img[..., :, :-1]
    dy = torch.nn.functional.pad(dy, (0, 0, 0, 1))
    dx = torch.nn.functional.pad(dx, (0, 1, 0, 0))
    return dy, dx
