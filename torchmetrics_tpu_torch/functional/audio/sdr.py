# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The SDR family (counterpart of ``torchmetrics_tpu/functional/audio/sdr.py``).

The distortion filter is an FFT autocorrelation (``torch.fft.rfft`` and
``irfft`` at JAX's ``n_fft``) and a dense symmetric Toeplitz system solved
by ``torch.linalg.solve``: a plain batched solve, as JAX leaves its
``jnp.linalg.solve`` to XLA.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.data import _to_tensors

Tensor = torch.Tensor


def _symmetric_toeplitz(vector: Tensor) -> Tensor:
    """Symmetric Toeplitz matrices from their first rows (``(..., L)`` to ``(..., L, L)``)."""
    v_len = vector.shape[-1]
    idx = torch.arange(v_len, device=vector.device)
    return vector[..., (idx[:, None] - idx[None, :]).abs()]


def _compute_autocorr_crosscorr(target: Tensor, preds: Tensor, corr_len: int):
    """FFT-based auto- and cross-correlation, their first ``corr_len`` lags."""
    n_fft = 2 ** math.ceil(math.log2(preds.shape[-1] + target.shape[-1] - 1))
    t_fft = torch.fft.rfft(target, n=n_fft, dim=-1)
    r_0 = torch.fft.irfft(t_fft.real**2 + t_fft.imag**2, n=n_fft)[..., :corr_len]
    p_fft = torch.fft.rfft(preds, n=n_fft, dim=-1)
    b = torch.fft.irfft(torch.conj(t_fft) * p_fft, n=n_fft, dim=-1)[..., :corr_len]
    return r_0, b


def signal_distortion_ratio(
    preds: Tensor,
    target: Tensor,
    use_cg_iter: Optional[int] = None,
    filter_length: int = 512,
    zero_mean: bool = False,
    load_diag: Optional[float] = None,
) -> Tensor:
    """SDR through the optimal distortion filter.

    Computed in float32, the JAX package's default (its float64 path needs
    ``jax_enable_x64``; the port has no such flag). ``use_cg_iter`` is
    accepted for parity and the dense solve is used always, as in JAX.
    Float32 SDR is ill-conditioned: ``coh / (1 - coh)`` magnifies the
    solver's rounding, so the tests state their budgets.
    """
    preds, target = _to_tensors(preds, target)
    _check_same_shape(preds, target)
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)

    if zero_mean:
        preds = preds - preds.mean(dim=-1, keepdim=True)
        target = target - target.mean(dim=-1, keepdim=True)

    target = target / torch.clamp(torch.linalg.vector_norm(target, dim=-1, keepdim=True), min=1e-6)
    preds = preds / torch.clamp(torch.linalg.vector_norm(preds, dim=-1, keepdim=True), min=1e-6)

    r_0, b = _compute_autocorr_crosscorr(target, preds, corr_len=filter_length)
    if load_diag is not None:
        r_0 = r_0.clone()
        r_0[..., 0] += load_diag

    r = _symmetric_toeplitz(r_0)
    sol = torch.linalg.solve(r, b[..., None])[..., 0]
    coh = torch.einsum("...l,...l->...", b, sol)
    ratio = coh / (1 - coh)
    return 10.0 * torch.log10(ratio)


def scale_invariant_signal_distortion_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """SI-SDR."""
    preds, target = (t.to(torch.float32) for t in _to_tensors(preds, target))
    _check_same_shape(preds, target)
    eps = torch.finfo(preds.dtype).eps
    if zero_mean:
        target = target - torch.mean(target, dim=-1, keepdim=True)
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)
    alpha = (torch.sum(preds * target, dim=-1, keepdim=True) + eps) / (torch.sum(target**2, dim=-1, keepdim=True) + eps)
    target_scaled = alpha * target
    noise = target_scaled - preds
    val = (torch.sum(target_scaled**2, dim=-1) + eps) / (torch.sum(noise**2, dim=-1) + eps)
    return 10 * torch.log10(val)


def source_aggregated_signal_distortion_ratio(
    preds: Tensor,
    target: Tensor,
    scale_invariant: bool = True,
    zero_mean: bool = False,
) -> Tensor:
    """SA-SDR over all speakers at once (``(..., spk, time)`` inputs)."""
    preds, target = (t.to(torch.float32) for t in _to_tensors(preds, target))
    _check_same_shape(preds, target)
    if preds.ndim < 2:
        raise RuntimeError(
            f"The preds and target should have the shape (..., spk, time), but {tuple(preds.shape)} found"
        )
    eps = torch.finfo(preds.dtype).eps
    if zero_mean:
        target = target - torch.mean(target, dim=-1, keepdim=True)
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)
    if scale_invariant:
        alpha = (torch.sum(preds * target, dim=(-1, -2), keepdim=True) + eps) / (
            torch.sum(target**2, dim=(-1, -2), keepdim=True) + eps
        )
        target = alpha * target
    distortion = target - preds
    val = (torch.sum(target**2, dim=(-1, -2)) + eps) / (torch.sum(distortion**2, dim=(-1, -2)) + eps)
    return 10 * torch.log10(val)
