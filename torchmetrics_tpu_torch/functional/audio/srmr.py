# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Speech-to-reverberation modulation energy ratio (counterpart of
``torchmetrics_tpu/functional/audio/srmr.py``).

Pipeline (Falk et al., 2010): ERB gammatone filterbank, Hilbert envelope,
8-band modulation filterbank (Q=2), windowed modulation energy (256 ms
windows, 64 ms hop, Hamming), ratio of low (bands 1-4) to high (bands
5..K*) modulation energy, K* from the 90%-energy ERB bandwidth.

The filter designs are the JAX package's host numpy, copied as they are.
Both IIR banks run through K5 (``ops.biquad_cascade``,
``csrc/biquad.cu``) on the card, two launches a call, and through its
plain loop on CPU tensors. The windowed energy is the windows' squares
times the squared window, summed (float32, no convolution library), so
no global TF32 flag can change the result. ``fast=True`` warns and runs
the exact bank, as JAX's does. The K* check reads the host, as JAX's does.
"""
from __future__ import annotations

from functools import lru_cache
from math import ceil, pi
from typing import Optional

import numpy as np
import torch

from torchmetrics_tpu_torch.ops.biquad import biquad_cascade
from torchmetrics_tpu_torch.utilities.data import _jnp_dtype, _to_tensor

Tensor = torch.Tensor

_EAR_Q = 9.26449  # Glasberg and Moore parameters
_MIN_BW = 24.7
_ENERGY_CHUNK = 1 << 28  # float32 elements of the windowed-energy temporary (1 GiB)


def _erb_space(low_freq: float, high_freq: float, n: int) -> np.ndarray:
    """ERB-spaced centre frequencies, descending (Slaney ERBSpace)."""
    c = _EAR_Q * _MIN_BW
    return -c + np.exp(
        np.arange(1, n + 1) * (-np.log(high_freq + c) + np.log(low_freq + c)) / n
    ) * (high_freq + c)


@lru_cache(maxsize=100)
def _calc_erbs(low_freq: float, fs: int, n_filters: int) -> np.ndarray:
    """Equivalent rectangular bandwidths of the filterbank channels."""
    cfs = _erb_space(low_freq, fs / 2, n_filters)
    return (cfs / _EAR_Q) + _MIN_BW


@lru_cache(maxsize=100)
def _make_erb_filters(fs: int, num_freqs: int, cutoff: float) -> np.ndarray:
    """Slaney gammatone filter coefficients ``(N, 10)``:
    ``A0, A11, A12, A13, A14, A2, B0, B1, B2, gain``."""
    cf = _erb_space(cutoff, fs / 2, num_freqs)
    t = 1.0 / fs
    erb = ((cf / _EAR_Q) ** 1 + _MIN_BW**1) ** 1
    b = 1.019 * 2 * np.pi * erb

    arg = 2 * cf * np.pi * t
    vec = np.exp(2j * arg)

    a0 = t
    a2 = 0.0
    b0 = 1.0
    b1 = -2 * np.cos(arg) / np.exp(b * t)
    b2 = np.exp(-2 * b * t)

    rt_pos = np.sqrt(3 + 2**1.5)
    rt_neg = np.sqrt(3 - 2**1.5)

    common = -t * np.exp(-(b * t))
    k11 = np.cos(arg) + rt_pos * np.sin(arg)
    k12 = np.cos(arg) - rt_pos * np.sin(arg)
    k13 = np.cos(arg) + rt_neg * np.sin(arg)
    k14 = np.cos(arg) - rt_neg * np.sin(arg)
    a11 = common * k11
    a12 = common * k12
    a13 = common * k13
    a14 = common * k14

    gain_arg = np.exp(1j * arg - b * t)
    gain = np.abs(
        (vec - gain_arg * k11)
        * (vec - gain_arg * k12)
        * (vec - gain_arg * k13)
        * (vec - gain_arg * k14)
        * (t / (-np.exp(-2 * b * t) - vec + (1 + vec) * np.exp(-b * t))) ** 4
    )

    n = len(cf)
    coefs = np.zeros((n, 10))
    coefs[:, 0] = a0
    coefs[:, 1] = a11
    coefs[:, 2] = a12
    coefs[:, 3] = a13
    coefs[:, 4] = a14
    coefs[:, 5] = a2
    coefs[:, 6] = b0
    coefs[:, 7] = b1
    coefs[:, 8] = b2
    coefs[:, 9] = gain
    return coefs


def _gammatone_banks(coefs: np.ndarray):
    """The 4-stage cascade's ``(N, 4, 3)`` float32 numerators and
    denominators (``A0, A1k, A2`` over ``B0, B1, B2``) and the ``(N,)`` gains."""
    num = torch.tensor(np.stack([np.stack([coefs[:, 0], coefs[:, k], coefs[:, 5]], axis=-1) for k in (1, 2, 3, 4)], axis=1),
                       dtype=torch.float32)
    den = torch.tensor(coefs[:, 6:9], dtype=torch.float32)[:, None, :].expand(-1, 4, -1)
    return num, den, torch.tensor(coefs[:, 9], dtype=torch.float32)


def _erb_filterbank(wave: Tensor, coefs: np.ndarray) -> Tensor:
    """The 4-stage gammatone cascade, ``wave (B, time)`` to ``(B, N, time)``: one K5 launch."""
    num, den, gain = _gammatone_banks(coefs)
    out = biquad_cascade(wave.contiguous(), num, den).reshape(wave.shape[0], coefs.shape[0], wave.shape[-1])
    return out / gain.to(wave.device)[None, :, None]


def _hilbert_envelope(x: Tensor) -> Tensor:  # metriclint: disable=ML011 -- host-built filters: fusable by the predicate, fails at capture (ROADMAP A)
    """|analytic signal| by FFT, at a length padded to a multiple of 16."""
    time = x.shape[-1]
    n = time if time % 16 == 0 else ceil(time / 16) * 16
    x_fft = torch.fft.fft(x, n=n, dim=-1)
    h = np.zeros(n)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1
        h[1 : n // 2] = 2
    else:
        h[0] = 1
        h[1 : (n + 1) // 2] = 2
    y = torch.fft.ifft(x_fft * torch.tensor(h, dtype=torch.float32, device=x.device), dim=-1)
    return torch.abs(y[..., :time])


@lru_cache(maxsize=100)
def _modulation_filterbank_and_cutoffs(min_cf: float, max_cf: float, n: int, fs: float, q: int):
    """Second-order bandpass bank and its 3 dB cutoffs."""
    spacing_factor = (max_cf / min_cf) ** (1.0 / (n - 1))
    cfs = min_cf * spacing_factor ** np.arange(n)
    w0 = 2 * pi * cfs / fs
    w0t = np.tan(w0 / 2)
    b0 = w0t / q
    b = np.stack([b0, np.zeros(n), -b0], axis=-1)
    a = np.stack([1 + b0 + w0t**2, 2 * w0t**2 - 2, 1 - b0 + w0t**2], axis=-1)
    lower = cfs - b0 * fs / (2 * pi)
    upper = cfs + b0 * fs / (2 * pi)
    return cfs, b, a, lower, upper


def _windowed_energy(mod_out: Tensor, window: Tensor, w_inc: int, num_frames: int) -> Tensor:
    """``sum_j (frame[j] * w[j])²`` of each strided frame, ``(..., time)`` to
    ``(..., num_frames)``: the squares times the squared window, summed in
    float32 over row chunks of at most ``_ENERGY_CHUNK`` elements."""
    lead, time = mod_out.shape[:-1], mod_out.shape[-1]
    w_length = window.shape[0]
    sq = (mod_out**2).reshape(-1, time)
    pad = max(0, (num_frames - 1) * w_inc + w_length - time)
    if pad:
        sq = torch.nn.functional.pad(sq, (0, pad))
    kernel = window**2
    rows = max(1, _ENERGY_CHUNK // (num_frames * w_length))
    parts = [
        (chunk.unfold(-1, w_length, w_inc)[:, :num_frames] * kernel).sum(dim=-1) for chunk in torch.split(sq, rows)
    ]
    return torch.cat(parts).reshape(*lead, num_frames)


def _srmr_arg_validate(
    fs: int,
    n_cochlear_filters: int,
    low_freq: float,
    min_cf: float,
    max_cf: Optional[float],
    norm: bool,
    fast: bool,
) -> None:
    """Validate the arguments."""
    if not (isinstance(fs, int) and fs > 0):
        raise ValueError(f"Expected argument `fs` to be a positive int, but got {fs}")
    if not (isinstance(n_cochlear_filters, int) and n_cochlear_filters > 0):
        raise ValueError(
            f"Expected argument `n_cochlear_filters` to be a positive int, but got {n_cochlear_filters}"
        )
    if not ((isinstance(low_freq, (float, int))) and low_freq > 0):
        raise ValueError(f"Expected argument `low_freq` to be a positive float, but got {low_freq}")
    if not ((isinstance(min_cf, (float, int))) and min_cf > 0):
        raise ValueError(f"Expected argument `min_cf` to be a positive float, but got {min_cf}")
    if max_cf is not None and not ((isinstance(max_cf, (float, int))) and max_cf > 0):
        raise ValueError(f"Expected argument `max_cf` to be a positive float, but got {max_cf}")
    if not isinstance(norm, bool):
        raise ValueError("Expected argument `norm` to be a bool value")
    if not isinstance(fast, bool):
        raise ValueError("Expected argument `fast` to be a bool value")


def speech_reverberation_modulation_energy_ratio(  # metriclint: disable=ML011 -- host-built filters: fusable by the predicate, fails at capture (ROADMAP A)
    preds: Tensor,
    fs: int,
    n_cochlear_filters: int = 23,
    low_freq: float = 125,
    min_cf: float = 4,
    max_cf: Optional[float] = None,
    norm: bool = False,
    fast: bool = False,
) -> Tensor:
    """SRMR of ``(..., time)`` audio, float32 of shape ``(...)``."""
    _srmr_arg_validate(fs, n_cochlear_filters, low_freq, min_cf, max_cf, norm, fast)
    if fast:
        from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

        rank_zero_warn(
            "`fast=True` is accepted for API parity but the exact ERB filterbank is used;"
            " values equal the fast=False result, not the reference's gammatonegram approximation.",
            UserWarning,
        )
    preds = _jnp_dtype(_to_tensor(preds))
    shape, in_dtype = preds.shape, preds.dtype
    preds = preds.reshape(1, -1) if preds.ndim == 1 else preds.reshape(-1, shape[-1])
    num_batch, time = preds.shape
    if not preds.is_floating_point():
        preds = preds.to(torch.float32) / torch.iinfo(in_dtype).max

    # normalize into [-1, 1] like the reference's lfilter precondition
    max_vals = torch.abs(preds).max(dim=-1, keepdim=True).values
    preds = preds / torch.where(max_vals > 1, max_vals, torch.ones_like(max_vals))

    w_length_s, w_inc_s = 0.256, 0.064
    fcoefs = _make_erb_filters(fs, n_cochlear_filters, low_freq)
    gt_env = _hilbert_envelope(_erb_filterbank(preds, fcoefs))  # (B, N, time)
    mfs = float(fs)

    w_length = ceil(w_length_s * mfs)
    w_inc = ceil(w_inc_s * mfs)

    if max_cf is None:
        max_cf = 30 if norm else 128
    _, mf_b, mf_a, cutoffs_lower, _ = _modulation_filterbank_and_cutoffs(min_cf, max_cf, 8, mfs, 2)

    # the modulation filterbank over the envelopes, (B, N, 8, time): the second K5 launch
    b_, n_ = gt_env.shape[:2]
    mod_out = biquad_cascade(
        gt_env.reshape(b_ * n_, time),
        torch.tensor(mf_b, dtype=torch.float32)[:, None, :],
        torch.tensor(mf_a, dtype=torch.float32)[:, None, :],
    ).reshape(b_, n_, 8, time)

    num_frames = int(1 + (time - w_length) // w_inc) if time >= w_length else 1
    # periodic Hamming window (torch.hamming_window default), matching the
    # reference's hamming_window(w_length + 1)[:-1]
    window = torch.tensor(np.hamming(w_length + 2)[:w_length], dtype=torch.float32, device=preds.device)
    energy = _windowed_energy(mod_out, window, w_inc, num_frames)  # (B, N, 8, num_frames)
    del mod_out

    if norm:
        peak = energy.mean(dim=1, keepdim=True).amax(dim=2, keepdim=True).amax(dim=3, keepdim=True)
        floor = peak * 10.0 ** (-30.0 / 10.0)
        energy = torch.clamp(energy, min=floor, max=peak)

    erbs = np.flipud(_calc_erbs(low_freq, fs, n_cochlear_filters))  # ascending

    avg_energy = energy.mean(dim=-1)  # (B, N, 8)
    total_energy = avg_energy.reshape(num_batch, -1).sum(dim=-1)
    ac_energy = avg_energy.sum(dim=2)  # (B, N)
    ac_perc = ac_energy * 100 / total_energy[:, None]
    ac_perc_cumsum = torch.flip(ac_perc, [-1]).cumsum(-1)
    k90perc_idx = torch.argmax((ac_perc_cumsum > 90).to(torch.int32), dim=-1)
    bw = torch.tensor(erbs.copy(), dtype=torch.float32, device=preds.device)[k90perc_idx]  # (B,)

    cutoffs = torch.tensor(cutoffs_lower, dtype=torch.float32, device=preds.device)
    # K* per sample: 4 plus how many of cutoffs[4..7] lie at or below the bandwidth
    kstar = 4 + (cutoffs[4:8][None, :] <= bw[:, None]).sum(dim=-1)  # in 5..8
    if bool((kstar < 5).any()):
        raise ValueError("Something wrong with the cutoffs compared to bw values.")
    low_e = avg_energy[:, :, :4].sum(dim=(1, 2))
    # high energy = the sum over modulation bands 4..kstar-1
    band_idx = torch.arange(8, device=preds.device)
    high_mask = (band_idx[None, :] >= 4) & (band_idx[None, :] < kstar[:, None])
    high_e = (avg_energy.sum(dim=1) * high_mask).sum(dim=-1)
    score = low_e / high_e
    return score.reshape(*shape[:-1]) if len(shape) > 1 else score.reshape(())
