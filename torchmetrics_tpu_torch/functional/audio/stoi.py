# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Short-time objective intelligibility (counterpart of
``torchmetrics_tpu/functional/audio/stoi.py``).

The published algorithm (Taal et al., 2011, and the extended variant of
Jensen & Taal, 2016) with pystoi's conventions, as host numpy (silent-frame
removal makes the shapes data-dependent): the JAX package's pipeline
copied as it is, so the same samples give JAX's scores bit for bit. JAX
reaches it through ``jax.pure_callback``; the port calls it directly, and
a CUDA graph cannot hold it (the module metric says so).

Pipeline: resample to 10 kHz, drop frames more than 40 dB below the
loudest clean frame, 512-point STFT (256 window, 128 hop, Hann), 15
third-octave bands from 150 Hz, 384 ms segments (30 frames), per-band
clipped correlation (STOI) or spectrogram-normalized correlation (ESTOI),
averaged.
"""
from __future__ import annotations

from functools import lru_cache
from math import gcd
from typing import Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.utilities.data import _jnp_dtype, _to_tensors
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor

FS = 10000  # the algorithm's internal rate
N_FRAME = 256
NFFT = 512
HOP = 128
NUM_BANDS = 15
MIN_FREQ = 150.0
N_SEG = 30  # frames per analysis segment (384 ms)
BETA = -15.0  # lower SDR clip bound
DYN_RANGE = 40.0


@lru_cache(maxsize=8)
def _third_octave_band_matrix() -> np.ndarray:
    """(15, NFFT//2+1) band matrix with pystoi's nearest-bin edge rounding."""
    freqs = np.linspace(0, FS, NFFT + 1)[: NFFT // 2 + 1]
    cfs = MIN_FREQ * 2.0 ** (np.arange(NUM_BANDS) / 3.0)
    lo = cfs * 2 ** (-1 / 6)
    hi = cfs * 2 ** (1 / 6)
    obm = np.zeros((NUM_BANDS, len(freqs)))
    for k in range(NUM_BANDS):
        lo_idx = int(np.argmin(np.abs(freqs - lo[k])))
        hi_idx = int(np.argmin(np.abs(freqs - hi[k])))
        obm[k, lo_idx:hi_idx] = 1.0
    return obm


def _frame(x: np.ndarray) -> np.ndarray:
    """(time,) -> (n_frames, N_FRAME), pystoi's strict ``range(0, len-256, 128)``."""
    starts = np.arange(0, x.shape[-1] - N_FRAME, HOP)
    if len(starts) == 0:
        return np.zeros((0, N_FRAME))
    return x[starts[:, None] + np.arange(N_FRAME)[None, :]]


def _remove_silent_frames(clean: np.ndarray, degraded: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Drop frames > 40 dB below the loudest clean frame, overlap-add the
    survivors back into waveforms (data-dependent output length)."""
    window = np.hanning(N_FRAME + 2)[1:-1]
    frames_c = _frame(clean) * window
    frames_d = _frame(degraded) * window
    if frames_c.shape[0] == 0:
        return np.zeros(0), np.zeros(0)
    energies = 20 * np.log10(np.linalg.norm(frames_c, axis=-1) + 1e-20)
    mask = energies > energies.max() - DYN_RANGE
    frames_c = frames_c[mask]
    frames_d = frames_d[mask]
    n_kept = frames_c.shape[0]
    out_len = (n_kept - 1) * HOP + N_FRAME if n_kept else 0
    out_c = np.zeros(out_len)
    out_d = np.zeros(out_len)
    for i in range(n_kept):  # overlap-add (50% Hann gives unity gain)
        out_c[i * HOP : i * HOP + N_FRAME] += frames_c[i]
        out_d[i * HOP : i * HOP + N_FRAME] += frames_d[i]
    return out_c, out_d


def _band_envelopes(x: np.ndarray) -> np.ndarray:
    """Third-octave band magnitudes per frame: (n_frames, 15)."""
    frames = _frame(x)
    window = np.hanning(N_FRAME + 2)[1:-1]
    spec = np.fft.rfft(frames * window, NFFT, axis=-1)
    power = np.abs(spec) ** 2
    return np.sqrt(power @ _third_octave_band_matrix().T)


def _segments(bands: np.ndarray) -> np.ndarray:
    """(n_frames, 15) -> (n_segments, 15, N_SEG) sliding windows."""
    windows = np.lib.stride_tricks.sliding_window_view(bands, (N_SEG, NUM_BANDS))[:, 0]
    return windows.transpose(0, 2, 1)


def _stoi_correlation(x_seg: np.ndarray, y_seg: np.ndarray) -> float:
    """Classic STOI: per-band normalize + clip + correlate."""
    eps = np.finfo(np.float64).eps
    alpha = np.sqrt((x_seg**2).sum(-1, keepdims=True) / ((y_seg**2).sum(-1, keepdims=True) + eps))
    y_prime = np.minimum(y_seg * alpha, x_seg * (1 + 10 ** (-BETA / 20)))
    x_c = x_seg - x_seg.mean(-1, keepdims=True)
    y_c = y_prime - y_prime.mean(-1, keepdims=True)
    corr = (x_c * y_c).sum(-1) / (
        np.linalg.norm(x_c, axis=-1) * np.linalg.norm(y_c, axis=-1) + eps
    )
    return float(corr.mean())


def _estoi_correlation(x_seg: np.ndarray, y_seg: np.ndarray) -> float:
    """Extended STOI: row+column normalization, mean inner product."""
    eps = np.finfo(np.float64).eps

    def normalize(seg: np.ndarray) -> np.ndarray:
        seg = seg - seg.mean(-1, keepdims=True)
        seg = seg / (np.linalg.norm(seg, axis=-1, keepdims=True) + eps)
        seg = seg - seg.mean(-2, keepdims=True)
        return seg / (np.linalg.norm(seg, axis=-2, keepdims=True) + eps)

    x_n = normalize(x_seg)
    y_n = normalize(y_seg)
    return float((x_n * y_n).sum(-2).mean())


def _resample_to_10k(x: np.ndarray, fs: int) -> np.ndarray:
    if fs == FS:
        return x
    from scipy.signal import resample_poly

    g = gcd(FS, fs)
    return resample_poly(x, FS // g, fs // g, axis=-1)


def _stoi_single(clean: np.ndarray, degraded: np.ndarray, fs: int, extended: bool) -> float:
    clean = _resample_to_10k(np.asarray(clean, np.float64), fs)
    degraded = _resample_to_10k(np.asarray(degraded, np.float64), fs)
    clean, degraded = _remove_silent_frames(clean, degraded)
    x_bands = _band_envelopes(clean)  # (frames, 15)
    y_bands = _band_envelopes(degraded)
    if x_bands.shape[0] < N_SEG:
        # pystoi convention: warn and return a floor score instead of raising
        rank_zero_warn(
            "Not enough non-silent frames for a STOI measurement (need ≥ 30 frames, ~384 ms of"
            f" speech; got {x_bands.shape[0]}). Returning 1e-5.",
            UserWarning,
        )
        return 1e-5
    x_seg = _segments(x_bands)
    y_seg = _segments(y_bands)
    return _estoi_correlation(x_seg, y_seg) if extended else _stoi_correlation(x_seg, y_seg)


def short_time_objective_intelligibility(
    preds: Tensor, target: Tensor, fs: int, extended: bool = False, keep_same_device: bool = False
) -> Tensor:
    """STOI/ESTOI of degraded ``preds`` against clean ``target``, float32 of
    shape ``preds.shape[:-1]`` on the inputs' device.

    Both are first taken in the dtype ``jnp.asarray`` gives them (float64
    as float32), as JAX's callback receives them, then scored on the host.
    """
    preds, target = map(_jnp_dtype, _to_tensors(preds, target))
    if preds.shape != target.shape:
        raise RuntimeError(
            "Predictions and targets are expected to have the same shape,"
            f" got {tuple(preds.shape)} and {tuple(target.shape)}"
        )
    shape = preds.shape
    p2 = preds.detach().cpu().numpy().astype(np.float64).reshape(-1, shape[-1])
    t2 = target.detach().cpu().numpy().astype(np.float64).reshape(-1, shape[-1])
    scores = [_stoi_single(t, p, fs, extended) for p, t in zip(p2, t2)]
    return torch.tensor(np.asarray(scores, np.float32).reshape(shape[:-1]), device=preds.device)
