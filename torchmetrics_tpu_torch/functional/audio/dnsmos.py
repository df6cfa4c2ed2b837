# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""DNSMOS (counterpart of ``torchmetrics_tpu/functional/audio/dnsmos.py``).

The pipeline runs on the host as in JAX, except the ONNX inference itself:
the 120-band mel-spectrogram (librosa's Slaney-mel conventions) is numpy,
copied as it is, so only ``onnxruntime`` and the two published DNSMOS model
files are needed. Nothing is downloaded: the models must be placed under
``TM_TPU_DNSMOS_DIR`` (default ``~/.torchmetrics_tpu/DNSMOS``), else the
call raises JAX's ``FileNotFoundError``. JAX reaches the pipeline through
``jax.pure_callback``; the port calls it directly, and a CUDA graph cannot
hold it (the module metric says so).
"""
from __future__ import annotations

import os
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from torchmetrics_tpu_torch.utilities.data import _jnp_dtype, _to_tensor
from torchmetrics_tpu_torch.utilities.imports import _ONNXRUNTIME_AVAILABLE

Tensor = torch.Tensor

SAMPLING_RATE = 16000
INPUT_LENGTH = 9.01


def _dnsmos_dir() -> str:
    """Model directory, read per call so TM_TPU_DNSMOS_DIR can be set late."""
    return os.environ.get("TM_TPU_DNSMOS_DIR", "~/.torchmetrics_tpu/DNSMOS")


@lru_cache(maxsize=4)
def _mel_filterbank(sr: int = 16000, n_fft: int = 321, n_mels: int = 120) -> np.ndarray:
    """Slaney-mel triangular filterbank with Slaney normalization (librosa's
    defaults for ``melspectrogram``)."""

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        # Slaney scale: linear below 1 kHz, log above
        mel = f / (200.0 / 3)
        log_region = f >= 1000.0
        mel = np.where(log_region, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0), mel)
        return mel

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        f = m * (200.0 / 3)
        log_region = m >= 15.0
        return np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)

    fmax = sr / 2
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(fmax), n_mels + 2))
    fft_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    weights = np.zeros((n_mels, len(fft_freqs)))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    # Slaney normalization: each filter integrates to ~1 over Hz
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    return weights * enorm[:, None]


def _audio_melspec(audio: np.ndarray, n_mels: int = 120, frame_size: int = 320, hop_length: int = 160) -> np.ndarray:
    """dB-scaled mel-spectrogram (``n_fft=frame_size+1``, centered, Hann)."""
    n_fft = frame_size + 1
    shape = audio.shape
    audio = np.asarray(audio, np.float64).reshape(-1, shape[-1])
    pad = n_fft // 2
    audio = np.pad(audio, ((0, 0), (pad, pad)), mode="reflect")
    window = np.hanning(n_fft + 1)[:-1]  # periodic Hann (librosa fftbins=True)
    n_frames = 1 + (audio.shape[-1] - n_fft) // hop_length
    idx = np.arange(n_fft)[None, :] + hop_length * np.arange(n_frames)[:, None]
    frames = audio[:, idx] * window  # (B, T', n_fft)
    spec = np.abs(np.fft.rfft(frames, n=n_fft, axis=-1)) ** 2
    mel = spec @ _mel_filterbank(SAMPLING_RATE, n_fft, n_mels).T  # (B, T', n_mels)
    # librosa power_to_db(ref=np.max, top_db=80), then the DNSMOS (x+40)/40
    out = np.empty_like(mel)
    for b in range(mel.shape[0]):
        ref = max(mel[b].max(), 1e-10)
        db = 10.0 * np.log10(np.maximum(mel[b], 1e-10) / ref)
        db = np.maximum(db, db.max() - 80.0)
        out[b] = (db + 40.0) / 40.0
    return out.reshape(shape[:-1] + out.shape[1:])


def _polyfit_val(mos: np.ndarray, personalized: bool) -> np.ndarray:
    """Polynomial calibration of the raw model outputs (published DNSMOS coefficients)."""
    if personalized:
        p_ovr = np.poly1d([-0.00533021, 0.005101, 1.18058466, -0.11236046])
        p_sig = np.poly1d([-0.01019296, 0.02751166, 1.19576786, -0.24348726])
        p_bak = np.poly1d([-0.04976499, 0.44276479, -0.1644611, 0.96883132])
    else:
        p_ovr = np.poly1d([-0.06766283, 1.11546468, 0.04602535])
        p_sig = np.poly1d([-0.08397278, 1.22083953, 0.0052439])
        p_bak = np.poly1d([-0.13166888, 1.60915514, -0.39604546])
    mos[..., 1] = p_sig(mos[..., 1])
    mos[..., 2] = p_bak(mos[..., 2])
    mos[..., 3] = p_ovr(mos[..., 3])
    return mos


@lru_cache(maxsize=4)
def _load_session(path: str, num_threads: Optional[int] = None):
    """Load an onnxruntime CPU session for a local model file."""
    import onnxruntime as ort

    path = os.path.expanduser(path)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"DNSMOS model file {path!r} not found. This environment has no network egress; download"
            " 'DNSMOS/model_v8.onnx', 'DNSMOS/sig_bak_ovr.onnx' and 'pDNSMOS/sig_bak_ovr.onnx' from the"
            " microsoft/DNS-Challenge repository and place them under"
            f" {_dnsmos_dir()} (override with TM_TPU_DNSMOS_DIR)."
        )
    opts = ort.SessionOptions()
    if num_threads is not None:
        opts.inter_op_num_threads = num_threads
        opts.intra_op_num_threads = num_threads
    return ort.InferenceSession(path, providers=["CPUExecutionProvider"], sess_options=opts)


def _dnsmos_host(preds: np.ndarray, fs: int, personalized: bool, num_threads: Optional[int]) -> np.ndarray:
    """Host pipeline (resample -> segments -> mel + ONNX -> calibration)."""
    audio = np.asarray(preds, np.float64)
    if fs != SAMPLING_RATE:
        from math import gcd

        from scipy.signal import resample_poly

        g = gcd(SAMPLING_RATE, fs)
        audio = resample_poly(audio, SAMPLING_RATE // g, fs // g, axis=-1)

    sess = _load_session(f"{_dnsmos_dir()}/{'p' if personalized else ''}DNSMOS/sig_bak_ovr.onnx", num_threads)
    p808_sess = _load_session(f"{_dnsmos_dir()}/DNSMOS/model_v8.onnx", num_threads)

    if audio.shape[-1] == 0:
        raise ValueError("DNSMOS requires non-empty audio input.")
    len_samples = int(INPUT_LENGTH * SAMPLING_RATE)
    while audio.shape[-1] < len_samples:
        audio = np.concatenate([audio, audio], axis=-1)
    num_hops = int(np.floor(audio.shape[-1] / SAMPLING_RATE) - INPUT_LENGTH) + 1

    moss = []
    for idx in range(num_hops):
        seg = audio[..., idx * SAMPLING_RATE : int((idx + INPUT_LENGTH) * SAMPLING_RATE)]
        if seg.shape[-1] < len_samples:
            continue
        shape = seg.shape
        seg2 = seg.reshape(-1, shape[-1]).astype(np.float32)
        mel_features = _audio_melspec(seg2[..., :-160]).astype(np.float32)
        p808_mos = p808_sess.run(None, {"input_1": mel_features})[0].reshape(seg2.shape[0], 1)
        raw = sess.run(None, {"input_1": seg2})[0]  # (B, 3): sig, bak, ovr
        mos = np.concatenate([p808_mos, raw], axis=-1)  # (B, 4)
        mos = _polyfit_val(mos, personalized)
        moss.append(mos.reshape(shape[:-1] + (4,)))
    return np.mean(np.stack(moss), axis=0).astype(np.float32)


def deep_noise_suppression_mean_opinion_score(
    preds: Tensor, fs: int, personalized: bool = False, device: Optional[str] = None, num_threads: Optional[int] = None
) -> Tensor:
    """DNSMOS ``[p808_mos, mos_sig, mos_bak, mos_ovr]`` per sample, float32
    ``(..., 4)`` on ``preds``' device (``device`` is accepted for parity:
    the ONNX session runs on the host's CPU, as in JAX)."""
    if not _ONNXRUNTIME_AVAILABLE:
        raise ModuleNotFoundError(
            "DNSMOS metric requires that onnxruntime is installed."
            " Install as `pip install onnxruntime` (the mel features are computed natively; librosa is not needed)."
        )
    preds = _jnp_dtype(_to_tensor(preds))
    if preds.shape[-1] == 0:
        raise ValueError("DNSMOS requires non-empty audio input.")
    return torch.tensor(_dnsmos_host(preds.detach().cpu().numpy(), fs, personalized, num_threads), device=preds.device)
