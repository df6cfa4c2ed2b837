# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Audio of the port (SNR, SI-SNR, C-SI-SNR, SDR, SI-SDR, SA-SDR, PIT,
SRMR, STOI, PESQ, DNSMOS and the eleven module classes) against the JAX
package's: the cases of ``tests/unittests/audio/test_audio_metrics.py``,
with its oracles, and every argument branch.

The same seeded numpy inputs go through both packages on the CPU. Budgets:

- STOI and ESTOI, the DNSMOS mel features and calibration, and the
  ``total`` counts are the same host numpy (or integers): bitwise;
- SNR, SI-SDR, SI-SNR, SA-SDR and C-SI-SNR are float32 sums over time in
  another order than XLA's, in dB: ``rtol=1e-5, atol=1e-4``;
- SDR solves a float32 Toeplitz system (LAPACK's in both, with other
  pivoting orders) and ``coh / (1 - coh)`` magnifies its rounding:
  ``atol=1e-3`` dB (measured 8.6e-5 dB at filter length 64);
- SRMR runs both IIR banks (K5's plain route here) against ``lax.scan``,
  which XLA contracts into FMAs (``tests/test_torch_biquad.py``), then FFTs
  and sums of other libraries: ``rtol=2e-3``. Measured at most 6.0e-4, on
  JAX's 120 Hz modulated tone, where float32 SRMR itself is ill-conditioned:
  the port and JAX each lie 2.2e-3 to 2.9e-3 from a float64
  ``scipy.signal.lfilter`` pipeline there; on noise 1.6e-5 to 3.4e-5;
- PIT's best permutations are equal; its values carry the metric's budget.
"""
from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu.functional as JFA
import torchmetrics_tpu.functional.audio as JF
import torchmetrics_tpu_torch as T
import torchmetrics_tpu_torch.functional as TFA
import torchmetrics_tpu_torch.functional.audio as TF
from torchmetrics_tpu.parallel.fused import fusion_ineligibility as j_fusion_ineligibility
from torchmetrics_tpu_torch.interop import state_from_numpy, state_to_numpy
from torchmetrics_tpu_torch.parallel.fused import fusion_ineligibility

RTOL, ATOL = 1e-5, 1e-4
SDR_ATOL = 1e-3
SRMR_RTOL = 2e-3
#: the three classes that score on the host: JAX fuses them through jax.pure_callback, the port cannot
HOST_CALL_CLASSES = ("ShortTimeObjectiveIntelligibility", "PerceptualEvaluationSpeechQuality",
                     "DeepNoiseSuppressionMeanOpinionScore")


def _np(x):
    return np.ascontiguousarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x))


def _t(x):
    return torch.from_numpy(np.array(x))


def _bitwise(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(np.atleast_1d(got).view(np.uint8), np.atleast_1d(want).view(np.uint8), err_msg=what)


def _close(got, want, what="", rtol=RTOL, atol=ATOL):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _raised(fn, *args, **kw):
    with pytest.raises(Exception) as info:
        fn(*args, **kw)
    return type(info.value), str(info.value)


def _rng(seed=21):
    return np.random.RandomState(seed)


def _pair(seed, shape, noise=0.3, dtype=np.float32):
    rng = _rng(seed)
    target = rng.randn(*shape)
    return (target + noise * rng.randn(*shape)).astype(dtype), target.astype(dtype)


def _si_sdr_oracle(preds, target, zero_mean=False):
    preds, target = preds.astype(np.float64), target.astype(np.float64)
    eps = np.finfo(np.float32).eps
    if zero_mean:
        preds = preds - preds.mean(-1, keepdims=True)
        target = target - target.mean(-1, keepdims=True)
    alpha = ((preds * target).sum(-1, keepdims=True) + eps) / ((target**2).sum(-1, keepdims=True) + eps)
    t = alpha * target
    return 10 * np.log10(((t**2).sum(-1) + eps) / (((t - preds) ** 2).sum(-1) + eps))


def _sdr_oracle(preds, target, filter_length):
    """JAX's float64 oracle: the distortion filter by ``scipy.linalg.solve_toeplitz``."""
    from scipy.linalg import solve_toeplitz

    out = []
    for p, t in zip(np.atleast_2d(preds).astype(np.float64), np.atleast_2d(target).astype(np.float64)):
        t, p = t / max(np.linalg.norm(t), 1e-6), p / max(np.linalg.norm(p), 1e-6)
        n_fft = 2 ** int(np.ceil(np.log2(len(p) + len(t) - 1)))
        t_fft = np.fft.rfft(t, n_fft)
        r = np.fft.irfft(np.abs(t_fft) ** 2, n_fft)[:filter_length]
        b = np.fft.irfft(np.conj(t_fft) * np.fft.rfft(p, n_fft), n_fft)[:filter_length]
        coh = b @ solve_toeplitz(r, b)
        out.append(10 * np.log10(coh / (1 - coh)))
    return np.asarray(out)


# ------------------------------------------------------------------ SNR family

SNR_CASES = [
    ("signal_noise_ratio", {}), ("signal_noise_ratio", {"zero_mean": True}),
    ("scale_invariant_signal_distortion_ratio", {}), ("scale_invariant_signal_distortion_ratio", {"zero_mean": True}),
    ("scale_invariant_signal_noise_ratio", {}),
    ("source_aggregated_signal_distortion_ratio", {}), ("source_aggregated_signal_distortion_ratio", {"zero_mean": True}),
    ("source_aggregated_signal_distortion_ratio", {"scale_invariant": False}),
]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name,kw", SNR_CASES, ids=[f"{n}-{'-'.join(map(str, k)) or 'default'}" for n, k in SNR_CASES])
def test_snr_family_matches_jax(name, kw, dtype):
    preds, target = _pair(4, (2, 3, 400), dtype=dtype)
    want = getattr(JF, name)(preds, target, **kw)
    got = getattr(TF, name)(_t(preds), _t(target), **kw)
    _close(got, want, name)
    if name.startswith("scale_invariant"):
        zero_mean = kw.get("zero_mean", name.endswith("noise_ratio"))
        np.testing.assert_allclose(_np(got), _si_sdr_oracle(preds, target, zero_mean), rtol=1e-3)


def test_documented_values_as_in_jax():
    target = np.array([3.0, -0.5, 2.0, 7.0], np.float32)
    preds = np.array([2.5, 0.0, 2.0, 8.0], np.float32)
    np.testing.assert_allclose(float(TF.signal_noise_ratio(_t(preds), _t(target))), 16.1805, atol=1e-3)
    np.testing.assert_allclose(float(TF.scale_invariant_signal_distortion_ratio(_t(preds), _t(target))), 18.4030, atol=1e-3)


@pytest.mark.parametrize("form", ["complex64", "complex128", "real_pairs"])
@pytest.mark.parametrize("zero_mean", [False, True])
def test_complex_si_snr_matches_jax(form, zero_mean):
    rng = _rng(7)
    spec = rng.randn(2, 16, 30) + 1j * rng.randn(2, 16, 30)
    noisy = spec + 0.2 * (rng.randn(2, 16, 30) + 1j * rng.randn(2, 16, 30))
    if form == "real_pairs":
        spec, noisy = (np.stack([s.real, s.imag], -1).astype(np.float32) for s in (spec, noisy))
    else:
        spec, noisy = spec.astype(form), noisy.astype(form)
    want = JF.complex_scale_invariant_signal_noise_ratio(noisy, spec, zero_mean)
    _close(TF.complex_scale_invariant_signal_noise_ratio(_t(noisy), _t(spec), zero_mean), want, form)


def test_complex_si_snr_of_stft_as_in_jax():
    """JAX's case: identical spectra score above 50 dB; complex and (..., 2) real forms agree."""
    rng = _rng(7)
    spec = torch.from_numpy((rng.randn(2, 16, 30) + 1j * rng.randn(2, 16, 30)).astype(np.complex64))
    got_complex = TF.complex_scale_invariant_signal_noise_ratio(spec, spec)
    assert bool((got_complex > 50).all())
    real_form = torch.view_as_real(spec)
    _close(TF.complex_scale_invariant_signal_noise_ratio(real_form, real_form), got_complex, "real form", rtol=1e-4)


@pytest.mark.parametrize("kw", [{"filter_length": 64}, {"filter_length": 64, "zero_mean": True},
                                {"filter_length": 32, "load_diag": 1e-3}, {"filter_length": 512, "use_cg_iter": 10}],
                         ids=["fl64", "zero_mean", "load_diag", "fl512_cg"])
def test_sdr_matches_jax_and_the_toeplitz_oracle(kw):
    preds, target = _pair(5, (3, 2000), noise=0.1)
    want = JF.signal_distortion_ratio(preds, target, **kw)
    got = TF.signal_distortion_ratio(_t(preds), _t(target), **kw)
    _close(got, want, str(kw), rtol=0, atol=SDR_ATOL)
    if "zero_mean" not in kw and "load_diag" not in kw:
        np.testing.assert_allclose(_np(got), _sdr_oracle(preds, target, kw["filter_length"]), rtol=2e-2, atol=0.1)


SHAPE_ERRORS = [
    ("signal_noise_ratio", (2, 10), (2, 11)), ("scale_invariant_signal_distortion_ratio", (3,), (4,)),
    ("signal_distortion_ratio", (2, 64), (1, 64)), ("source_aggregated_signal_distortion_ratio", (5,), (5,)),
    ("complex_scale_invariant_signal_noise_ratio", (2, 4), (2, 4)),
    ("complex_scale_invariant_signal_noise_ratio", (2, 4, 6, 3), (2, 4, 6, 3)),
]


@pytest.mark.parametrize("name,p,t", SHAPE_ERRORS, ids=[f"{c[0]}-{i}" for i, c in enumerate(SHAPE_ERRORS)])
def test_shape_errors_match_jax(name, p, t):
    preds, target = np.zeros(p, np.float32), np.ones(t, np.float32)
    assert _raised(getattr(TF, name), _t(preds), _t(target)) == _raised(getattr(JF, name), preds, target)


# ------------------------------------------------------------------ PIT


@pytest.mark.parametrize("eval_func", ["max", "min"])
@pytest.mark.parametrize("spk,mode,metric", [(2, "speaker-wise", "si_sdr"), (3, "speaker-wise", "si_sdr"),
                                             (2, "permutation-wise", "sa_sdr"), (3, "permutation-wise", "sa_sdr"),
                                             (2, "speaker-wise", "snr")])
def test_pit_matches_jax(spk, mode, metric, eval_func):
    """JAX's PIT gets JAX's metric and the port's the port's: equal permutations, values within the metric's budget."""
    fns = {"si_sdr": "scale_invariant_signal_distortion_ratio", "sa_sdr": "source_aggregated_signal_distortion_ratio",
           "snr": "signal_noise_ratio"}
    rng = _rng(9 + spk)
    target = rng.randn(4, spk, 200).astype(np.float32)
    order = [rng.permutation(spk) for _ in range(4)]
    preds = np.stack([target[b, o] for b, o in enumerate(order)]) + 0.1 * rng.randn(4, spk, 200).astype(np.float32)
    preds = preds.astype(np.float32)
    jm, jp = JF.permutation_invariant_training(preds, target, getattr(JF, fns[metric]), mode, eval_func)
    tm, tp = TF.permutation_invariant_training(_t(preds), _t(target), getattr(TF, fns[metric]), mode, eval_func)
    _bitwise(tp, jp, "best permutation")
    _close(tm, jm, "best metric")
    _close(TF.pit_permutate(_t(preds), tp), JF.pit_permutate(preds, jp), "permutated", rtol=0, atol=0)
    if eval_func == "max":  # the permutation undoes the shuffle
        np.testing.assert_allclose(_np(TF.pit_permutate(_t(preds), tp)), target, atol=0.5)


def test_pit_ties_take_the_first_permutation_as_jnp():
    """Every speaker pair scores the same: argmax and argmin both keep permutation 0."""
    x = np.ones((2, 2, 50), np.float32)
    for eval_func in ("max", "min"):
        _, tp = TF.permutation_invariant_training(_t(x), _t(x), TF.signal_noise_ratio, eval_func=eval_func)
        _, jp = JF.permutation_invariant_training(x, x, JF.signal_noise_ratio, eval_func=eval_func)
        _bitwise(tp, jp, eval_func)
        assert _np(tp).tolist() == [[0, 1], [0, 1]]


@pytest.mark.parametrize("kw,p,t", [({"eval_func": "bad"}, (2, 2, 10), (2, 2, 10)), ({"mode": "bad"}, (2, 2, 10), (2, 2, 10)),
                                    ({}, (2, 3, 10), (2, 2, 10)), ({}, (2,), (2,))], ids=["eval_func", "mode", "spk", "ndim"])
def test_pit_errors_match_jax(kw, p, t):
    preds, target = np.zeros(p, np.float32), np.zeros(t, np.float32)
    want = _raised(JF.permutation_invariant_training, preds, target, JF.signal_noise_ratio, **kw)
    assert _raised(TF.permutation_invariant_training, _t(preds), _t(target), TF.signal_noise_ratio, **kw) == want


# ------------------------------------------------------------------ SRMR

FS = 8000


def _srmr_signals():
    """JAX's cases at 0.6 s of 8 kHz: an 8 Hz amplitude modulation on 440 Hz, noise, a 120 Hz modulation."""
    t = np.arange(FS * 6 // 10) / FS
    modulated = np.sin(2 * np.pi * 4 * t) ** 2 * np.sin(2 * np.pi * 440 * t)
    noise = _rng(42).randn(t.size)
    fast_mod = np.sin(2 * np.pi * 60 * t) ** 2 * np.sin(2 * np.pi * 440 * t)
    return np.stack([modulated, noise, fast_mod]).astype(np.float32)


# every case at the default case's shapes: JAX compiles its scans once for them
SRMR_CASES = [({}, "batch"), ({"norm": True}, "batch"),
              ({"n_cochlear_filters": 23, "low_freq": 150.0, "min_cf": 2, "max_cf": 64}, "batch"), ({}, "int16")]


@pytest.mark.parametrize("kw,inputs", SRMR_CASES, ids=["default", "norm", "bank_args", "int16"])
def test_srmr_matches_jax(kw, inputs):
    x = _srmr_signals()
    if inputs == "int16":
        x = (x * 20000).astype(np.int16)
    want = JF.speech_reverberation_modulation_energy_ratio(x, FS, **kw)
    got = TF.speech_reverberation_modulation_energy_ratio(_t(x), FS, **kw)
    _close(got, want, str(kw), rtol=SRMR_RTOL, atol=0)
    if not kw and inputs == "batch":
        v = _np(got)  # JAX's property: modulated speech scores far above noise and fast modulation
        assert v[0] > 10 * v[1] and v[0] > 10 * v[2]
        # fast=True warns as JAX's does and runs the exact bank: the same value
        with pytest.warns(UserWarning, match="`fast=True` is accepted for API parity"):
            _bitwise(TF.speech_reverberation_modulation_energy_ratio(_t(x), FS, fast=True), got, "fast")


@pytest.mark.parametrize("kw", [{"fs": -1}, {"fs": 8000.0}, {"n_cochlear_filters": 0}, {"low_freq": -5}, {"min_cf": 0},
                                {"max_cf": -1}, {"norm": "yes"}, {"fast": 1}])
def test_srmr_argument_errors_match_jax(kw):
    x = np.zeros(64, np.float32)
    args = {"fs": FS, **kw}
    want = _raised(JF.speech_reverberation_modulation_energy_ratio, x, **args)
    assert _raised(TF.speech_reverberation_modulation_energy_ratio, _t(x), **args) == want
    assert _raised(T.SpeechReverberationModulationEnergyRatio, device="cpu", **args) == _raised(
        J.SpeechReverberationModulationEnergyRatio, **args)


def test_srmr_filter_designs_equal_jax():
    """The host numpy designs are JAX's, copied: bitwise."""
    from torchmetrics_tpu.functional.audio import srmr as js
    from torchmetrics_tpu_torch.functional.audio import srmr as ts

    for fs in (8000, 16000):
        _bitwise(ts._make_erb_filters(fs, 23, 125), js._make_erb_filters(fs, 23, 125), "erb filters")
        _bitwise(ts._calc_erbs(125, fs, 23), js._calc_erbs(125, fs, 23), "erbs")
        for got, want in zip(ts._modulation_filterbank_and_cutoffs(4, 128, 8, float(fs), 2),
                             js._modulation_filterbank_and_cutoffs(4, 128, 8, float(fs), 2)):
            _bitwise(got, want, "modulation bank")
    x = _srmr_signals()[:2]
    _close(ts._hilbert_envelope(_t(x)), js._hilbert_envelope(jnp.asarray(x)), "hilbert", rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ STOI


def _speechlike(n, fs, seed=1):
    rng = _rng(seed)
    t = np.arange(n) / fs
    spec = np.fft.rfft(rng.randn(n)) / np.maximum(np.fft.rfftfreq(n, 1 / fs), 50) ** 0.5
    x = np.fft.irfft(spec, n) * (0.3 + 0.7 * (0.5 + 0.5 * np.sin(2 * np.pi * 4 * t)))
    return x / np.abs(x).max()


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("fs,dtype", [(10000, np.float64), (16000, np.float32)], ids=["10k-f64", "16k-resampled"])
def test_stoi_bitwise_to_jax(fs, dtype, extended):
    clean = _speechlike(2 * fs, fs)
    batch_c = np.stack([clean, clean]).astype(dtype)
    batch_d = (batch_c + np.stack([0.1, 0.5])[:, None] * _rng(2).randn(2, 2 * fs)).astype(dtype)
    want = JF.short_time_objective_intelligibility(batch_d, batch_c, fs, extended)
    got = TF.short_time_objective_intelligibility(_t(batch_d), _t(batch_c), fs, extended)
    _bitwise(got, want, "stoi")
    assert _np(got)[0] > _np(got)[1]


def test_stoi_too_short_warns_and_scores_1e_5_as_in_jax():
    x = _rng(3).randn(1, 2000).astype(np.float32)
    with pytest.warns(UserWarning, match="Not enough non-silent frames"):
        want = JF.short_time_objective_intelligibility(x, x, 10000)
    with pytest.warns(UserWarning, match="Not enough non-silent frames"):
        got = TF.short_time_objective_intelligibility(_t(x), _t(x), 10000)
    _bitwise(got, want, "short")
    assert _raised(TF.short_time_objective_intelligibility, _t(x), _t(x[:, :10]), 10000) == _raised(
        JF.short_time_objective_intelligibility, x, x[:, :10], 10000)


# ------------------------------------------------------------------ PESQ, DNSMOS


def test_pesq_and_dnsmos_raise_jax_errors_without_their_backends():
    from torchmetrics_tpu_torch.utilities.imports import _ONNXRUNTIME_AVAILABLE, _PESQ_AVAILABLE

    assert not _PESQ_AVAILABLE and not _ONNXRUNTIME_AVAILABLE  # neither is installed, here or on the card's machine
    x = np.zeros(16000, np.float32)
    assert _raised(TF.perceptual_evaluation_speech_quality, _t(x), _t(x), 16000, "wb") == _raised(
        JF.perceptual_evaluation_speech_quality, x, x, 16000, "wb")
    assert _raised(TF.deep_noise_suppression_mean_opinion_score, _t(x), 16000) == _raised(
        JF.deep_noise_suppression_mean_opinion_score, x, 16000)
    for cls, kw in (("PerceptualEvaluationSpeechQuality", {"fs": 16000, "mode": "wb"}),
                    ("DeepNoiseSuppressionMeanOpinionScore", {"fs": 16000})):
        want = _raised(getattr(J, cls), **kw)
        assert want[0] is ModuleNotFoundError and _raised(getattr(T, cls), device="cpu", **kw) == want


def test_dnsmos_host_features_bitwise_to_jax(monkeypatch, tmp_path):
    from torchmetrics_tpu.functional.audio import dnsmos as jd
    from torchmetrics_tpu_torch.functional.audio import dnsmos as td

    _bitwise(td._mel_filterbank(), jd._mel_filterbank(), "mel filterbank")
    audio = _rng(6).randn(2, 16000).astype(np.float32)
    _bitwise(td._audio_melspec(audio), jd._audio_melspec(audio), "melspec")
    mos = _rng(7).rand(3, 4)
    for personalized in (False, True):
        _bitwise(td._polyfit_val(mos.copy(), personalized), jd._polyfit_val(mos.copy(), personalized), "polyfit")
    monkeypatch.setenv("TM_TPU_DNSMOS_DIR", str(tmp_path))
    assert td._dnsmos_dir() == jd._dnsmos_dir() == str(tmp_path)
    assert (td.SAMPLING_RATE, td.INPUT_LENGTH) == (jd.SAMPLING_RATE, jd.INPUT_LENGTH)


# ------------------------------------------------------------------ modules


def _module(pkg, cls, **kw):
    extra = {} if pkg is J else {"device": "cpu"}
    return getattr(pkg, cls)(**kw, **extra)


def _pit_fn(pkg):
    return (JF if pkg is J else TF).scale_invariant_signal_distortion_ratio


MODULE_CASES = [
    ("SignalNoiseRatio", {"zero_mean": True}, (3, 300)), ("ScaleInvariantSignalNoiseRatio", {}, (3, 300)),
    ("ScaleInvariantSignalDistortionRatio", {}, (3, 300)), ("SignalDistortionRatio", {"filter_length": 32}, (3, 300)),
    ("SourceAggregatedSignalDistortionRatio", {"scale_invariant": False}, (3, 2, 300)),
    ("ComplexScaleInvariantSignalNoiseRatio", {}, (3, 8, 12, 2)),
    ("PermutationInvariantTraining", {"eval_func": "max"}, (3, 2, 300)),
    ("ShortTimeObjectiveIntelligibility", {"fs": 10000, "extended": True}, (2, 10000)),
    ("SpeechReverberationModulationEnergyRatio", {"fs": FS}, (3, FS * 6 // 10)),
]


@pytest.mark.parametrize("cls,kw,shape", MODULE_CASES, ids=[c[0] for c in MODULE_CASES])
def test_module_states_values_and_checkpoints(cls, kw, shape):
    """Two batches into both: ``total`` bitwise and ``sum_value`` within the
    budget (bitwise for STOI); the fingerprint; each state tree into a fresh
    metric of the other package; the JAX eligibility for a fused plan, but
    the host-call classes."""
    pit = cls == "PermutationInvariantTraining"
    jm = _module(J, cls, **({"metric_func": _pit_fn(J)} if pit else {}), **kw)
    tm = _module(T, cls, **({"metric_func": _pit_fn(T)} if pit else {}), **kw)
    for seed in (1, 2):
        preds, target = _pair(seed, shape)
        if cls == "ShortTimeObjectiveIntelligibility":
            target = np.stack([_speechlike(shape[1], 10000, seed + i) for i in range(shape[0])]).astype(np.float32)
            preds = (target + 0.2 * _rng(seed).randn(*shape)).astype(np.float32)
        args = (preds,) if cls == "SpeechReverberationModulationEnergyRatio" else (preds, target)
        jm.update(*args)
        tm.update(*map(_t, args))
    jstates, tstates = jm.state_tree(), state_to_numpy(tm)
    assert sorted(jstates) == sorted(tstates)
    for key, want in jstates.items():
        if key == "total" or cls == "ShortTimeObjectiveIntelligibility":
            _bitwise(tstates[key], np.asarray(want), key)
        else:
            _close(tstates[key], np.asarray(want), key, rtol=SRMR_RTOL if "Reverberation" in cls else RTOL,
                   atol=SDR_ATOL if cls == "SignalDistortionRatio" else ATOL)
    assert tm.state_spec()["fingerprint"] == jm.state_spec()["fingerprint"]
    want = jm.compute()
    fresh, jfresh = _module(T, cls, **({"metric_func": _pit_fn(T)} if pit else {}), **kw), \
        _module(J, cls, **({"metric_func": _pit_fn(J)} if pit else {}), **kw)
    state_from_numpy(fresh, dict(jm.state_tree(include_count=True)), fingerprint=jm.state_spec()["fingerprint"])
    _bitwise(fresh.compute(), want, "JAX tree into the port")
    jfresh.load_state_tree({k: v if k == "_update_count" else jnp.asarray(v)
                            for k, v in state_to_numpy(tm, include_count=True).items()})
    _bitwise(tm.compute(), jfresh.compute(), "port tree into JAX")
    if cls in HOST_CALL_CLASSES:
        assert j_fusion_ineligibility(jm) is None
        assert fusion_ineligibility(tm) == f"host-state update ({tm._sharded_update_unsupported})"
    else:
        assert fusion_ineligibility(tm) == j_fusion_ineligibility(jm)


def test_host_call_classes_are_the_one_intended_fusion_difference():
    """STOI, PESQ and DNSMOS: JAX fuses them through ``jax.pure_callback``;
    the port's classes declare ``_sharded_update_unsupported`` naming the
    host call (a CUDA graph cannot hold one). Every other audio class fuses
    or not exactly as JAX's."""
    import torchmetrics_tpu_torch.audio as TA

    for name in TA.__all__:
        reason = getattr(getattr(T, name), "_sharded_update_unsupported", None)
        assert (reason is not None) == (name in HOST_CALL_CLASSES), name
        assert getattr(getattr(J, name), "_sharded_update_unsupported", None) is None, name
        if reason:
            assert "on the host" in reason and "jax.pure_callback" in reason and "CUDA graph" in reason


@pytest.mark.parametrize("cls,kw", [("ScaleInvariantSignalDistortionRatio", {"zero_mean": 1}),
                                    ("SourceAggregatedSignalDistortionRatio", {"scale_invariant": "no"}),
                                    ("SourceAggregatedSignalDistortionRatio", {"zero_mean": None}),
                                    ("ComplexScaleInvariantSignalNoiseRatio", {"zero_mean": 0}),
                                    ("SpeechReverberationModulationEnergyRatio", {"fs": 0})])
def test_module_argument_errors_match_jax(cls, kw):
    assert _raised(_module, T, cls, **kw) == _raised(_module, J, cls, **kw)


@pytest.mark.parametrize("kw", [{"eval_func": "median"}, {"mode": "pairwise"}])
def test_pit_module_argument_errors_match_jax(kw):
    assert _raised(_module, T, "PermutationInvariantTraining", metric_func=_pit_fn(T), **kw) == _raised(
        _module, J, "PermutationInvariantTraining", metric_func=_pit_fn(J), **kw)


def test_pit_module_passes_extra_kwargs_to_the_metric_as_jax():
    preds, target = _pair(3, (4, 2, 100))
    jm = _module(J, "PermutationInvariantTraining", metric_func=JF.scale_invariant_signal_distortion_ratio, zero_mean=True)
    tm = _module(T, "PermutationInvariantTraining", metric_func=TF.scale_invariant_signal_distortion_ratio, zero_mean=True)
    assert tm.kwargs == jm.kwargs == {"zero_mean": True} and tm.device == torch.device("cpu")
    jm.update(preds, target)
    tm.update(_t(preds), _t(target))
    _close(tm.compute(), jm.compute(), "PIT zero_mean")


def test_class_attributes_equal_jax():
    import torchmetrics_tpu_torch.audio as TA

    for name in TA.__all__:
        for attr in ("is_differentiable", "higher_is_better", "full_state_update", "plot_lower_bound", "plot_upper_bound"):
            assert getattr(getattr(T, name), attr, "missing") == getattr(getattr(J, name), attr, "missing"), (name, attr)


def test_exports_equal_jax():
    import torchmetrics_tpu.audio as JA
    import torchmetrics_tpu_torch.audio as TA

    assert sorted(TA.__all__) == sorted(JA.__all__)
    assert sorted(TF.__all__) == sorted(JF.__all__)
    for name in TF.__all__:
        assert getattr(TFA, name) is getattr(TF, name) and name in JFA.__all__
    for name in TA.__all__:
        assert getattr(T, name) is getattr(TA, name) and name in T.__all__


def test_imports_copy_is_standard_library_and_agrees_with_jax():
    import torchmetrics_tpu.utilities.imports as JI
    import torchmetrics_tpu_torch.utilities.imports as TI

    flags = [n for n in vars(TI) if n.startswith("_") and n.endswith("_AVAILABLE")]
    # the flags the ported domains read: audio's, then text's
    assert {"_PESQ_AVAILABLE", "_ONNXRUNTIME_AVAILABLE", "_REGEX_AVAILABLE", "_NLTK_AVAILABLE", "_TRANSFORMERS_AVAILABLE"} == set(flags)
    for name in flags:
        assert getattr(TI, name).module == getattr(JI, name).module and bool(getattr(TI, name)) == bool(getattr(JI, name))
    assert repr(TI.ModuleAvailableCache("numpy")) == repr(JI.ModuleAvailableCache("numpy"))
