# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Audio module metrics (counterpart of ``torchmetrics_tpu/audio/metrics.py``).

Every class keeps the JAX package's states: a running sum of per-sample
values (float32) and a sample count (int32), both ``"sum"``-reduced (DNSMOS
a ``(4,)`` sum). STOI, PESQ and DNSMOS score on the host: JAX fuses them
through ``jax.pure_callback``, and a CUDA graph cannot hold a host call, so
here they declare ``_sharded_update_unsupported`` and no fused plan or
sharded update takes them. SRMR is eligible by the same predicate as in
JAX, and its K* check reads the host: JAX's fused build fails at trace
there, the port's at capture, naming the member.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from torchmetrics_tpu_torch.functional.audio.callbacks import _PESQ_AVAILABLE, perceptual_evaluation_speech_quality
from torchmetrics_tpu_torch.functional.audio.dnsmos import (
    _ONNXRUNTIME_AVAILABLE,
    deep_noise_suppression_mean_opinion_score,
)
from torchmetrics_tpu_torch.functional.audio.pit import permutation_invariant_training
from torchmetrics_tpu_torch.functional.audio.sdr import (
    scale_invariant_signal_distortion_ratio,
    signal_distortion_ratio,
    source_aggregated_signal_distortion_ratio,
)
from torchmetrics_tpu_torch.functional.audio.snr import (
    complex_scale_invariant_signal_noise_ratio,
    scale_invariant_signal_noise_ratio,
    signal_noise_ratio,
)
from torchmetrics_tpu_torch.functional.audio.srmr import (
    _srmr_arg_validate,
    speech_reverberation_modulation_energy_ratio,
)
from torchmetrics_tpu_torch.functional.audio.stoi import short_time_objective_intelligibility
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import _jnp_add, _to_tensor

Tensor = torch.Tensor


def _host_call(what: str) -> str:
    return (
        f"update() runs {what} on the host (JAX reaches it through jax.pure_callback); a CUDA graph"
        " cannot hold a host call"
    )


class _AveragedAudioMetric(Metric):
    """The shared shell: per-sample values summed and counted."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_value", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:  # pragma: no cover - abstract
        raise NotImplementedError

    def _fold(self, value: Tensor) -> None:
        self.sum_value = _jnp_add(self.sum_value, value.sum())
        self.total = self.total + value.numel()

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Fold the batch's per-sample values into the sum and the count."""
        self._fold(self._metric(*self._inputs(preds, target)))

    def compute(self) -> Tensor:
        return self.sum_value / self.total


class SignalDistortionRatio(_AveragedAudioMetric):
    """SDR."""

    def __init__(
        self,
        use_cg_iter: Optional[int] = None,
        filter_length: int = 512,
        zero_mean: bool = False,
        load_diag: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.use_cg_iter = use_cg_iter
        self.filter_length = filter_length
        self.zero_mean = zero_mean
        self.load_diag = load_diag

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return signal_distortion_ratio(preds, target, self.use_cg_iter, self.filter_length, self.zero_mean, self.load_diag)


class ScaleInvariantSignalDistortionRatio(_AveragedAudioMetric):
    """SI-SDR."""

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(zero_mean, bool):
            raise ValueError(f"Expected argument `zero_mean` to be an bool, but got {zero_mean}")
        self.zero_mean = zero_mean

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return scale_invariant_signal_distortion_ratio(preds, target, self.zero_mean)


class SourceAggregatedSignalDistortionRatio(_AveragedAudioMetric):
    """SA-SDR."""

    def __init__(self, scale_invariant: bool = True, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(scale_invariant, bool):
            raise ValueError(f"Expected argument `scale_invariant` to be a bool, but got {scale_invariant}")
        if not isinstance(zero_mean, bool):
            raise ValueError(f"Expected argument `zero_mean` to be a bool, but got {zero_mean}")
        self.scale_invariant = scale_invariant
        self.zero_mean = zero_mean

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return source_aggregated_signal_distortion_ratio(preds, target, self.scale_invariant, self.zero_mean)


class SignalNoiseRatio(_AveragedAudioMetric):
    """SNR."""

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return signal_noise_ratio(preds, target, self.zero_mean)


class ScaleInvariantSignalNoiseRatio(_AveragedAudioMetric):
    """SI-SNR."""

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return scale_invariant_signal_noise_ratio(preds, target)


class ComplexScaleInvariantSignalNoiseRatio(_AveragedAudioMetric):
    """C-SI-SNR."""

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(zero_mean, bool):
            raise ValueError(f"Expected argument `zero_mean` to be an bool, but got {zero_mean}")
        self.zero_mean = zero_mean

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return complex_scale_invariant_signal_noise_ratio(preds, target, self.zero_mean)


#: the Metric base's keyword arguments, which PIT keeps from the metric function's
_BASE_KWARGS = (
    "compute_on_cpu", "dist_sync_on_step", "process_group", "dist_sync_fn",
    "distributed_available_fn", "sync_on_compute", "compute_with_cache", "device",
)


class PermutationInvariantTraining(Metric):
    """PIT: the best permutation's metric, averaged over the samples."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        metric_func: Callable,
        mode: str = "speaker-wise",
        eval_func: str = "max",
        **kwargs: Any,
    ) -> None:
        base_kwargs = {k: kwargs.pop(k) for k in list(kwargs) if k in _BASE_KWARGS}
        super().__init__(**base_kwargs)
        if eval_func not in ("max", "min"):
            raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
        if mode not in ("speaker-wise", "permutation-wise"):
            raise ValueError(f'mode can only be "speaker-wise" or "permutation-wise" but got {mode}')
        self.metric_func = metric_func
        self.mode = mode
        self.eval_func = eval_func
        self.kwargs = kwargs
        self.add_state("sum_pit_metric", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Fold the batch's best-permutation values into the sum and the count."""
        preds, target = self._inputs(preds, target)
        pit_metric = permutation_invariant_training(
            preds, target, self.metric_func, self.mode, self.eval_func, **self.kwargs
        )[0]
        self.sum_pit_metric = _jnp_add(self.sum_pit_metric, pit_metric.sum())
        self.total = self.total + pit_metric.numel()

    def compute(self) -> Tensor:
        return self.sum_pit_metric / self.total


class PerceptualEvaluationSpeechQuality(_AveragedAudioMetric):
    """PESQ, scored by the ``pesq`` library on the host."""

    is_differentiable = False
    _sharded_update_unsupported = _host_call("the pesq library")

    def __init__(self, fs: int, mode: str, n_processes: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not _PESQ_AVAILABLE:
            raise ModuleNotFoundError(
                "PerceptualEvaluationSpeechQuality metric requires that `pesq` is installed."
                " Either install as `pip install torchmetrics[audio]` or `pip install pesq`."
            )
        if fs not in (8000, 16000):
            raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
        if mode not in ("wb", "nb"):
            raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
        self.fs = fs
        self.mode = mode
        self.n_processes = n_processes

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return perceptual_evaluation_speech_quality(preds, target, self.fs, self.mode, n_processes=self.n_processes)


class ShortTimeObjectiveIntelligibility(_AveragedAudioMetric):
    """STOI, the numpy pipeline on the host (no ``pystoi`` needed)."""

    is_differentiable = False
    _sharded_update_unsupported = _host_call("the STOI pipeline in numpy")

    def __init__(self, fs: int, extended: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.fs = fs
        self.extended = extended

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return torch.atleast_1d(short_time_objective_intelligibility(preds, target, self.fs, self.extended))


class SpeechReverberationModulationEnergyRatio(_AveragedAudioMetric):
    """SRMR: its two IIR filter banks are K5 launches on the card."""

    is_differentiable = False

    def __init__(
        self,
        fs: int,
        n_cochlear_filters: int = 23,
        low_freq: float = 125,
        min_cf: float = 4,
        max_cf: Any = None,
        norm: bool = False,
        fast: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _srmr_arg_validate(fs, n_cochlear_filters, low_freq, min_cf, max_cf, norm, fast)
        self.fs = fs
        self.n_cochlear_filters = n_cochlear_filters
        self.low_freq = low_freq
        self.min_cf = min_cf
        self.max_cf = max_cf
        self.norm = norm
        self.fast = fast

    def update(self, preds: Tensor) -> None:  # type: ignore[override]
        """Fold the batch's SRMR values into the sum and the count."""
        value = speech_reverberation_modulation_energy_ratio(
            _to_tensor(preds, self._device), self.fs, self.n_cochlear_filters, self.low_freq, self.min_cf,
            self.max_cf, self.norm, self.fast,
        )
        self._fold(torch.atleast_1d(value))


class DeepNoiseSuppressionMeanOpinionScore(Metric):
    """DNSMOS: mel features in numpy, ONNX inference on the host (``onnxruntime`` and local model files)."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    _sharded_update_unsupported = _host_call("the DNSMOS pipeline (numpy and an onnxruntime session)")

    def __init__(self, fs: int, personalized: bool = False, num_threads: Any = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not _ONNXRUNTIME_AVAILABLE:
            raise ModuleNotFoundError(
                "DeepNoiseSuppressionMeanOpinionScore metric requires that onnxruntime is installed."
                " Install as `pip install onnxruntime` (mel features are computed natively; librosa is not needed)."
            )
        self.fs = fs
        self.personalized = personalized
        self.num_threads = num_threads
        self.add_state("sum_mos", torch.zeros(4), dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds: Tensor) -> None:  # type: ignore[override]
        """Fold the batch's four scores per sample into the sums and the count."""
        value = deep_noise_suppression_mean_opinion_score(
            _to_tensor(preds, self._device), self.fs, self.personalized, num_threads=self.num_threads
        ).reshape(-1, 4)
        self.sum_mos = _jnp_add(self.sum_mos, value.sum(dim=0))
        self.total = self.total + value.shape[0]

    def compute(self) -> Tensor:
        """Mean ``[p808_mos, mos_sig, mos_bak, mos_ovr]`` over the stream."""
        return self.sum_mos / self.total
