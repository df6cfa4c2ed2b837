# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Image module metrics over the pure-math functions (counterpart of
``torchmetrics_tpu/image/metrics.py``).

The states are the JAX package's: streaming float32 sums where the metric
decomposes (PSNR, SSIM, SCC, VIF, ...), ``cat`` list states where it needs
the whole stream (UQI, ERGAS, SAM, RASE, the pan-sharpening indices), the
same names, dtypes and reductions, so a state tree crosses the packages.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.image.distortion import (
    _spectral_distortion_index_compute,
    _spectral_distortion_index_update,
    quality_with_no_reference,
    spatial_distortion_index,
)
from torchmetrics_tpu_torch.functional.image.helpers import _check_image_pair, _uniform_filter
from torchmetrics_tpu_torch.functional.image.metrics import (
    _compute_bef,
    _ergas_compute,
    _psnr_compute,
    _psnr_update,
    _psnrb_compute,
    _sam_compute,
    _total_variation_compute,
    _total_variation_update,
    _vif_per_channel,
    relative_average_spectral_error,
    spatial_correlation_coefficient,
    universal_image_quality_index,
)
from torchmetrics_tpu_torch.functional.image.ssim import _multiscale_ssim_update, _ssim_check_inputs, _ssim_update
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import _jnp_add, _to_tensor, dim_zero_cat
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor


class PeakSignalNoiseRatio(Metric):
    """PSNR."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(
        self,
        data_range: Optional[Union[float, Tuple[float, float]]] = None,
        base: float = 10.0,
        reduction: Optional[str] = "elementwise_mean",
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if dim is None and reduction != "elementwise_mean":
            rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")
        if dim is None:
            self.add_state("sum_squared_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
            self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")
        else:
            self.add_state("sum_squared_error", default=[], dist_reduce_fx="cat")
            self.add_state("total", default=[], dist_reduce_fx="cat")
        self.clamping_fn = None
        if data_range is None:
            if dim is not None:
                raise ValueError("The `data_range` must be given when `dim` is not None.")
            self.data_range = None
            self.add_state("min_target", default=torch.tensor(0.0), dist_reduce_fx="min")
            self.add_state("max_target", default=torch.tensor(0.0), dist_reduce_fx="max")
        elif isinstance(data_range, tuple):
            self.add_state("data_range", default=data_range[1] - data_range[0], dist_reduce_fx="mean")
            self.clamping_fn = lambda x: torch.clamp(x, data_range[0], data_range[1])
        else:
            self.add_state("data_range", default=torch.tensor(float(data_range)), dist_reduce_fx="mean")
        self.base = base
        self.reduction = reduction
        self.dim = tuple(dim) if isinstance(dim, Sequence) else dim

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Fold the batch's summed squared error into the state."""
        preds, target = self._inputs(preds, target)
        if self.clamping_fn is not None:
            preds = self.clamping_fn(preds)
            target = self.clamping_fn(target)
        sum_squared_error, num_obs = _psnr_update(preds, target, dim=self.dim)
        if self.dim is None:
            if self.data_range is None:
                self.min_target = torch.minimum(target.min(), self.min_target)
                self.max_target = torch.maximum(target.max(), self.max_target)
            self.sum_squared_error = _jnp_add(self.sum_squared_error, sum_squared_error)
            self.total = _jnp_add(self.total, num_obs)
        else:
            self.sum_squared_error.append(sum_squared_error)
            self.total.append(num_obs)

    def compute(self) -> Tensor:
        data_range = self.data_range if self.data_range is not None else self.max_target - self.min_target
        if self.dim is None:
            sum_squared_error = self.sum_squared_error
            total = self.total
        else:
            sum_squared_error = dim_zero_cat(self.sum_squared_error)
            total = dim_zero_cat(self.total)
        return _psnr_compute(sum_squared_error, total, data_range, base=self.base, reduction=self.reduction)


class PeakSignalNoiseRatioWithBlockedEffect(Metric):
    """PSNRB, grayscale only."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, block_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(block_size, int) or block_size < 1:
            raise ValueError("Argument `block_size` should be a positive integer")
        self.block_size = block_size
        self.add_state("sum_squared_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("bef", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("data_range", default=torch.tensor(0.0), dist_reduce_fx="max")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _check_image_pair(*self._inputs(preds, target))
        self.sum_squared_error = _jnp_add(self.sum_squared_error, torch.sum((preds - target) ** 2))
        self.bef = _jnp_add(self.bef, _compute_bef(preds, block_size=self.block_size))
        self.total = self.total + target.numel()
        self.data_range = torch.maximum(self.data_range, target.max() - target.min())

    def compute(self) -> Tensor:
        return _psnrb_compute(self.sum_squared_error, self.bef, self.total, self.data_range)


class _MeanReducedImageMetric(Metric):
    """Shared shell: per-image scores summed and counted (``sum`` reduce), or kept (``cat``)."""

    is_differentiable = True
    full_state_update = False

    def __init__(self, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if reduction not in ("elementwise_mean", "sum", "none", None):
            raise ValueError(
                f"Argument `reduction` must be one of ['elementwise_mean', 'sum', 'none', None], got {reduction}"
            )
        self.reduction = reduction
        if reduction in ("none", None):
            self.add_state("similarity", default=[], dist_reduce_fx="cat")
        else:
            self.add_state("similarity", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def _fold(self, per_image: Tensor) -> None:
        if self.reduction in ("none", None):
            self.similarity.append(per_image)
        else:
            self.similarity = _jnp_add(self.similarity, per_image.sum())
        self.total = self.total + per_image.shape[0]

    def _finalize(self) -> Tensor:
        if self.reduction in ("none", None):
            return dim_zero_cat(self.similarity)
        if self.reduction == "sum":
            return self.similarity
        return self.similarity / self.total


class StructuralSimilarityIndexMeasure(_MeanReducedImageMetric):
    """SSIM."""

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        gaussian_kernel: bool = True,
        sigma: Union[float, Sequence[float]] = 1.5,
        kernel_size: Union[int, Sequence[int]] = 11,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[Union[float, Tuple[float, float]]] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        return_full_image: bool = False,
        return_contrast_sensitivity: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(reduction=reduction, **kwargs)
        if return_full_image or return_contrast_sensitivity:
            self.add_state("image_return", default=[], dist_reduce_fx="cat")
        self.gaussian_kernel = gaussian_kernel
        self.sigma = sigma
        self.kernel_size = kernel_size
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.return_full_image = return_full_image
        self.return_contrast_sensitivity = return_contrast_sensitivity

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Fold the batch's per-image SSIM into the state."""
        preds, target = _ssim_check_inputs(*self._inputs(preds, target))
        out = _ssim_update(
            preds, target, self.gaussian_kernel, self.sigma, self.kernel_size, self.data_range, self.k1, self.k2,
            self.return_full_image, self.return_contrast_sensitivity,
        )
        if isinstance(out, tuple):
            similarity, image = out
            self.image_return.append(image)
        else:
            similarity = out
        self._fold(similarity)

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        similarity = self._finalize()
        if self.return_full_image or self.return_contrast_sensitivity:
            return similarity, dim_zero_cat(self.image_return)
        return similarity


class MultiScaleStructuralSimilarityIndexMeasure(_MeanReducedImageMetric):
    """MS-SSIM."""

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        gaussian_kernel: bool = True,
        kernel_size: Union[int, Sequence[int]] = 11,
        sigma: Union[float, Sequence[float]] = 1.5,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[Union[float, Tuple[float, float]]] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
        normalize: Optional[str] = "relu",
        **kwargs: Any,
    ) -> None:
        super().__init__(reduction=reduction, **kwargs)
        if not (isinstance(kernel_size, (Sequence, int))):
            raise ValueError(
                f"Argument `kernel_size` expected to be an sequence or an int, or a single int. Got {kernel_size}"
            )
        if not isinstance(betas, tuple) or not all(isinstance(beta, float) for beta in betas):
            raise ValueError("Argument `betas` is expected to be of a type tuple of floats")
        if normalize and normalize not in ("relu", "simple"):
            raise ValueError("Argument `normalize` to be expected either `None` or one of 'relu' or 'simple'")
        self.gaussian_kernel = gaussian_kernel
        self.sigma = sigma
        self.kernel_size = kernel_size
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.betas = betas
        self.normalize = normalize

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _ssim_check_inputs(*self._inputs(preds, target))
        similarity = _multiscale_ssim_update(
            preds, target, self.gaussian_kernel, self.sigma, self.kernel_size, self.data_range, self.k1, self.k2,
            self.betas, self.normalize,
        )
        self._fold(similarity)

    def compute(self) -> Tensor:
        return self._finalize()


class _PairCatMetric(Metric):
    """Shared shell: the validated ``preds`` and ``target`` kept as ``cat`` states."""

    is_differentiable = True
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _check_image_pair(*self._inputs(preds, target))
        self.preds.append(preds)
        self.target.append(target)

    def _stream(self) -> Tuple[Tensor, Tensor]:
        return dim_zero_cat(self.preds), dim_zero_cat(self.target)


class UniversalImageQualityIndex(_PairCatMetric):
    """UQI."""

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        reduction: Optional[str] = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.reduction = reduction

    def compute(self) -> Tensor:
        return universal_image_quality_index(*self._stream(), self.kernel_size, self.sigma, self.reduction)


class ErrorRelativeGlobalDimensionlessSynthesis(_PairCatMetric):
    """ERGAS."""

    higher_is_better = False
    plot_lower_bound = 0.0

    def __init__(self, ratio: float = 4, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.ratio = ratio
        self.reduction = reduction

    def compute(self) -> Tensor:
        return _ergas_compute(*self._stream(), self.ratio, self.reduction)


class SpectralAngleMapper(_PairCatMetric):
    """SAM."""

    higher_is_better = False
    plot_lower_bound = 0.0
    plot_upper_bound = 3.1416

    def __init__(self, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.reduction = reduction

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _check_image_pair(*self._inputs(preds, target))
        if preds.shape[1] <= 1:
            raise ValueError(
                f"Expected channel dimension of `preds` and `target` to be larger than 1. Got {preds.shape[1]}."
            )
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        return _sam_compute(*self._stream(), self.reduction)


class SpatialCorrelationCoefficient(Metric):
    """SCC."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, hp_filter: Optional[Tensor] = None, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if hp_filter is None:
            hp_filter = [[-1.0, -1.0, -1.0], [-1.0, 8.0, -1.0], [-1.0, -1.0, -1.0]]
        self.hp_filter = _to_tensor(hp_filter, self._device).to(torch.float32)
        self.window_size = window_size
        self.add_state("scc_score", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        per_sample = spatial_correlation_coefficient(
            *self._inputs(preds, target), self.hp_filter.to(self._device), self.window_size, reduction="none"
        )
        self.scc_score = _jnp_add(self.scc_score, per_sample.sum())
        self.total = self.total + per_sample.shape[0]

    def compute(self) -> Tensor:
        return self.scc_score / self.total


class RelativeAverageSpectralError(_PairCatMetric):
    """RASE."""

    higher_is_better = False
    plot_lower_bound = 0.0

    def __init__(self, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(window_size, int) or window_size < 1:
            raise ValueError(f"Argument `window_size` is expected to be a positive integer, but got {window_size}")
        self.window_size = window_size

    def compute(self) -> Tensor:
        return relative_average_spectral_error(*self._stream(), self.window_size)


class RootMeanSquaredErrorUsingSlidingWindow(Metric):
    """RMSE-SW."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(window_size, int) or window_size < 1:
            raise ValueError("Argument `window_size` is expected to be a positive integer.")
        self.window_size = window_size
        self.add_state("rmse_val_sum", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total_images", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _check_image_pair(*self._inputs(preds, target))
        error = _uniform_filter((preds - target) ** 2, self.window_size)
        rmse_map = torch.sqrt(error)
        crop = round(self.window_size / 2)
        self.rmse_val_sum = _jnp_add(
            self.rmse_val_sum, torch.sum(torch.mean(rmse_map[:, :, crop:-crop, crop:-crop], dim=(1, 2, 3)))
        )
        self.total_images = self.total_images + preds.shape[0]

    def compute(self) -> Tensor:
        return self.rmse_val_sum / self.total_images


class TotalVariation(Metric):
    """TV."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, reduction: Optional[str] = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if reduction is not None and reduction not in ("sum", "mean", "none"):
            raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")
        self.reduction = reduction
        self.add_state("score_list", default=[], dist_reduce_fx="cat")
        self.add_state("score", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("num_elements", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, img: Tensor) -> None:
        score, num_elements = _total_variation_update(_to_tensor(img, self._device))
        if self.reduction is None or self.reduction == "none":
            self.score_list.append(score)
        else:
            self.score = _jnp_add(self.score, score.sum())
        self.num_elements = self.num_elements + num_elements

    def compute(self) -> Tensor:
        if self.reduction is None or self.reduction == "none":
            return dim_zero_cat(self.score_list)
        return _total_variation_compute(self.score, self.num_elements, self.reduction)


class _PanSharpeningMetric(Metric):
    """Shared shell of D_s and QNR: ``preds`` and the ``ms``/``pan`` (+ ``pan_lr``) dict kept as ``cat`` states."""

    is_differentiable = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("ms", default=[], dist_reduce_fx="cat")
        self.add_state("pan", default=[], dist_reduce_fx="cat")
        self.add_state("pan_lr", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: dict) -> None:
        """``target`` is a dict with ``ms`` and ``pan`` (and optionally ``pan_lr``)."""
        if "ms" not in target or "pan" not in target:
            raise ValueError(f"Expected `target` to contain keys ms and pan. Got target: {list(target)}.")
        self.preds.append(_to_tensor(preds, self._device))
        self.ms.append(_to_tensor(target["ms"], self._device))
        self.pan.append(_to_tensor(target["pan"], self._device))
        if "pan_lr" in target:
            self.pan_lr.append(_to_tensor(target["pan_lr"], self._device))

    def _stream(self) -> Tuple[Tensor, Tensor, Tensor, Optional[Tensor]]:
        pan_lr = dim_zero_cat(self.pan_lr) if self.pan_lr else None
        return dim_zero_cat(self.preds), dim_zero_cat(self.ms), dim_zero_cat(self.pan), pan_lr


class SpectralDistortionIndex(Metric):
    """D_lambda."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, p: int = 1, reduction: str = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(p, int) or p <= 0:
            raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
        self.p = p
        if reduction not in ("elementwise_mean", "sum", "none"):
            raise ValueError(f"Expected argument `reduction` be one of ['elementwise_mean', 'sum', 'none'], got {reduction}")
        self.reduction = reduction
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _spectral_distortion_index_update(*self._inputs(preds, target))
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        return _spectral_distortion_index_compute(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.p, self.reduction)


class SpatialDistortionIndex(_PanSharpeningMetric):
    """D_s."""

    higher_is_better = False

    def __init__(
        self, norm_order: int = 1, window_size: int = 7, reduction: str = "elementwise_mean", **kwargs: Any
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(norm_order, int) or norm_order <= 0:
            raise ValueError(f"Expected `norm_order` to be a positive integer. Got norm_order: {norm_order}.")
        self.norm_order = norm_order
        if not isinstance(window_size, int) or window_size <= 0:
            raise ValueError(f"Expected `window_size` to be a positive integer. Got window_size: {window_size}.")
        self.window_size = window_size
        self.reduction = reduction

    def compute(self) -> Tensor:
        preds, ms, pan, pan_lr = self._stream()
        return spatial_distortion_index(preds, ms, pan, pan_lr, self.norm_order, self.window_size, self.reduction)


class QualityWithNoReference(_PanSharpeningMetric):
    """QNR."""

    higher_is_better = True

    def __init__(
        self,
        alpha: float = 1.0,
        beta: float = 1.0,
        norm_order: int = 1,
        window_size: int = 7,
        reduction: str = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(alpha, (int, float)) or alpha < 0:
            raise ValueError(f"Expected `alpha` to be a non-negative real number. Got alpha: {alpha}.")
        self.alpha = alpha
        if not isinstance(beta, (int, float)) or beta < 0:
            raise ValueError(f"Expected `beta` to be a non-negative real number. Got beta: {beta}.")
        self.beta = beta
        self.norm_order = norm_order
        self.window_size = window_size
        self.reduction = reduction

    def compute(self) -> Tensor:
        preds, ms, pan, pan_lr = self._stream()
        return quality_with_no_reference(
            preds, ms, pan, pan_lr, self.alpha, self.beta, self.norm_order, self.window_size, self.reduction
        )


class VisualInformationFidelity(Metric):
    """VIF-p."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, sigma_n_sq: float = 2.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(sigma_n_sq, (float, int)) or sigma_n_sq < 0:
            raise ValueError(f"Argument `sigma_n_sq` is expected to be a positive float or int, but got {sigma_n_sq}")
        self.sigma_n_sq = sigma_n_sq
        self.add_state("vif_score", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = (t.to(torch.float32) for t in self._inputs(preds, target))
        preds, target = _check_image_pair(preds, target)
        per_image = torch.mean(_vif_per_channel(preds, target, self.sigma_n_sq), dim=1)
        self.vif_score = _jnp_add(self.vif_score, torch.sum(per_image))
        self.total = self.total + preds.shape[0]

    def compute(self) -> Tensor:
        return self.vif_score / self.total
