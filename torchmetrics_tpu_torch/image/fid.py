# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Fréchet inception distance (counterpart of ``torchmetrics_tpu/image/fid.py``).

The Inception features and the streaming sum / covariance-sum states stay
on the device (all ``"sum"``-reduced, float32 as JAX keeps them with 64-bit
types off); the trace of the matrix square root runs on the host in float64
(``np.linalg.eigvals`` of the d x d product), as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.image.backbones.inception import InceptionFeatureExtractor
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import _to_tensor

Tensor = torch.Tensor

_ALLOWED_FEATURE_DIMS = (64, 192, 768, 2048)


def _compute_fid(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray) -> float:
    """``||μ1-μ2||² + Tr(Σ1 + Σ2 - 2√(Σ1Σ2))`` via the eigenvalues of ``Σ1Σ2``, float64 on the host."""
    a = float(np.square(mu1 - mu2).sum())
    b = float(np.trace(sigma1) + np.trace(sigma2))
    eigvals = np.linalg.eigvals(sigma1 @ sigma2)
    c = float(np.sqrt(eigvals.astype(np.complex128)).real.sum())
    return a + b - 2 * c


def _images(imgs: Any, normalize: bool, used_custom_model: bool, device: torch.device) -> Tensor:
    """The batch on the metric's device; ``[0, 1]`` floats become uint8 for the built-in tower."""
    imgs = _to_tensor(imgs, device)
    if normalize and not used_custom_model:
        imgs = (imgs * 255).to(torch.uint8)
    return imgs


def _extractor(feature: Any, params: Optional[dict], tower_dtype: Any, device: torch.device) -> InceptionFeatureExtractor:
    return InceptionFeatureExtractor((str(feature),), params=params, dtype=tower_dtype, device=device)


class FrechetInceptionDistance(Metric):
    """FID.

    ``feature`` is a tap width of the built-in InceptionV3 or a callable
    mapping an image batch to ``(N, d)`` features. ``feature_extractor_params``
    is the tower's state dict or JAX's flax variables; ``tower_dtype`` its
    conv dtype (``None``: float32; ``torch.bfloat16`` when asked).
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    feature_network: str = "inception"
    plot_lower_bound = 0.0

    def __init__(
        self,
        feature: Union[int, Callable] = 2048,
        reset_real_features: bool = True,
        normalize: bool = False,
        input_img_size: Any = None,
        feature_extractor_params: Optional[dict] = None,
        tower_dtype: Any = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.used_custom_model = False
        if isinstance(feature, int):
            if feature not in _ALLOWED_FEATURE_DIMS:
                raise ValueError(
                    f"Integer input to argument `feature` must be one of {_ALLOWED_FEATURE_DIMS}, but got {feature}."
                )
            num_features = feature
            self.inception = _extractor(feature, feature_extractor_params, tower_dtype, self._device)
        elif callable(feature):
            self.inception = feature
            self.used_custom_model = True
            dummy = torch.zeros((1, 3, 64, 64), dtype=torch.float32 if normalize else torch.uint8, device=self._device)
            num_features = int(feature(dummy).shape[-1])
        else:
            raise TypeError("Got unknown input to argument `feature`")
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize

        for kind in ("real", "fake"):
            self.add_state(f"{kind}_features_sum", torch.zeros(num_features), dist_reduce_fx="sum")
            self.add_state(f"{kind}_features_cov_sum", torch.zeros((num_features, num_features)), dist_reduce_fx="sum")
            self.add_state(f"{kind}_features_num_samples", 0, dist_reduce_fx="sum")

    def update(self, imgs: Tensor, real: bool) -> None:
        """Extract features and fold their sum, their outer-product sum and their count."""
        imgs = _images(imgs, self.normalize, self.used_custom_model, self._device)
        features = _to_tensor(self.inception(imgs), self._device)
        if features.ndim == 1:
            features = features[None, :]
        kind = "real" if real else "fake"
        s, c, n = (getattr(self, f"{kind}_features_{k}") for k in ("sum", "cov_sum", "num_samples"))
        features = features.to(s.dtype)
        setattr(self, f"{kind}_features_sum", s + features.sum(dim=0))
        setattr(self, f"{kind}_features_cov_sum", c + features.T @ features)
        setattr(self, f"{kind}_features_num_samples", n + imgs.shape[0])

    def compute(self) -> Tensor:
        """Means and covariances from the streaming sums; the trace square root in float64 on the host."""
        if int(self.real_features_num_samples) < 2 or int(self.fake_features_num_samples) < 2:
            raise RuntimeError("More than one sample is required for both the real and fake distributed to compute FID")
        stats = []
        for kind in ("real", "fake"):
            n = np.float64(int(getattr(self, f"{kind}_features_num_samples")))
            mean = getattr(self, f"{kind}_features_sum").detach().to(torch.float64).cpu().numpy() / n
            cov_sum = getattr(self, f"{kind}_features_cov_sum").detach().to(torch.float64).cpu().numpy()
            stats += [mean, (cov_sum - n * np.outer(mean, mean)) / (n - 1)]
        return torch.tensor(_compute_fid(*stats), dtype=torch.float32, device=self._device)

    def reset(self) -> None:
        """Reset, keeping the real distribution's statistics unless ``reset_real_features``."""
        if not self.reset_real_features:
            kept = {k: getattr(self, k) for k in ("real_features_sum", "real_features_cov_sum", "real_features_num_samples")}
            super().reset()
            for key, value in kept.items():
                setattr(self, key, value)
        else:
            super().reset()
