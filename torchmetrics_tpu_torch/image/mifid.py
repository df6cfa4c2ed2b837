# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Memorization-informed FID (counterpart of ``torchmetrics_tpu/image/mifid.py``).

The features are kept on the device; the compute runs on the host in
float64, as in JAX: the FID of the two feature sets and their thresholded
mean minimum cosine distance.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.image.fid import _ALLOWED_FEATURE_DIMS, _compute_fid, _extractor, _images
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import _to_tensor, dim_zero_cat

Tensor = torch.Tensor


def _compute_cosine_distance(features1: np.ndarray, features2: np.ndarray, cosine_distance_eps: float = 0.1) -> float:
    """Thresholded mean minimum cosine distance."""
    f1 = features1 / np.linalg.norm(features1, axis=1, keepdims=True)
    f2 = features2 / np.linalg.norm(features2, axis=1, keepdims=True)
    d = 1.0 - np.abs(f1 @ f2.T)
    mean_min_d = float(np.mean(d.min(axis=1)))
    return mean_min_d if mean_min_d < cosine_distance_eps else 1.0


def _mifid_compute(real: np.ndarray, fake: np.ndarray, cosine_distance_eps: float = 0.1) -> float:
    """FID over the thresholded memorization distance."""
    mu1, sigma1 = real.mean(axis=0), np.cov(real, rowvar=False)
    mu2, sigma2 = fake.mean(axis=0), np.cov(fake, rowvar=False)
    fid_value = _compute_fid(mu1, sigma1, mu2, sigma2)
    distance = _compute_cosine_distance(fake, real, cosine_distance_eps)
    return fid_value / (distance + 1e-15)


class MemorizationInformedFrechetInceptionDistance(Metric):
    """MiFID."""

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
        cosine_distance_eps: float = 0.1,
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
            self.inception: Callable = _extractor(feature, feature_extractor_params, tower_dtype, self._device)
        elif callable(feature):
            self.inception = feature
            self.used_custom_model = True
        else:
            raise TypeError("Got unknown input to argument `feature`")
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize
        if not (isinstance(cosine_distance_eps, float) and 1 >= cosine_distance_eps > 0):
            raise ValueError("Argument `cosine_distance_eps` expected to be a float greater than 0 and less than 1")
        self.cosine_distance_eps = cosine_distance_eps

        self.add_state("real_features", [], dist_reduce_fx=None)
        self.add_state("fake_features", [], dist_reduce_fx=None)

    def update(self, imgs: Tensor, real: bool) -> None:
        imgs = _images(imgs, self.normalize, self.used_custom_model, self._device)
        features = _to_tensor(self.inception(imgs), self._device)
        if features.ndim == 1:
            features = features[None, :]
        (self.real_features if real else self.fake_features).append(features)

    def compute(self) -> Tensor:
        real = dim_zero_cat(self.real_features).detach().to(torch.float64).cpu().numpy()
        fake = dim_zero_cat(self.fake_features).detach().to(torch.float64).cpu().numpy()
        return torch.tensor(_mifid_compute(real, fake, self.cosine_distance_eps), dtype=torch.float32, device=self._device)

    def reset(self) -> None:
        """Reset, keeping the real features unless ``reset_real_features``."""
        if not self.reset_real_features:
            real_features = self.real_features
            super().reset()
            self.real_features = real_features
        else:
            super().reset()
