# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Kernel inception distance (counterpart of ``torchmetrics_tpu/image/kid.py``).

The subsets are drawn on the host with ``np.random.RandomState(seed)``, as
JAX draws them, so both packages score the same subsets; the polynomial
kernels and the MMD run on the device.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.image.fid import _extractor, _images
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import _to_tensor, dim_zero_cat

Tensor = torch.Tensor


def maximum_mean_discrepancy(k_xx: Tensor, k_xy: Tensor, k_yy: Tensor) -> Tensor:
    """Unbiased MMD estimate."""
    m = k_xx.shape[0]
    diag_x = torch.diagonal(k_xx)
    diag_y = torch.diagonal(k_yy)
    kt_xx_sum = (k_xx.sum(dim=-1) - diag_x).sum()
    kt_yy_sum = (k_yy.sum(dim=-1) - diag_y).sum()
    k_xy_sum = k_xy.sum()
    value = (kt_xx_sum + kt_yy_sum) / (m * (m - 1))
    return value - 2 * k_xy_sum / (m**2)


def poly_kernel(f1: Tensor, f2: Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0) -> Tensor:
    """Polynomial kernel."""
    if gamma is None:
        gamma = 1.0 / f1.shape[1]
    return (f1 @ f2.T * gamma + coef) ** degree


def poly_mmd(f_real: Tensor, f_fake: Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0) -> Tensor:
    """MMD with polynomial kernels."""
    k_11 = poly_kernel(f_real, f_real, degree, gamma, coef)
    k_22 = poly_kernel(f_fake, f_fake, degree, gamma, coef)
    k_12 = poly_kernel(f_real, f_fake, degree, gamma, coef)
    return maximum_mean_discrepancy(k_11, k_12, k_22)


class KernelInceptionDistance(Metric):
    """KID over random feature subsets."""

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    feature_network: str = "inception"
    plot_lower_bound = 0.0

    def __init__(
        self,
        feature: Union[int, Callable] = 2048,
        subsets: int = 100,
        subset_size: int = 1000,
        degree: int = 3,
        gamma: Optional[float] = None,
        coef: float = 1.0,
        reset_real_features: bool = True,
        normalize: bool = False,
        seed: int = 42,
        feature_extractor_params: Optional[dict] = None,
        tower_dtype: Any = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.used_custom_model = False
        if isinstance(feature, int):
            self.inception: Callable = _extractor(feature, feature_extractor_params, tower_dtype, self._device)
        elif callable(feature):
            self.inception = feature
            self.used_custom_model = True
        else:
            raise TypeError("Got unknown input to argument `feature`")
        if not (isinstance(subsets, int) and subsets > 0):
            raise ValueError("Argument `subsets` expected to be integer larger than 0")
        self.subsets = subsets
        if not (isinstance(subset_size, int) and subset_size > 0):
            raise ValueError("Argument `subset_size` expected to be integer larger than 0")
        self.subset_size = subset_size
        if not (isinstance(degree, int) and degree > 0):
            raise ValueError("Argument `degree` expected to be integer larger than 0")
        self.degree = degree
        if gamma is not None and not (isinstance(gamma, float) and gamma > 0):
            raise ValueError("Argument `gamma` expected to be `None` or float larger than 0")
        self.gamma = gamma
        if not (isinstance(coef, float) and coef > 0):
            raise ValueError("Argument `coef` expected to be float larger than 0")
        self.coef = coef
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize
        self.seed = seed

        self.add_state("real_features", [], dist_reduce_fx=None)
        self.add_state("fake_features", [], dist_reduce_fx=None)

    def update(self, imgs: Tensor, real: bool) -> None:
        """Append the batch's features."""
        imgs = _images(imgs, self.normalize, self.used_custom_model, self._device)
        features = _to_tensor(self.inception(imgs), self._device)
        (self.real_features if real else self.fake_features).append(features)

    def compute(self) -> Tuple[Tensor, Tensor]:
        """Mean and standard deviation of the MMD over ``subsets`` host-drawn subsets."""
        real_features = dim_zero_cat(self.real_features)
        fake_features = dim_zero_cat(self.fake_features)
        n_samples_real = real_features.shape[0]
        if n_samples_real < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")
        n_samples_fake = fake_features.shape[0]
        if n_samples_fake < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")

        rng = np.random.RandomState(self.seed)
        kid_scores_ = []
        for _ in range(self.subsets):
            perm = torch.as_tensor(rng.permutation(n_samples_real)[: self.subset_size], device=real_features.device)
            f_real = real_features[perm]
            perm = torch.as_tensor(rng.permutation(n_samples_fake)[: self.subset_size], device=fake_features.device)
            f_fake = fake_features[perm]
            kid_scores_.append(poly_mmd(f_real, f_fake, self.degree, self.gamma, self.coef))
        kid_scores = torch.stack(kid_scores_)
        return kid_scores.mean(), kid_scores.std(correction=1)

    def reset(self) -> None:
        """Reset, keeping the real features unless ``reset_real_features``."""
        if not self.reset_real_features:
            real_features = self.real_features
            super().reset()
            self.real_features = real_features
        else:
            super().reset()
