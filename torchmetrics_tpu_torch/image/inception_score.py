# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Inception score (counterpart of ``torchmetrics_tpu/image/inception_score.py``).

The features are permuted with ``np.random.RandomState(42)`` and split as
``np.array_split`` splits (``torch.tensor_split``), as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.image.fid import _extractor, _images
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import _to_tensor, dim_zero_cat
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor


class InceptionScore(Metric):
    """IS over random splits."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    feature_network: str = "inception"
    plot_lower_bound = 0.0

    def __init__(
        self,
        feature: Union[str, int, Callable] = "logits_unbiased",
        splits: int = 10,
        normalize: bool = False,
        feature_extractor_params: Optional[dict] = None,
        tower_dtype: Any = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        rank_zero_warn(
            "Metric `InceptionScore` will save all extracted features in buffer."
            " For large datasets this may lead to large memory footprint.",
            UserWarning,
        )
        self.used_custom_model = False
        if isinstance(feature, (str, int)):
            valid_int_input = ("logits_unbiased", 64, 192, 768, 2048)
            if feature not in valid_int_input:
                raise ValueError(
                    f"Integer input to argument `feature` must be one of {valid_int_input}, but got {feature}."
                )
            self.inception: Callable = _extractor(feature, feature_extractor_params, tower_dtype, self._device)
        elif callable(feature):
            self.inception = feature
            self.used_custom_model = True
        else:
            raise TypeError("Got unknown input to argument `feature`")
        if not (isinstance(splits, int) and splits > 0):
            raise ValueError("Expected argument `splits` to be an integer larger than 0")
        self.splits = splits
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize
        self.add_state("features", [], dist_reduce_fx=None)

    def update(self, imgs: Tensor) -> None:
        """Append the batch's logits."""
        imgs = _images(imgs, self.normalize, self.used_custom_model, self._device)
        self.features.append(_to_tensor(self.inception(imgs), self._device))

    def compute(self) -> Tuple[Tensor, Tensor]:
        """Mean and standard deviation of ``exp(KL(p(y|x) || p(y)))`` over the splits."""
        features = dim_zero_cat(self.features)
        idx = torch.as_tensor(np.random.RandomState(42).permutation(features.shape[0]), device=features.device)
        features = features[idx]
        prob = torch.softmax(features, dim=1)
        log_prob = torch.log_softmax(features, dim=1)
        prob_chunks = torch.tensor_split(prob, self.splits, dim=0)
        log_prob_chunks = torch.tensor_split(log_prob, self.splits, dim=0)
        mean_prob = [p.mean(dim=0, keepdim=True) for p in prob_chunks]
        kl_ = [
            (p * (log_p - torch.log(m_p))).sum(dim=1).mean()
            for p, log_p, m_p in zip(prob_chunks, log_prob_chunks, mean_prob)
        ]
        kl = torch.exp(torch.stack(kl_))
        return kl.mean(), kl.std(correction=1)
