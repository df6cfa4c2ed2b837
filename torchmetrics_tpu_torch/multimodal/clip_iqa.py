# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""CLIP-IQA module metric (counterpart of ``torchmetrics_tpu/multimodal/clip_iqa.py``)."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.multimodal.clip_iqa import (
    _clip_iqa_compute,
    _clip_iqa_format_prompts,
    _clip_iqa_get_anchor_vectors,
    _clip_iqa_update,
)
from torchmetrics_tpu_torch.functional.multimodal.clip_score import _as_tensor, _get_clip_model_and_processor
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

Tensor = torch.Tensor


class CLIPImageQualityAssessment(Metric):
    """CLIP-IQA: the positive prompt's probability for each image and prompt pair.

    The state is the unit-norm image features (a ``cat`` list,
    ``dist_reduce_fx=None``); the prompts' text anchors are computed at the
    first ``compute`` and kept. The towers run on the metric's device, where
    an injected model must be (the default model is moved there).
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        model_name_or_path: str = "openai/clip-vit-base-patch16",
        data_range: float = 1.0,
        prompts: Tuple[Union[str, Tuple[str, str]], ...] = ("quality",),
        model: Optional[Any] = None,
        processor: Optional[Callable] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.prompts_list, self.prompts_names = _clip_iqa_format_prompts(prompts)
        self.model, self.processor = _get_clip_model_and_processor(model_name_or_path, model, processor, self.device)
        if not (isinstance(data_range, (int, float)) and data_range > 0):
            raise ValueError("Argument `data_range` should be a positive number.")
        self.data_range = data_range
        self._anchors: Optional[Tensor] = None
        self.add_state("img_features", [], dist_reduce_fx=None)

    @property
    def anchors(self) -> Tensor:
        """The prompts' unit-norm text features, computed once."""
        if self._anchors is None:
            self._anchors = _clip_iqa_get_anchor_vectors(self.model, self.processor, self.prompts_list, self.device)
        return self._anchors

    def update(self, images: Tensor) -> None:
        """Append the batch's unit-norm image features."""
        images = _as_tensor(images)
        if images.ndim != 4 or images.shape[1] != 3:
            raise ValueError(f"Expected 4d image batch in NCHW format, got shape {tuple(images.shape)}")
        self.img_features.append(_clip_iqa_update(images, self.model, self.processor, self.data_range, self.device))

    def compute(self) -> Union[Tensor, Dict[str, Tensor]]:
        img_features = dim_zero_cat(self.img_features)
        return _clip_iqa_compute(img_features, self.anchors, self.prompts_names)

    def plot(self, val=None, ax=None):
        return self._plot(val, ax)
