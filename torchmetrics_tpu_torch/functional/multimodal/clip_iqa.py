# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""CLIP image quality assessment (counterpart of ``torchmetrics_tpu/functional/multimodal/clip_iqa.py``).

A softmax over each pair of prompts of the CLIP similarities between the
images and the prompts' unit-norm text anchors, keeping the positive
prompt's probability. The towers and the processor are those of
:mod:`~torchmetrics_tpu_torch.functional.multimodal.clip_score`; the
arithmetic after them is plain PyTorch on the towers' device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.multimodal.clip_score import (
    _as_tensor,
    _get_clip_model_and_processor,
    _host,
    _image_features,
    _text_features,
)
from torchmetrics_tpu_torch.functional.text.bert import _model_device

Tensor = torch.Tensor

_PROMPTS: Dict[str, Tuple[str, str]] = {
    "quality": ("Good photo.", "Bad photo."),
    "brightness": ("Bright photo.", "Dark photo."),
    "noisiness": ("Clean photo.", "Noisy photo."),
    "colorfullness": ("Colorful photo.", "Dull photo."),
    "sharpness": ("Sharp photo.", "Blurry photo."),
    "contrast": ("High contrast photo.", "Low contrast photo."),
    "complexity": ("Complex photo.", "Simple photo."),
    "natural": ("Natural photo.", "Synthetic photo."),
    "happy": ("Happy photo.", "Sad photo."),
    "scary": ("Scary photo.", "Peaceful photo."),
    "new": ("New photo.", "Old photo."),
    "warm": ("Warm photo.", "Cold photo."),
    "real": ("Real photo.", "Abstract photo."),
    "beautiful": ("Beautiful photo.", "Ugly photo."),
    "lonely": ("Lonely photo.", "Sociable photo."),
    "relaxing": ("Relaxing photo.", "Stressful photo."),
}


def _clip_iqa_format_prompts(prompts: Tuple[Union[str, Tuple[str, str]], ...] = ("quality",)) -> Tuple[List[str], List[str]]:
    """The prompt texts (two a pair) and a name a pair: each keyword's pair, then each custom pair as ``user_defined_<i>``."""
    if not isinstance(prompts, tuple):
        raise ValueError("Argument `prompts` must be a tuple containing strings or tuples of strings")
    prompts_names: List[str] = []
    prompts_list: List[str] = []
    count = 0
    for p in prompts:
        if not isinstance(p, (str, tuple)):
            raise ValueError("Argument `prompts` must be a tuple containing strings or tuples of strings")
        if isinstance(p, str):
            if p not in _PROMPTS:
                raise ValueError(
                    f"All elements of `prompts` must be one of {_PROMPTS.keys()} if not custom tuple prompts, got {p}."
                )
            prompts_names.append(p)
            prompts_list.extend(_PROMPTS[p])
        else:
            if len(p) != 2:
                raise ValueError("If a tuple is provided in argument `prompts`, it must be of length 2")
            prompts_names.append(f"user_defined_{count}")
            prompts_list.extend(p)
            count += 1
    return prompts_list, prompts_names


def _clip_iqa_get_anchor_vectors(
    model: Any, processor: Callable, prompts_list: List[str], device: Optional[Any] = None
) -> Tensor:
    """Unit-norm text features of the prompts, on ``device`` (else where the model is)."""
    processed = processor(text=prompts_list, return_tensors="np", padding=True)
    return _text_features(
        model, np.asarray(processed["input_ids"]), np.asarray(processed["attention_mask"]), _model_device(model, device)
    )


def _clip_iqa_update(
    images: Union[Tensor, np.ndarray], model: Any, processor: Callable, data_range: float, device: Optional[Any] = None
) -> Tensor:
    """Unit-norm image features of ``images / data_range``."""
    images = _as_tensor(images) / float(data_range)
    processed = processor(images=[_host(i) for i in images], return_tensors="np", padding=True)
    return _image_features(model, processed["pixel_values"], _model_device(model, device))


def _clip_iqa_compute(
    img_features: Tensor,
    anchors: Tensor,
    prompts_names: List[str],
    format_as_dict: bool = True,
) -> Union[Tensor, Dict[str, Tensor]]:
    """The positive prompt's probability for each image and pair: squeezed for one
    pair, else a dict by pair name, or the ``(N, pairs)`` matrix with ``format_as_dict=False``."""
    logits_per_image = 100 * img_features @ anchors.T
    probs = torch.softmax(logits_per_image.reshape(logits_per_image.shape[0], -1, 2), dim=-1)[:, :, 0]
    if len(prompts_names) == 1:
        return probs.squeeze()
    if format_as_dict:
        return {p: probs[:, i] for i, p in enumerate(prompts_names)}
    return probs


def clip_image_quality_assessment(
    images: Union[Tensor, np.ndarray],
    model_name_or_path: str = "openai/clip-vit-base-patch16",
    data_range: float = 1.0,
    prompts: Tuple[Union[str, Tuple[str, str]], ...] = ("quality",),
    model: Optional[Any] = None,
    processor: Optional[Callable] = None,
    device: Optional[Any] = None,
) -> Union[Tensor, Dict[str, Tensor]]:
    """CLIP-IQA of an ``(N, 3, H, W)`` batch: see :func:`_clip_iqa_compute` for the forms.

    The towers run on ``device`` if given, else where ``model``'s parameters
    are (the default model is moved to the card).
    """
    prompts_list, prompts_names = _clip_iqa_format_prompts(prompts)
    model, processor = _get_clip_model_and_processor(model_name_or_path, model, processor, device)
    images = _as_tensor(images)
    if images.ndim != 4 or images.shape[1] != 3:
        raise ValueError(f"Expected 4d image batch in NCHW format, got shape {tuple(images.shape)}")
    anchors = _clip_iqa_get_anchor_vectors(model, processor, prompts_list, device)
    img_features = _clip_iqa_update(images, model, processor, data_range, device)
    return _clip_iqa_compute(img_features, anchors, prompts_names)
