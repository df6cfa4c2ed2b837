# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""CLIPScore (counterpart of ``torchmetrics_tpu/functional/multimodal/clip_score.py``).

The towers are transformers' PyTorch ``CLIPModel`` (or any module with its
``get_image_features``/``get_text_features``), where JAX runs the Flax
class. ``model``/``processor`` are injectable, as in JAX, which keeps the
metric usable offline; the default model is read from the local Hugging
Face cache only: nothing is downloaded. The processor runs on host numpy,
as in JAX; the towers run on the metric's device, the card unless the
caller asks for the CPU, in float32 with TF32 off (:func:`_fp32_towers`).
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.image.helpers import fp32_convolutions
from torchmetrics_tpu_torch.functional.text.bert import _model_device
from torchmetrics_tpu_torch.metric import _JAX_CANONICAL
from torchmetrics_tpu_torch.utilities.imports import _TRANSFORMERS_AVAILABLE
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor


@contextmanager
def _fp32_towers() -> Iterator[None]:
    """The towers in float32 for the block: cuDNN's convolutions (the patch
    embedding) with TF32 off and float32 matmuls at ``"highest"`` precision,
    the flags restored afterwards; no autograd."""
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with fp32_convolutions(), torch.no_grad():
            yield
    finally:
        torch.set_float32_matmul_precision(precision)


def _projected(out: Any) -> Tensor:
    """The projected features from ``get_image_features``/``get_text_features``:
    transformers returns the tensor itself in some versions and a model
    output holding it in others."""
    if isinstance(out, Tensor):
        return out
    for key in ("image_embeds", "text_embeds", "pooler_output"):
        value = getattr(out, key, None)
        if isinstance(value, Tensor):
            return value
    raise TypeError(f"cannot read projected features from a {type(out).__name__}")


def _unit(x: Tensor) -> Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _as_tensor(x: Any) -> Tensor:
    """An input as a tensor where it lies (numpy on the host), in ``jnp.asarray``'s dtype, as JAX's
    inputs reach its processor."""
    t = x if isinstance(x, Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(_JAX_CANONICAL.get(t.dtype, t.dtype))


def _host(x: Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _image_features(model: Any, pixel_values: np.ndarray, device: torch.device) -> Tensor:
    """Unit-norm image features of the processor's ``pixel_values`` on ``device``."""
    with _fp32_towers():
        out = model.get_image_features(torch.from_numpy(np.ascontiguousarray(pixel_values)).to(device))
    return _unit(_projected(out))


def _text_features(model: Any, input_ids: np.ndarray, attention_mask: np.ndarray, device: torch.device) -> Tensor:
    """Unit-norm text features of the processor's token ids on ``device``."""
    ids = torch.from_numpy(np.ascontiguousarray(input_ids)).to(device, torch.long)
    mask = torch.from_numpy(np.ascontiguousarray(attention_mask)).to(device, torch.long)
    with _fp32_towers():
        out = model.get_text_features(input_ids=ids, attention_mask=mask)
    return _unit(_projected(out))


def _get_clip_model_and_processor(
    model_name_or_path: str = "openai/clip-vit-large-patch14",
    model: Optional[Any] = None,
    processor: Optional[Callable] = None,
    device: Optional[Any] = None,
) -> Tuple[Any, Callable]:
    """The injected pair as it is, or transformers' ``CLIPModel`` and
    ``CLIPProcessor`` from the local cache (nothing is downloaded), the
    model moved to ``device`` (the card unless given)."""
    if model is not None and processor is not None:
        return model, processor
    if not _TRANSFORMERS_AVAILABLE:
        raise ModuleNotFoundError(
            "`clip_score` metric requires `transformers` package be installed."
            " Either install with `pip install transformers>=4.10.0` or `pip install torchmetrics[multimodal]`."
        )
    from transformers import CLIPModel, CLIPProcessor

    model = CLIPModel.from_pretrained(model_name_or_path, local_files_only=True)
    processor = CLIPProcessor.from_pretrained(model_name_or_path, local_files_only=True)
    return model.eval().to(device if device is not None else "cuda"), processor


def _clip_score_update(
    images: Union[Tensor, np.ndarray, List[Any]],
    text: Union[str, List[str]],
    model: Any,
    processor: Callable,
    device: Optional[Any] = None,
) -> Tuple[Tensor, int]:
    """Per-pair ``100 * cos`` of image and caption features, and the number of pairs."""
    if not isinstance(images, list):
        images = _as_tensor(images)
        images = [images] if images.ndim == 3 else list(images)
    else:
        images = [_as_tensor(i) for i in images]
    if not all(i.ndim == 3 for i in images):
        raise ValueError("Expected all images to be 3d but found image that has either more or less")
    if not isinstance(text, list):
        text = [text]
    if len(text) != len(images):
        raise ValueError(
            f"Expected the number of images and text examples to be the same but got {len(images)} and {len(text)}"
        )
    run_on = _model_device(model, device)
    processed = processor(text=text, images=[_host(i) for i in images], return_tensors="np", padding=True)
    img_features = _image_features(model, processed["pixel_values"], run_on)

    max_position_embeddings = model.config.text_config.max_position_embeddings
    input_ids = np.asarray(processed["input_ids"])
    attention_mask = np.asarray(processed["attention_mask"])
    if attention_mask.shape[-1] > max_position_embeddings:
        rank_zero_warn(
            f"Encountered caption longer than max_position_embeddings={max_position_embeddings}."
            " Will truncate captions to this length."
            " If longer captions are needed, initialize argument `model_name_or_path` with a model that supports"
            " longer sequences",
            UserWarning,
        )
        attention_mask = attention_mask[..., :max_position_embeddings]
        input_ids = input_ids[..., :max_position_embeddings]
    txt_features = _text_features(model, input_ids, attention_mask, run_on)

    score = 100 * (img_features * txt_features).sum(dim=-1)
    return score, len(text)


def clip_score(
    images: Union[Tensor, np.ndarray, List[Any]],
    text: Union[str, List[str]],
    model_name_or_path: str = "openai/clip-vit-large-patch14",
    model: Optional[Any] = None,
    processor: Optional[Callable] = None,
    device: Optional[Any] = None,
) -> Tensor:
    """CLIPScore: the mean over the pairs of ``100 * cos(E_I, E_C)``, clamped at 0.

    The towers run on ``device`` if given, else where ``model``'s parameters
    are (the default model is moved to the card).
    """
    model, processor = _get_clip_model_and_processor(model_name_or_path, model, processor, device)
    score, _ = _clip_score_update(images, text, model, processor, device)
    return torch.clamp(score.mean(), min=0.0)
