# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""CLIP weights carried from a Flax parameter tree into PyTorch.

:func:`clip_params_from_jax` turns the parameter tree of a Flax CLIP
(``FlaxCLIPModel``, as nested dicts of numpy arrays) into a ``state_dict``
of transformers' PyTorch ``CLIPModel``, so CLIPScore and CLIP-IQA can run
the weights the JAX package runs. Standard library, numpy and torch only:
it reads no Flax.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from torchmetrics_tpu_torch.text.weights import _leaves

#: the state_dict entries a tree has no leaf for: the position ids buffers
_BUFFERS = ("position_ids",)


def clip_params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A PyTorch ``state_dict`` of the Flax CLIP parameter ``tree``.

    A Dense ``kernel`` (in, out) becomes ``weight`` (out, in), the patch
    embedding's convolution ``kernel`` (H, W, in, out) ``weight`` (out, in,
    H, W); ``embedding`` and LayerNorm's ``scale`` become ``weight``; every
    other leaf (``class_embedding``, the scalar ``logit_scale``, biases)
    keeps its name and values. Layers are ``encoder.layers.<i>`` in both. A
    tree under ``{"params": ...}`` is unwrapped.
    """
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(tree):
        value = np.asarray(leaf, dtype=np.float32)
        *head, name = path
        if name == "kernel":
            name, value = "weight", (value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T)
        elif name in ("embedding", "scale"):
            name = "weight"
        # a C-ordered copy the tensor owns (np.ascontiguousarray would make the 0-d logit_scale 1-d)
        out[".".join((*head, name))] = torch.from_numpy(value.copy(order="C"))
    return out


def load_clip_params(model: torch.nn.Module, tree: Mapping[str, Any]) -> torch.nn.Module:
    """Load :func:`clip_params_from_jax` of ``tree`` into ``model``; raises if a
    parameter is left out, a leaf has no place or a shape differs."""
    params = clip_params_from_jax(tree)
    own = model.state_dict()
    missing = [k for k in own if k not in params and not k.endswith(_BUFFERS)]
    unexpected = [k for k in params if k not in own]
    misshapen = [k for k in params if k in own and tuple(own[k].shape) != tuple(params[k].shape)]
    if missing or unexpected or misshapen:
        raise ValueError(
            f"the Flax tree does not fit {type(model).__name__}: missing {missing}, unexpected {unexpected},"
            f" misshapen {misshapen}"
        )
    model.load_state_dict(params, strict=False)
    return model


__all__ = ["clip_params_from_jax", "load_clip_params"]
