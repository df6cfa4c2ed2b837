# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Learned perceptual image patch similarity (counterpart of
``torchmetrics_tpu/image/lpip.py``), NCHW.

A feature trunk (AlexNet, VGG16 or SqueezeNet1_1 feature stages), each tap
unit-normalised over channels, squared differences projected by 1x1 linear
heads, averaged over space and summed over the taps. The calibrated heads
load from the port's own copy of the JAX package's ``.npz`` files
(``image/weights/lpips_heads_{alex,vgg,squeeze}.npz``); the trunks are
seeded (a ``torch.Generator`` seeded 0, not JAX's flax init) unless a
weight tree is given: the port's ``state_dict`` or JAX's flax tree, carried
across by :func:`lpips_params_from_jax`. Every convolution runs with cuDNN's
TF32 off; LPIPS stays differentiable in its inputs.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torchmetrics_tpu_torch.functional.image.helpers import conv2d
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import _to_tensors

Tensor = torch.Tensor

_WEIGHTS_DIR = os.path.join(os.path.dirname(__file__), "weights")

# the ImageNet normalisation of LPIPS's scaling layer
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class _Conv(nn.Conv2d):
    """A conv with bias run through the TF32-off helper."""

    def forward(self, x: Tensor) -> Tensor:
        return conv2d(x, self.weight, self.bias, stride=self.stride, padding=self.padding)


class _AlexTrunk(nn.Module):
    """AlexNet feature stages (5 taps)."""

    widths = (64, 192, 384, 256, 256)

    def __init__(self) -> None:
        super().__init__()
        self.conv1 = _Conv(3, 64, 11, stride=4, padding=2)
        self.conv2 = _Conv(64, 192, 5, padding=2)
        self.conv3 = _Conv(192, 384, 3, padding=1)
        self.conv4 = _Conv(384, 256, 3, padding=1)
        self.conv5 = _Conv(256, 256, 3, padding=1)

    def forward(self, x: Tensor) -> List[Tensor]:
        taps = [torch.relu(self.conv1(x))]
        taps.append(torch.relu(self.conv2(F.max_pool2d(taps[-1], 3, 2))))
        taps.append(torch.relu(self.conv3(F.max_pool2d(taps[-1], 3, 2))))
        taps.append(torch.relu(self.conv4(taps[-1])))
        taps.append(torch.relu(self.conv5(taps[-1])))
        return taps


class _VGG16Trunk(nn.Module):
    """VGG16 feature stages (5 taps: relu1_2 ... relu5_3)."""

    widths = (64, 128, 256, 512, 512)
    _CFG = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

    def __init__(self) -> None:
        super().__init__()
        idx, in_ch = 0, 3
        for width, convs in self._CFG:
            for _ in range(convs):
                self.add_module(f"conv{idx}", _Conv(in_ch, width, 3, padding=1))
                idx, in_ch = idx + 1, width

    def forward(self, x: Tensor) -> List[Tensor]:
        taps, idx = [], 0
        for stage, (_, convs) in enumerate(self._CFG):
            for _ in range(convs):
                x = torch.relu(getattr(self, f"conv{idx}")(x))
                idx += 1
            taps.append(x)
            if stage < len(self._CFG) - 1:
                x = F.max_pool2d(x, 2, 2)
        return taps


class _SqueezeTrunk(nn.Module):
    """SqueezeNet1_1 feature stages (7 taps)."""

    widths = (64, 128, 256, 384, 384, 512, 512)
    # (torchvision features index, squeeze channels, expand channels) of each Fire module
    _FIRES = ((3, 16, 64), (4, 16, 64), (6, 32, 128), (7, 32, 128), (9, 48, 192), (10, 48, 192), (11, 64, 256), (12, 64, 256))

    def __init__(self) -> None:
        super().__init__()
        self.conv0 = _Conv(3, 64, 3, stride=2)
        in_ch = 64
        for idx, squeeze, expand in self._FIRES:
            self.add_module(f"fire{idx}_squeeze", _Conv(in_ch, squeeze, 1))
            self.add_module(f"fire{idx}_e1", _Conv(squeeze, expand, 1))
            self.add_module(f"fire{idx}_e3", _Conv(squeeze, expand, 3, padding=1))
            in_ch = 2 * expand

    def _fire(self, x: Tensor, idx: int) -> Tensor:
        s = torch.relu(getattr(self, f"fire{idx}_squeeze")(x))
        return torch.cat([torch.relu(getattr(self, f"fire{idx}_e1")(s)), torch.relu(getattr(self, f"fire{idx}_e3")(s))], dim=1)

    def forward(self, x: Tensor) -> List[Tensor]:
        x = torch.relu(self.conv0(x))
        taps = [x]
        x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        x = self._fire(self._fire(x, 3), 4)
        taps.append(x)
        x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        x = self._fire(self._fire(x, 6), 7)
        taps.append(x)
        x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        for idx in (9, 10, 11, 12):
            x = self._fire(x, idx)
            taps.append(x)
        return taps


_TRUNKS = {"alex": _AlexTrunk, "vgg": _VGG16Trunk, "squeeze": _SqueezeTrunk}


class _LPIPSNet(nn.Module):
    """Trunk taps, unit-normalised, squared differences, 1x1 heads, spatial mean, summed over the taps."""

    def __init__(self, net_type: str = "alex") -> None:
        super().__init__()
        self.net_type = net_type
        self.trunk = _TRUNKS[net_type]()
        for i, width in enumerate(self.trunk.widths):
            self.add_module(f"lin{i}", _Conv(width, 1, 1, bias=False))
        self.register_buffer("shift", torch.tensor(_SHIFT)[None, :, None, None], persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE)[None, :, None, None], persistent=False)

    def forward(self, img1: Tensor, img2: Tensor, normalize: bool = False) -> Tensor:
        if normalize:  # [0, 1] -> [-1, 1]
            img1 = 2 * img1 - 1
            img2 = 2 * img2 - 1
        feats1 = self.trunk((img1 - self.shift) / self.scale)
        feats2 = self.trunk((img2 - self.shift) / self.scale)
        total = 0.0
        for i, (f1, f2) in enumerate(zip(feats1, feats2)):
            f1 = f1 / torch.sqrt(torch.sum(f1**2, dim=1, keepdim=True) + 1e-10)
            f2 = f2 / torch.sqrt(torch.sum(f2**2, dim=1, keepdim=True) + 1e-10)
            total = total + getattr(self, f"lin{i}")((f1 - f2) ** 2).mean(dim=(2, 3))[:, 0]
        return total


def _validate_lpips_inputs(img1: Tensor, img2: Tensor, normalize: bool) -> None:
    """Shape/layout and value-range checks shared by the module and the functional."""
    if img1.ndim != 4 or img2.ndim != 4 or img1.shape[1] != 3 or img2.shape[1] != 3:
        raise ValueError(
            f"Expected both inputs to be 4d tensors with 3 channels in the NCHW format,"
            f" but got {tuple(img1.shape)} and {tuple(img2.shape)}"
        )
    lo, hi = (0.0, 1.0) if normalize else (-1.0, 1.0)
    for img in (img1, img2):
        if bool(torch.min(img) < lo) or bool(torch.max(img) > hi):
            raise ValueError(
                f"Expected both input arguments to be normalized tensors with values in the range [{lo}, {hi}]."
                f" Found values outside this range - set `normalize=True` if inputs are in [0, 1]."
            )


def lpips_params_from_jax(variables: Mapping[str, Any], net_type: str) -> Dict[str, Tensor]:
    """The port's ``state_dict`` of the LPIPS net from the JAX package's flax
    tree (``{"params": {"trunk": {...}, "lin0": {...}, ...}}``, numpy arrays
    or anything ``np.asarray`` reads): kernels HWIO to OIHW, biases as they are."""
    if net_type not in _TRUNKS:
        raise ValueError(f"Argument `net_type` must be one of {tuple(_TRUNKS)}, but got {net_type}.")
    params = variables["params"]
    out: Dict[str, Tensor] = {}
    for prefix, tree in [("trunk.", params["trunk"])] + [("", {k: v}) for k, v in params.items() if k != "trunk"]:
        for name, leaves in tree.items():
            for leaf, value in leaves.items():
                value = np.asarray(value, np.float32)
                if leaf == "kernel":
                    value, leaf = value.transpose(3, 2, 0, 1), "weight"
                out[f"{prefix}{name}.{leaf}"] = torch.from_numpy(np.ascontiguousarray(value))
    return out


def _builtin_heads(net_type: str) -> Dict[str, Tensor]:
    """The calibrated linear heads of the port's own ``.npz`` copy, as ``lin{i}.weight`` (1, C, 1, 1)."""
    heads = {}
    with np.load(os.path.join(_WEIGHTS_DIR, f"lpips_heads_{net_type}.npz")) as data:
        for key in data.files:  # "lin{i}/kernel", (1, 1, C, 1)
            lin, _ = key.split("/")
            heads[f"{lin}.weight"] = torch.from_numpy(np.ascontiguousarray(data[key].transpose(3, 2, 0, 1)))
    return heads


def _build_net(net_type: str, net_params: Optional[Mapping[str, Any]], device: torch.device) -> _LPIPSNet:
    """The frozen LPIPS net on ``device``: ``net_params`` (a port state dict or
    JAX's flax tree), or trunks seeded 0 and the shipped heads."""
    net = _LPIPSNet(net_type)
    if net_params is None:
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for name, value in net.trunk.named_parameters():
                if name.endswith("weight"):
                    value.copy_(torch.randn(value.shape, generator=gen) * (2.0 / value[0].numel()) ** 0.5)
                else:
                    value.zero_()
        net.load_state_dict(_builtin_heads(net_type), strict=False)
    else:
        state = lpips_params_from_jax(net_params, net_type) if "params" in net_params else dict(net_params)
        net.load_state_dict(state)
    return net.requires_grad_(False).eval().to(device)


class LearnedPerceptualImagePatchSimilarity(Metric):
    """LPIPS: inputs NCHW in ``[-1, 1]`` (or ``[0, 1]`` with ``normalize=True``)."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(
        self,
        net_type: str = "alex",
        reduction: str = "mean",
        normalize: bool = False,
        net_params: Optional[Mapping[str, Any]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        valid_net_type = tuple(_TRUNKS)
        if net_type not in valid_net_type:
            raise ValueError(f"Argument `net_type` must be one of {valid_net_type}, but got {net_type}.")
        valid_reduction = ("mean", "sum")
        if reduction not in valid_reduction:
            raise ValueError(f"Argument `reduction` must be one of {valid_reduction}, but got {reduction}")
        self.reduction = reduction
        if not isinstance(normalize, bool):
            raise ValueError(f"Argument `normalize` should be a bool but got {normalize}")
        self.normalize = normalize
        self.net_type = net_type
        self.net = _build_net(net_type, net_params, self._device)

        self.add_state("sum_scores", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, img1: Tensor, img2: Tensor) -> None:
        """Fold the batch's per-pair distances."""
        img1, img2 = self._inputs(img1, img2)
        _validate_lpips_inputs(img1, img2, self.normalize)
        loss = self.net(img1.to(torch.float32), img2.to(torch.float32), self.normalize)
        self.sum_scores = self.sum_scores + loss.sum()
        self.total = self.total + loss.shape[0]

    def compute(self) -> Tensor:
        if self.reduction == "mean":
            return self.sum_scores / self.total
        return self.sum_scores


# per (net type, device): the default net of the functional
_FUNCTIONAL_NETS: Dict[Any, _LPIPSNet] = {}


def learned_perceptual_image_patch_similarity(
    img1: Tensor,
    img2: Tensor,
    net_type: str = "alex",
    reduction: str = "mean",
    normalize: bool = False,
    net_params: Optional[Mapping[str, Any]] = None,
) -> Tensor:
    """Functional LPIPS on the inputs' device (NCHW, ``[-1, 1]`` or ``[0, 1]`` with ``normalize=True``)."""
    if net_type not in _TRUNKS:
        raise ValueError(f"Argument `net_type` must be one of {tuple(_TRUNKS)}, but got {net_type}.")
    if reduction not in ("mean", "sum"):
        raise ValueError(f"Argument `reduction` must be one of ('mean', 'sum'), but got {reduction}")
    img1, img2 = _to_tensors(img1, img2)
    _validate_lpips_inputs(img1, img2, normalize)
    if net_params is None:
        key = (net_type, img1.device)
        if key not in _FUNCTIONAL_NETS:
            _FUNCTIONAL_NETS[key] = _build_net(net_type, None, img1.device)
        net = _FUNCTIONAL_NETS[key]
    else:
        net = _build_net(net_type, net_params, img1.device)
    loss = net(img1.to(torch.float32), img2.to(torch.float32), normalize)
    return loss.mean() if reduction == "mean" else loss.sum()

