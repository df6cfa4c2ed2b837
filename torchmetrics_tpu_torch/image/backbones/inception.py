# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""InceptionV3 feature extractor, FID variant (counterpart of
``torchmetrics_tpu/image/backbones/inception.py``), NCHW.

The TF-compatible graph of the JAX package: 1008-way logits, average pools
with ``count_include_pad=False`` in the A/C/E blocks, the max-pool branch in
the last E block, and the TF1 bilinear input resize (skipped at 299 x 299,
where it is the identity). Each conv is followed by the frozen BatchNorm
folded as JAX folds it (``w = γ·rsqrt(var+ε)``, ``b = β − mean·w``, applied
as ``x*w + b``), not ``nn.BatchNorm2d``, which rounds otherwise. Modules are
named as torch-fidelity names them (``Conv2d_1a_3x3.conv.weight``,
``Mixed_5b.branch1x1.bn.running_mean``, ``fc.weight``), so a published
``pt_inception-2015-12-05`` state dict loads with ``load_state_dict``. Every
convolution runs with cuDNN's TF32 off. The tower is frozen and runs eagerly.

Weights: a JAX flax tree carries across with :func:`inception_params_from_jax`;
without weights the tower initialises from a ``torch.Generator`` seeded 0
(He-normal kernels, BatchNorm at its identity), which is not JAX's flax
init: the two packages' default scores are uncalibrated and differ.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torchmetrics_tpu_torch.functional.image.helpers import conv2d
from torchmetrics_tpu_torch.utilities.data import _to_tensor, resolve_device

Tensor = torch.Tensor

_BN_EPS = 1e-3


def tf1_bilinear_resize(x: Tensor, size: Tuple[int, int]) -> Tensor:
    """TF1 ``resize_bilinear`` with ``align_corners=False`` and without
    half-pixel centres, ``src = dst * (in/out)``, of NCHW images."""
    in_h, in_w = x.shape[2], x.shape[3]
    out_h, out_w = size

    def axis_weights(out_dim: int, in_dim: int, scale: float):
        src = torch.arange(out_dim, dtype=torch.float32, device=x.device) * scale
        lo = torch.clamp(torch.floor(src).to(torch.int64), 0, in_dim - 1)
        hi = torch.clamp(lo + 1, 0, in_dim - 1)
        frac = src - lo.to(torch.float32)
        return lo, hi, frac

    y_lo, y_hi, y_frac = axis_weights(out_h, in_h, in_h / out_h)
    x_lo, x_hi, x_frac = axis_weights(out_w, in_w, in_w / out_w)
    rows_lo, rows_hi = x[:, :, y_lo], x[:, :, y_hi]
    top = rows_lo[..., x_lo] * (1 - x_frac) + rows_lo[..., x_hi] * x_frac
    bot = rows_hi[..., x_lo] * (1 - x_frac) + rows_hi[..., x_hi] * x_frac
    return top * (1 - y_frac)[:, None] + bot * y_frac[:, None]


class _FrozenBNFold(nn.Module):
    """The affine fold of a frozen BatchNorm, under BatchNorm's names
    (``weight``, ``bias``, ``running_mean``, ``running_var``)."""

    def __init__(self, features: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features), requires_grad=False)
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)  # a torch BatchNorm's counter: not part of the fold
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def fold(self) -> Tuple[Tensor, Tensor]:
        w = self.weight * torch.rsqrt(self.running_var + _BN_EPS)
        return w, self.bias - self.running_mean * w


class BasicConv2d(nn.Module):
    """Conv (no bias) + frozen BatchNorm(eps=1e-3) + ReLU; the conv runs in ``dtype``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, int], stride: int = 1, padding=(0, 0)) -> None:
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=False)
        self.bn = _FrozenBNFold(out_ch)

    def forward(self, x: Tensor) -> Tensor:
        x = conv2d(x, self.conv.weight.to(x.dtype), stride=self.conv.stride, padding=self.conv.padding)
        w, b = self.bn.fold()
        return torch.relu(x * w.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None])


def _avg_pool_no_pad_count(x: Tensor) -> Tensor:
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=False)


def _max_pool(x: Tensor) -> Tensor:
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, (1, 1))
        self.branch5x5_1 = BasicConv2d(in_ch, 48, (1, 1))
        self.branch5x5_2 = BasicConv2d(48, 64, (5, 5), padding=(2, 2))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), padding=(1, 1))
        self.branch_pool = BasicConv2d(in_ch, pool_features, (1, 1))

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_no_pad_count(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int) -> None:
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, (3, 3), stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), stride=2)

    def forward(self, x: Tensor) -> Tensor:
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, channels_7x7: int) -> None:
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_ch, 192, (1, 1))
        self.branch7x7_1 = BasicConv2d(in_ch, c7, (1, 1))
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, (1, 1))
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, (1, 1))

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(_avg_pool_no_pad_count(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int) -> None:
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, (1, 1))
        self.branch3x3_2 = BasicConv2d(192, 320, (3, 3), stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, (1, 1))
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, (3, 3), stride=2)

    def forward(self, x: Tensor) -> Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for layer in (self.branch7x7x3_1, self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = layer(b7)
        return torch.cat([b3, b7, _max_pool(x)], dim=1)


class InceptionE(nn.Module):
    """The last blocks: ``pool_mode`` "avg" (Mixed_7b) or "max" (Mixed_7c, the FID variant)."""

    def __init__(self, in_ch: int, pool_mode: str = "avg") -> None:
        super().__init__()
        self.pool_mode = pool_mode
        self.branch1x1 = BasicConv2d(in_ch, 320, (1, 1))
        self.branch3x3_1 = BasicConv2d(in_ch, 384, (1, 1))
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(448, 384, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, (1, 1))

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = _avg_pool_no_pad_count(x) if self.pool_mode == "avg" else F.max_pool2d(x, 3, 1, padding=1)
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], dim=1)


FEATURE_TAPS = ("64", "192", "768", "2048", "logits_unbiased", "logits")


class FIDInceptionV3(nn.Module):
    """TF-compatible InceptionV3 trunk with the FID feature taps.

    ``forward`` returns the taps of ``features_list`` keyed ``"64"``,
    ``"192"``, ``"768"``, ``"2048"``, ``"logits_unbiased"``, ``"logits"``,
    each float32. ``dtype`` is the conv compute dtype (float32, or bfloat16
    when asked; the BatchNorm fold is computed in float32).
    """

    def __init__(self, features_list: Sequence[str] = ("2048",), num_classes: int = 1008, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.features_list = tuple(str(f) for f in features_list)
        self.dtype = dtype
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, (3, 3), stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, (3, 3), padding=(1, 1))
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, imgs: Tensor) -> Dict[str, Tensor]:
        """``imgs``: uint8 NCHW or NHWC, 0-255."""
        x = imgs
        if x.ndim != 4:
            raise ValueError(f"Expected 4d image batch, got shape {tuple(x.shape)}")
        if not (x.shape[1] == 3 and x.shape[-1] != 3):
            x = x.permute(0, 3, 1, 2).contiguous()  # NHWC -> NCHW, in NCHW memory (the convolutions pick their algorithm by it)
        x = x.to(torch.float32)
        if tuple(x.shape[2:]) != (299, 299):
            # at 299 x 299 the TF1 resize is the identity
            x = tf1_bilinear_resize(x, (299, 299))
        x = ((x - 128.0) / 128.0).to(self.dtype)

        wanted = set(self.features_list)
        out: Dict[str, Tensor] = {}

        def tap(name: str, value: Tensor) -> None:
            if name in wanted:
                out[name] = torch.mean(value.to(torch.float32), dim=(2, 3))

        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool(x)
        tap("64", x)
        x = _max_pool(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
        tap("192", x)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b, self.Mixed_6c,
                      self.Mixed_6d, self.Mixed_6e):
            x = block(x)
        tap("768", x)
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        pooled = torch.mean(x.to(torch.float32), dim=(2, 3))
        if "2048" in wanted:
            out["2048"] = pooled
        if "logits_unbiased" in wanted or "logits" in wanted:
            logits = F.linear(pooled, self.fc.weight, self.fc.bias)
            if "logits_unbiased" in wanted:
                out["logits_unbiased"] = logits - self.fc.bias
            if "logits" in wanted:
                out["logits"] = logits
        return out


def _he_normal_(module: nn.Module, gen: torch.Generator) -> None:
    """Conv and linear weights ~ N(0, 2/fan_in) (ReLU keeps the activations' scale), biases 0, BatchNorm at identity."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * (2.0 / fan_in) ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()


_BN_NAMES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_FC_NAMES = {"kernel": "weight", "bias": "bias"}


def inception_params_from_jax(variables: Mapping[str, Any]) -> Dict[str, Tensor]:
    """The port's ``state_dict`` of :class:`FIDInceptionV3` from the JAX
    package's flax variables (``{"params": ..., "batch_stats": ...}``, numpy
    arrays or anything ``np.asarray`` reads): conv kernels HWIO to OIHW, the
    fc kernel transposed, ``bn/{scale,bias}`` and ``batch_stats/{mean,var}``
    to the fold's four entries. JAX builds ``fc`` only for a logits tap: a
    tree without it gives a state dict without it."""
    out: Dict[str, Tensor] = {}

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + [key])
                continue
            value = np.asarray(value, np.float32)
            if path[-1] == "conv" and key == "kernel":
                value, key = value.transpose(3, 2, 0, 1), "weight"
            elif path[-1] == "bn" and key in _BN_NAMES:
                key = _BN_NAMES[key]
            elif path == ["fc"] and key in _FC_NAMES:
                value, key = (value.T if key == "kernel" else value), _FC_NAMES[key]
            else:
                raise KeyError(f"unrecognised Inception variable {'/'.join(path + [key])}")
            out[".".join(path + [key])] = torch.from_numpy(np.ascontiguousarray(value))

    walk(variables["params"], [])
    # batch_stats hold the same paths as the BatchNorm params: {block}/bn/{mean,var}
    walk(variables.get("batch_stats", {}), [])
    return out


class InceptionFeatureExtractor:
    """Callable wrapper: the frozen tower on ``device`` (the counterpart of
    JAX's jitted apply with cached params).

    ``params`` is the port's state dict (torch-fidelity names) or JAX's flax
    variables; ``None`` initialises from ``seed``. ``dtype`` is the conv
    compute dtype: ``None`` is float32, ``torch.bfloat16`` is honoured.
    """

    def __init__(
        self,
        features_list: Sequence[str] = ("2048",),
        params: Optional[Mapping[str, Any]] = None,
        seed: int = 0,
        dtype: Optional[torch.dtype] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        self.features_list = [str(f) for f in features_list]
        self.device = resolve_device(device, type(self).__name__)
        self.module = FIDInceptionV3(features_list=tuple(self.features_list), dtype=dtype or torch.float32)
        if params is None:
            gen = torch.Generator().manual_seed(seed)
            _he_normal_(self.module, gen)
        else:
            state = inception_params_from_jax(params) if "params" in params else params
            missing, unexpected = self.module.load_state_dict(state, strict=False)
            wants_fc = {"logits", "logits_unbiased"} & set(self.features_list)
            if unexpected or set(missing) - ({"fc.weight", "fc.bias"} if not wants_fc else set()):
                raise KeyError(f"Inception weights do not fit the tower: missing {missing}, unexpected {unexpected}")
        self.module.requires_grad_(False).eval().to(self.device)

    def __call__(self, imgs: Tensor) -> Union[Tensor, Tuple[Tensor, ...]]:
        with torch.no_grad():
            out = self.module(_to_tensor(imgs, self.device))
        feats = [out[f] for f in self.features_list]
        return feats[0] if len(feats) == 1 else tuple(feats)


def load_inception_weights(
    npz_path: str, features_list: Sequence[str] = ("2048",), device: Union[str, torch.device] = "cuda"
) -> InceptionFeatureExtractor:
    """An extractor from converted ``pt_inception`` weights: a ``.npz`` keyed
    by the flattened flax paths (``"Mixed_5b/branch1x1/conv/kernel"``,
    ``"Mixed_5b/branch1x1/bn/{scale,bias,mean,var}"``), JAX's layout."""
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    with np.load(npz_path) as raw:
        for flat_key in raw.files:
            *path, leaf = flat_key.split("/")
            node = batch_stats if leaf in ("mean", "var") else params
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = raw[flat_key]
    return InceptionFeatureExtractor(features_list, params={"params": params, "batch_stats": batch_stats}, device=device)
