# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""K7 ``window_moments``: the five windowed moments of two image stacks, and
its plain version.

Counterpart of the depthwise convolution over the five-way stacked input
``(x, y, x*x, y*y, x*y)`` at ``torchmetrics_tpu/functional/image/ssim.py``
(``_ssim_update``), which UQI, VIF and SCC compute too (MS-SSIM, D_lambda,
D_s and QNR through SSIM and UQI). The kernel is ``csrc/window_moments.cu``;
its source note gives the sums, the bound and the design. On CPU tensors
:func:`window_moments` computes :func:`window_moments_plain`; on CUDA
tensors it launches the kernel or raises.

The moments are differentiable (SSIM, MS-SSIM and UQI are): the backward is
the plain adjoint of the five sums, the transposed window over each
moment's gradient (:func:`conv_transpose2d`, TF32 off), in PyTorch.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from torchmetrics_tpu_torch.ops import _build

Tensor = torch.Tensor

_ARGTYPES = [
    ctypes.c_void_p,  # x
    ctypes.c_void_p,  # y
    ctypes.c_void_p,  # weights
    ctypes.c_void_p,  # out
    ctypes.c_longlong,  # planes
    ctypes.c_int,  # Hp
    ctypes.c_int,  # Wp
    ctypes.c_int,  # kh
    ctypes.c_int,  # kw
    ctypes.c_int,  # tile_h
    ctypes.c_void_p,  # stream
]
TILE_W = 32  # csrc/window_moments.cu kTileW: output columns a block
TILE_HEIGHTS = (8, 4, 2, 1)  # the block's rows, largest first
SMEM_MAX = 227 * 1024  # dynamic shared memory an H100 block may opt into


def halo_bytes(kh: int, kw: int, tile_h: int) -> int:
    """Shared memory a block stages: the halo of ``x`` and ``y`` around a ``tile_h`` x 32 output tile."""
    return 2 * 4 * (tile_h + kh - 1) * (TILE_W + kw - 1)


def tile_height(kh: int, kw: int) -> int:
    """The largest tile height whose halo fits the shared memory; raises if none does."""
    for tile_h in TILE_HEIGHTS:
        if halo_bytes(kh, kw, tile_h) <= SMEM_MAX:
            return tile_h
    raise ValueError(
        f"window_moments: a {kh}x{kw} window's halo needs {halo_bytes(kh, kw, TILE_HEIGHTS[-1])} bytes of shared"
        f" memory at the smallest tile (1 x {TILE_W} outputs), more than the {SMEM_MAX} a block can have"
    )


def _check(x: Tensor, y: Tensor, weight: Tensor) -> Tuple[int, int, int, int]:
    if x.ndim != 4 or x.shape != y.shape or x.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError(
            f"window_moments: expected two (B, C, Hp, Wp) float32 stacks of one shape, got {tuple(x.shape)} {x.dtype}"
            f" and {tuple(y.shape)} {y.dtype}"
        )
    if weight.ndim != 2 or weight.dtype != torch.float32:
        raise ValueError(f"window_moments: expected a (kh, kw) float32 window, got {tuple(weight.shape)} {weight.dtype}")
    kh, kw = int(weight.shape[0]), int(weight.shape[1])
    if kh < 1 or kw < 1:
        raise ValueError(f"window_moments: expected a window of at least 1x1, got {kh}x{kw}")
    hp, wp = int(x.shape[2]), int(x.shape[3])
    if hp < kh or wp < kw:
        raise ValueError(f"window_moments: a {kh}x{kw} window does not fit a {hp}x{wp} image")
    return kh, kw, hp - kh + 1, wp - kw + 1


def window_moments_plain(x: Tensor, y: Tensor, weight: Tensor) -> Tensor:
    """``(5, B, C, H, W)``: see :func:`window_moments`. The shifted slices of
    the stacked ``(x, y, x*x, y*y, x*y)`` summed tap by tap in row-major
    order, each product and sum a float32 op of its own: the kernel's order."""
    kh, kw, h, w = _check(x, y, weight)
    stacked = torch.stack([x, y, x * x, y * y, x * y])
    acc = torch.zeros((5, *x.shape[:2], h, w), dtype=torch.float32, device=x.device)
    for i in range(kh):
        for j in range(kw):
            acc = acc + weight[i, j] * stacked[..., i : i + h, j : j + w]
    return acc


def _launch(x: Tensor, y: Tensor, weight: Tensor) -> Tensor:
    kh, kw, h, w = _check(x, y, weight)
    tile_h = tile_height(kh, kw)
    if x.device.type == "cpu":
        return window_moments_plain(x, y, weight)
    if x.device.type != "cuda":
        raise ValueError(f"window_moments: input on {x.device}; expected a CUDA device or the CPU")
    x, y = x.contiguous(), y.contiguous()
    weight = weight.to(x.device).contiguous()
    out = torch.empty((5, *x.shape[:2], h, w), dtype=torch.float32, device=x.device)
    planes = int(x.shape[0] * x.shape[1])
    if planes == 0:  # nothing to filter: no launch, and none is counted
        return out
    fn = _build.function("window_moments", _ARGTYPES)
    with torch.cuda.device(x.device):
        status = fn(
            x.data_ptr(), y.data_ptr(), weight.data_ptr(), out.data_ptr(), planes, int(x.shape[2]), int(x.shape[3]),
            kh, kw, tile_h, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(status, "window_moments")
    window_moments.launches += 1
    return out


def _adjoint(grad: Tensor, weight: Tensor) -> Tensor:
    """The VALID window's transpose over ``grad`` (``(B, C, H, W)`` to ``(B, C, Hp, Wp)``)."""
    from torchmetrics_tpu_torch.functional.image.helpers import conv_transpose2d

    channels = grad.shape[1]
    kernel = weight.to(grad.dtype)[None, None].expand(channels, 1, *weight.shape)
    return conv_transpose2d(grad, kernel, groups=channels)


class _WindowMoments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, y: Tensor, weight: Tensor) -> Tensor:
        ctx.save_for_backward(x, y, weight)
        return _launch(x, y, weight)

    @staticmethod
    def backward(ctx, grad: Tensor):
        x, y, weight = ctx.saved_tensors
        g = [_adjoint(grad[k], weight) for k in range(5)]
        grad_x = g[0] + 2 * x * g[2] + y * g[4]
        grad_y = g[1] + 2 * y * g[3] + x * g[4]
        return grad_x, grad_y, None


def window_moments(x: Tensor, y: Tensor, weight: Tensor) -> Tensor:
    """``(5, B, C, H, W)`` float32: the VALID windowed sums of ``x``, ``y``,
    ``x*x``, ``y*y`` and ``x*y`` under ``weight``, ``(mu_x, mu_y, E[x²], E[y²], E[xy])``.

    ``x`` and ``y`` are ``(B, C, Hp, Wp)`` float32, already padded; ``weight``
    is a ``(kh, kw)`` float32 table (``H = Hp - kh + 1``; SSIM's and UQI's
    sides are odd, SCC's default window is 8 x 8). CUDA
    input goes through the hand kernel, CPU input through
    :func:`window_moments_plain`; the result is bitwise the same. A window
    whose halo does not fit a block's shared memory at the smallest tile is
    refused on every device (:func:`tile_height`).
    """
    return _WindowMoments.apply(x, y, weight)


window_moments.launches = 0  # launches of the CUDA kernel (the plain version is not counted)
