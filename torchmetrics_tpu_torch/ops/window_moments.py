# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""K7 ``window_moments``: the five windowed moments of two image stacks
under a separable window, and its plain version.

Counterpart of the depthwise convolution over the five-way stacked input
``(x, y, x*x, y*y, x*y)`` at ``torchmetrics_tpu/functional/image/ssim.py``
(``_ssim_update``), which UQI, VIF and SCC compute too (MS-SSIM, D_lambda,
D_s and QNR through SSIM and UQI). Every window those callers build is rank
1, so the port passes it as its two 1-D factors and sums along rows, then
down columns. The kernel is ``csrc/window_moments.cu``; its source note
gives the sums, the bound and the design. On CPU tensors
:func:`window_moments` computes :func:`window_moments_plain`; on CUDA
tensors it launches the kernel or raises.

The moments are differentiable (SSIM, MS-SSIM and UQI are): the backward is
the plain adjoint of the five sums, the transposed window ``outer(col, row)``
over each moment's gradient (:func:`conv_transpose2d`, TF32 off), in PyTorch.
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
    ctypes.c_void_p,  # col
    ctypes.c_void_p,  # row
    ctypes.c_void_p,  # out
    ctypes.c_longlong,  # planes
    ctypes.c_int,  # Hp
    ctypes.c_int,  # Wp
    ctypes.c_int,  # kh
    ctypes.c_int,  # kw
    ctypes.c_int,  # tile_h
    ctypes.c_void_p,  # stream
]
TILE_W = 64  # csrc/window_moments.cu kTileW: output columns a tile
COL_RUN = 16  # csrc/window_moments.cu kColRun: outputs a thread sums down a column
TILE_HEIGHTS = (48, 32, 16, 8, 4, 2, 1)  # a tile's output rows, largest first (the kernel's instantiations)
SMEM_MAX = 227 * 1024  # dynamic shared memory an H100 block may opt into
SMEM_PAIR = 228 * 1024 // 2 - 1024  # two blocks on an SM: half its 228 KB, less the 1 KB reserved a block


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def staged_bytes(kh: int, kw: int, tile_h: int) -> int:
    """Shared memory a block stages (the kernel's ``staged_floats``): the two factors, the halo of ``x``
    and ``y`` around a ``tile_h`` x 64 output tile (rows padded to a multiple of 4 floats), the five row
    sums of the halo's rows and ``COL_RUN - 1`` rows past them (the column pass's whole register window)."""
    rows = tile_h + kh - 1
    return 4 * (_round4(kh) + _round4(kw) + 2 * rows * (TILE_W + _round4(kw)) + 5 * rows * TILE_W + (COL_RUN - 1) * TILE_W)


def tile_height(kh: int, kw: int) -> int:
    """The tile height: the largest of at least 32 rows whose staged tile lets two blocks share an SM
    (they hide each other's loads and barriers), else the largest whose staged tile fits one block;
    raises if none does."""
    for tile_h in TILE_HEIGHTS:
        if tile_h >= 32 and staged_bytes(kh, kw, tile_h) <= SMEM_PAIR:
            return tile_h
    for tile_h in TILE_HEIGHTS:
        if staged_bytes(kh, kw, tile_h) <= SMEM_MAX:
            return tile_h
    raise ValueError(
        f"window_moments: a {kh}x{kw} window's staged tile needs {staged_bytes(kh, kw, TILE_HEIGHTS[-1])} bytes of"
        f" shared memory at the smallest tile (1 x {TILE_W} outputs), more than the {SMEM_MAX} a block can have"
    )


def _check(x: Tensor, y: Tensor, col: Tensor, row: Tensor) -> Tuple[int, int, int, int]:
    if x.ndim != 4 or x.shape != y.shape or x.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError(
            f"window_moments: expected two (B, C, Hp, Wp) float32 stacks of one shape, got {tuple(x.shape)} {x.dtype}"
            f" and {tuple(y.shape)} {y.dtype}"
        )
    for name, factor in (("col", col), ("row", row)):
        if factor.ndim != 1 or factor.dtype != torch.float32 or factor.numel() < 1:
            raise ValueError(
                f"window_moments: expected a non-empty 1-D float32 {name} factor, got {tuple(factor.shape)} {factor.dtype}"
            )
    kh, kw = int(col.numel()), int(row.numel())
    hp, wp = int(x.shape[2]), int(x.shape[3])
    if hp < kh or wp < kw:
        raise ValueError(f"window_moments: a {kh}x{kw} window does not fit a {hp}x{wp} image")
    return kh, kw, hp - kh + 1, wp - kw + 1


def window_moments_plain(x: Tensor, y: Tensor, col: Tensor, row: Tensor) -> Tensor:
    """``(5, B, C, H, W)``: see :func:`window_moments`. The kernel's order as
    shifted slices of the stacked ``(x, y, x*x, y*y, x*y)``: the row pass sums
    ``row[j]`` times the slice shifted by ``j`` columns, ``j`` ascending, then
    the column pass sums ``col[i]`` times the row sums shifted by ``i`` rows,
    ``i`` ascending; each sum from 0, each product and sum a float32 op."""
    kh, kw, h, w = _check(x, y, col, row)
    col, row = col.to(x.device), row.to(x.device)
    stacked = torch.stack([x, y, x * x, y * y, x * y])
    rows = torch.zeros((5, *x.shape[:3], w), dtype=torch.float32, device=x.device)
    for j in range(kw):
        rows = rows + row[j] * stacked[..., j : j + w]
    del stacked
    acc = torch.zeros((5, *x.shape[:2], h, w), dtype=torch.float32, device=x.device)
    for i in range(kh):
        acc = acc + col[i] * rows[..., i : i + h, :]
    return acc


def _launch(x: Tensor, y: Tensor, col: Tensor, row: Tensor) -> Tensor:
    kh, kw, h, w = _check(x, y, col, row)
    tile_h = tile_height(kh, kw)
    if x.device.type == "cpu":
        return window_moments_plain(x, y, col, row)
    if x.device.type != "cuda":
        raise ValueError(f"window_moments: input on {x.device}; expected a CUDA device or the CPU")
    x, y = x.contiguous(), y.contiguous()
    col, row = col.to(x.device).contiguous(), row.to(x.device).contiguous()
    out = torch.empty((5, *x.shape[:2], h, w), dtype=torch.float32, device=x.device)
    planes = int(x.shape[0] * x.shape[1])
    if planes == 0:  # nothing to filter: no launch, and none is counted
        return out
    fn = _build.function("window_moments", _ARGTYPES)
    with torch.cuda.device(x.device):
        status = fn(
            x.data_ptr(), y.data_ptr(), col.data_ptr(), row.data_ptr(), out.data_ptr(), planes, int(x.shape[2]),
            int(x.shape[3]), kh, kw, tile_h, torch.cuda.current_stream(x.device).cuda_stream,
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
    def forward(ctx, x: Tensor, y: Tensor, col: Tensor, row: Tensor) -> Tensor:
        ctx.save_for_backward(x, y, col, row)
        return _launch(x, y, col, row)

    @staticmethod
    def backward(ctx, grad: Tensor):
        x, y, col, row = ctx.saved_tensors
        weight = torch.outer(col.to(grad.device), row.to(grad.device))
        g = [_adjoint(grad[k], weight) for k in range(5)]
        grad_x = g[0] + 2 * x * g[2] + y * g[4]
        grad_y = g[1] + 2 * y * g[3] + x * g[4]
        return grad_x, grad_y, None, None


def window_moments(x: Tensor, y: Tensor, col: Tensor, row: Tensor) -> Tensor:
    """``(5, B, C, H, W)`` float32: the VALID windowed sums of ``x``, ``y``,
    ``x*x``, ``y*y`` and ``x*y`` under the separable window ``outer(col, row)``,
    ``(mu_x, mu_y, E[x²], E[y²], E[xy])``.

    ``x`` and ``y`` are ``(B, C, Hp, Wp)`` float32, already padded; ``col``
    (``(kh,)``) and ``row`` (``(kw,)``) are the window's float32 factors: tap
    ``(i, j)`` weighs ``col[i] * row[j]`` (``H = Hp - kh + 1``; SSIM's and
    UQI's sides are odd, SCC's default window is 8 x 8). The sums run along
    rows first, then down columns (:func:`window_moments_plain`). CUDA input
    goes through the hand kernel, CPU input through the plain route; the
    result is bitwise the same. A window whose staged tile does not fit a
    block's shared memory at the smallest tile is refused on every device
    (:func:`tile_height`).
    """
    return _WindowMoments.apply(x, y, col, row)


window_moments.launches = 0  # launches of the CUDA kernel (the plain version is not counted)
