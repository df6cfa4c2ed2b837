# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""K5 ``biquad_cascade``: rows of samples through a cascade of biquad
stages along time, and its plain version.

Counterpart of the ``lax.scan`` of ``_biquad`` in
``torchmetrics_tpu/functional/audio/srmr.py`` (a transposed direct-form-II
biquad), which SRMR runs twice a call: the 4-stage gammatone cascade and
the 8-band modulation bank. The kernel is ``csrc/biquad.cu``; its source
note gives the step, the bound (the 16-cycle chain of a stage's step) and
the design: a block of 32 rows with a warp for each stage, a loader warp
and a storer warp, tiles of :data:`TILE` samples handed from one to the
next through rings of :data:`RING` tiles in shared memory. On CPU tensors
:func:`biquad_cascade` computes :func:`biquad_cascade_plain`; on CUDA
tensors it launches the kernel or raises.

Row ``r`` of the output filters input row ``r // group`` with coefficient
set ``r % group``: the gammatone's rows are (batch, channel) over the wave
(``group`` = channels), the modulation bank's (batch, channel, band) over
the envelope (``group`` = 8), so neither input is broadcast in memory.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from torchmetrics_tpu_torch.ops import _build

_ARGTYPES = [
    ctypes.c_void_p,  # x
    ctypes.c_void_p,  # y
    ctypes.c_void_p,  # coefs
    ctypes.c_longlong,  # rows
    ctypes.c_longlong,  # T
    ctypes.c_int,  # group
    ctypes.c_int,  # stages
    ctypes.c_void_p,  # stream
]
_STAGES = (1, 4)  # the kernel's instantiations: the modulation bank and the gammatone cascade
TILE = 64  # csrc/biquad.cu kTile: time samples a tile
RING = 4  # csrc/biquad.cu kRing: tiles a ring holds


def normalized_coefficients(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``(group, stages, 5)`` float32 ``[b0, b1, b2, a1, a2]`` of each stage:
    the numerator and the denominator divided by ``a0`` in float32, as
    ``_biquad`` divides them (``b / a[..., 0:1]``, ``a / a[..., 0:1]``)."""
    num, den = num.to(torch.float32), den.to(torch.float32)
    b = num / den[..., 0:1]
    a = den / den[..., 0:1]
    return torch.cat([b, a[..., 1:3]], dim=-1).contiguous()


def _check(x: torch.Tensor, num: torch.Tensor, den: torch.Tensor) -> Tuple[int, int]:
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"biquad_cascade: expected (rows, T) float32 input, got {tuple(x.shape)} {x.dtype}")
    if num.ndim != 3 or num.shape[-1] != 3 or den.shape != num.shape:
        raise ValueError(
            f"biquad_cascade: expected (group, stages, 3) numerators and denominators, got {tuple(num.shape)}"
            f" and {tuple(den.shape)}"
        )
    group, stages = int(num.shape[0]), int(num.shape[1])
    if group < 1 or stages not in _STAGES:
        raise ValueError(f"biquad_cascade: the kernel takes {_STAGES} stages and a group >= 1, got {stages}, {group}")
    return group, stages


def stage_steps(bx0, bx1, bx2, a1, a2, z1, z2, out) -> Tuple[torch.Tensor, torch.Tensor]:
    """One stage of the plain loop over the columns of ``bx0``, ``bx1``,
    ``bx2`` (the numerator products of its input, ``(rows, T)``) from the
    carry ``z1``, ``z2`` (``(rows,)``): ``out[:, t]`` gets ``y_t``. Returns
    the carry after the last column."""
    for t in range(bx0.shape[1]):
        y_t = bx0[:, t] + z1
        z1 = (bx1[:, t] - a1 * y_t) + z2
        z2 = bx2[:, t] - a2 * y_t
        out[:, t] = y_t
    return z1, z2


def biquad_cascade_plain(x: torch.Tensor, num: torch.Tensor, den: torch.Tensor, steps=stage_steps) -> torch.Tensor:
    """``(rows * group, T)``: each row of ``x`` through every coefficient set; see :func:`biquad_cascade`.

    The scan's step as a loop over time, one stage after another, each
    product and sum a float32 op of its own: the order of ``_biquad``'s
    step. The numerator products of the input do not depend on the carry
    and are taken for every sample at once (the same roundings). ``steps``
    walks a stage over time; a caller may give one that runs
    :func:`stage_steps`'s ops another way (``chip_smoke.py`` replays them
    from a CUDA graph), which must not change a bit of the result.
    """
    group, stages = _check(x, num, den)
    coefs = normalized_coefficients(num, den).to(x.device)
    rows, length = x.shape[0] * group, x.shape[1]
    v = x[:, None, :].expand(x.shape[0], group, length).reshape(rows, length)
    for s in range(stages):
        b0, b1, b2, a1, a2 = (coefs[:, s, k].repeat(x.shape[0]) for k in range(5))
        bx0, bx1, bx2 = b0[:, None] * v, b1[:, None] * v, b2[:, None] * v
        out = torch.empty_like(v)
        z1 = torch.zeros(rows, dtype=torch.float32, device=x.device)
        steps(bx0, bx1, bx2, a1, a2, z1, torch.zeros_like(z1), out)
        v = out
    return v


def biquad_cascade(x: torch.Tensor, num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``(rows * group, T)`` float32: row ``r`` is input row ``r // group``
    filtered by the ``stages`` biquads of coefficient set ``r % group``.

    ``x`` is (rows, T) float32; ``num`` and ``den`` are (group, stages, 3)
    numerators ``(b0, b1, b2)`` and denominators ``(a0, a1, a2)``, divided
    by ``a0`` here in float32 (on the host tensors they are given as). CUDA
    input goes through the hand kernel (1 or 4 stages), CPU input through
    :func:`biquad_cascade_plain`; the result is bitwise the same.
    """
    if x.device.type == "cpu":
        return biquad_cascade_plain(x, num, den)
    group, stages = _check(x, num, den)
    if x.device.type != "cuda":
        raise ValueError(f"biquad_cascade: input on {x.device}; expected a CUDA device or the CPU")
    x = x.contiguous()
    rows, length = x.shape[0] * group, x.shape[1]
    y = torch.empty((rows, length), dtype=torch.float32, device=x.device)
    if rows == 0 or length == 0:  # nothing to filter: no launch, and none is counted
        return y
    coefs = normalized_coefficients(num, den).to(x.device)
    fn = _build.function("biquad_cascade", _ARGTYPES, library="biquad")
    with torch.cuda.device(x.device):
        status = fn(
            x.data_ptr(), y.data_ptr(), coefs.data_ptr(), rows, length, group, stages,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(status, "biquad_cascade")
    biquad_cascade.launches += 1
    return y


biquad_cascade.launches = 0  # launches of the CUDA kernel (the plain version is not counted)
