# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""HyperLogLog, a fixed-shape mergeable distinct-count sketch (counterpart of
``torchmetrics_tpu/sketch/hll.py``).

``m = 2**precision`` int32 registers estimate the number of DISTINCT values
folded in with relative standard error ``1.04/sqrt(m)`` (Flajolet et al.
2007). Merging two sketches of one precision is an elementwise register
``max``: the union of the two multisets, associative, commutative and
idempotent.

Values are hashed with the murmur3 finalizer (``fmix32``) as opaque 32-bit
tags (integers wrapped mod 2**32, floats bit-cast), so "distinct" means
distinct bit patterns, and every register is the JAX package's bit for bit.

**Hashing in int64.** Torch's ``uint32`` has no shifts, remainder or max on
the CPU, so tags and hashes live in int64 tensors holding values in
``[0, 2**32)``: every product is cut back to 32 bits, and a 32-bit product
is formed from 16-bit halves so no int64 product overflows. ``lax.clz`` is
an exact shift cascade. ``uint32`` serves only as a storage dtype (the
Count-Min table's keys).
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from torchmetrics_tpu_torch.sketch.registry import register_sketch_state
from torchmetrics_tpu_torch.utilities.data import _to_tensor, resolve_device

Tensor = torch.Tensor

#: precision bounds: below 4 the bias correction breaks down, above 16 the
#: register file (2**p int32) stops being "small sketch state"
MIN_PRECISION = 4
MAX_PRECISION = 16

_MASK32 = 0xFFFFFFFF


class HLLSketch(NamedTuple):
    """Registered state of the HyperLogLog sketch."""

    registers: Tensor  #: (m,) int32 max leading-zero rank seen per register
    count: Tensor  #: () int32 total values folded in (not the distinct count)


def _mul32(h: Tensor, c: int) -> Tensor:
    """``(h * c) mod 2**32`` for int64 ``h`` in ``[0, 2**32)`` and a 32-bit
    constant ``c``, with no int64 product above ``2**48``."""
    lo = (h & 0xFFFF) * c
    hi = ((h >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def _fmix32(h: Tensor) -> Tensor:
    """Murmur3 32-bit finalizer: a full-avalanche bijection on 32-bit values
    (int64 tensors in ``[0, 2**32)``)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _as_tags(x: Tensor) -> Tensor:
    """Flatten input to opaque 32-bit tags as int64 in ``[0, 2**32)``: floats
    become float32 and are bit-cast, integers wrap mod 2**32 (JAX's
    ``astype(uint32)``)."""
    x = x.reshape(-1)
    if x.dtype.is_floating_point:
        return x.to(torch.float32).view(torch.int32).to(torch.int64) & _MASK32
    return x.to(torch.int64) & _MASK32


def _tags_of(x: Union[Tensor, object], device: torch.device) -> Tensor:
    return _as_tags(_to_tensor(x, device))


def _clz32(x: Tensor) -> Tensor:
    """Leading zeros of 32-bit values (int64 in ``[0, 2**32)``), ``lax.clz``'s
    count: 32 for zero. Each step shifts a value whose top bits are zero, so
    nothing leaves the 32 bits."""
    n = torch.zeros_like(x)
    for bits, limit in ((16, 0x0000FFFF), (8, 0x00FFFFFF), (4, 0x0FFFFFFF), (2, 0x3FFFFFFF), (1, 0x7FFFFFFF)):
        small = x <= limit
        n = n + torch.where(small, bits, 0)
        x = torch.where(small, x << bits, x)
    return torch.where(x == 0, 32, n)


def hll_init(precision: int = 12, device: Union[str, torch.device] = "cuda") -> HLLSketch:
    """Empty HyperLogLog with ``2**precision`` registers on ``device``.

    The default ``precision=12`` (4096 registers, 16 KiB of int32 state) has
    ~1.6% standard error.
    """
    if not MIN_PRECISION <= precision <= MAX_PRECISION:
        raise ValueError(f"need {MIN_PRECISION} <= precision <= {MAX_PRECISION}, got {precision}")
    device = resolve_device(device, "hll_init")
    return HLLSketch(
        registers=torch.zeros((1 << precision,), dtype=torch.int32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def hll_precision(state: HLLSketch) -> int:
    """The precision, from the register file's (fixed) shape."""
    return int(state.registers.shape[0]).bit_length() - 1


def hll_update(state: HLLSketch, x: Union[Tensor, object]) -> HLLSketch:
    """Fold a batch of tags in (a scatter-max; shapes preserved)."""
    tags = _tags_of(x, state.registers.device)
    if tags.numel() == 0:
        return state
    p = hll_precision(state)
    h = _fmix32(tags)
    idx = h >> (32 - p)
    # rank = leading zeros of the remaining (32-p)-bit suffix, plus one;
    # an all-zero suffix gets the max rank 32-p+1
    suffix = (h << p) & _MASK32
    rho = torch.clamp(_clz32(suffix) + 1, max=32 - p + 1).to(torch.int32)
    registers = state.registers.scatter_reduce(0, idx, rho, reduce="amax", include_self=True)
    return HLLSketch(registers=registers, count=state.count + tags.numel())


def hll_merge(a: HLLSketch, b: HLLSketch) -> HLLSketch:
    """Union merge: elementwise register max (idempotent on shared items).
    Both sketches must share the precision."""
    if a.registers.shape != b.registers.shape:
        raise ValueError(
            f"cannot merge HLL sketches of different precision: {tuple(a.registers.shape)} vs {tuple(b.registers.shape)}"
        )
    return HLLSketch(registers=torch.maximum(a.registers, b.registers), count=a.count + b.count)


def hll_cardinality(state: HLLSketch) -> Tensor:
    """Bias-corrected estimate of the number of distinct tags folded in, in
    float32: the harmonic-mean estimate with linear counting while registers
    are empty and the 32-bit-hash saturation correction near ``2**32``."""
    m = state.registers.shape[0]
    if m >= 128:
        alpha = 0.7213 / (1.0 + 1.079 / m)
    else:
        alpha = {16: 0.673, 32: 0.697, 64: 0.709}[m]
    regs = state.registers.to(torch.float32)
    raw = alpha * m * m / torch.sum(torch.exp2(-regs))
    zeros = (state.registers == 0).sum().to(raw.dtype)
    linear = m * torch.log(m / torch.clamp(zeros, min=1.0))
    est = torch.where((raw <= 2.5 * m) & (zeros > 0), linear, raw)
    two32 = 2.0**32
    return torch.where(est > two32 / 30.0, -two32 * torch.log1p(-est / two32), est)


def hll_error_bound(state: HLLSketch) -> float:
    """Published relative standard error of :func:`hll_cardinality`:
    ``1.04 / sqrt(m)`` (~1.6% at precision 12)."""
    return 1.04 / float(state.registers.shape[0]) ** 0.5


def hll_state_bytes(precision: int = 12) -> int:
    """Fixed state footprint in bytes for a given precision."""
    return (1 << precision) * 4 + 4


register_sketch_state(HLLSketch, hll_merge)
