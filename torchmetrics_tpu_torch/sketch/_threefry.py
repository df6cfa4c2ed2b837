# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""JAX's threefry2x32 PRNG in torch, bit for bit: the key layout, ``split``,
``fold_in``, float32 ``uniform`` and int32 ``randint`` of ``jax.random``
under ``jax_threefry_partitionable=True`` (JAX's default).

The reservoir sketch keeps its PRNG key in its state, so a reservoir saved
by either package and resumed in the other goes on drawing the same tags.
The spec is JAX's own source: ``jax/_src/prng.py`` (``threefry_seed``,
``_threefry2x32_lowering``, ``iota_2x32_shape``, ``_threefry_split_foldlike``,
``threefry_fold_in``, ``_threefry_random_bits_partitionable``) and
``jax/_src/random.py::_uniform``.

A key is a ``(2,)`` ``uint32`` tensor. The arithmetic runs in int64 holding
32-bit values (torch's ``uint32`` has no shifts on the CPU), cut back to 32
bits after every add; rotations shift at most 26 places, which int64 holds.
"""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: Tensor, d: int) -> Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK32


def _hash(k1: Tensor, k2: Tensor, x1: Tensor, x2: Tensor) -> Tuple[Tensor, Tensor]:
    """``threefry2x32_p``: the 20-round Threefry-2x32 block of counts
    ``(x1, x2)`` under key ``(k1, k2)`` (int64 tensors of 32-bit values)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _MASK32, (x2 + ks[1]) & _MASK32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x[0], x[1]


def _words(key: Tensor) -> Tuple[Tensor, Tensor]:
    k = key.to(torch.int64)
    return k[0], k[1]


def _as_key(w1: Tensor, w2: Tensor) -> Tensor:
    return torch.stack([w1, w2]).to(torch.uint32)


def prng_key(seed: int, device: torch.device) -> Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: the seed becomes
    int32, so the high word is 0 and the low word is the seed mod 2**32."""
    return torch.tensor([0, int(seed) & _MASK32], dtype=torch.int64, device=device).to(torch.uint32)


def fold_in(key: Tensor, data: Tensor) -> Tensor:
    """``jax.random.fold_in(key, data)``: the block of counts ``(0, data)``
    (``threefry_seed`` of the 32-bit ``data``) under ``key``."""
    k1, k2 = _words(key)
    d = torch.as_tensor(data, device=key.device).to(torch.int64) & _MASK32
    w1, w2 = _hash(k1, k2, torch.zeros_like(d), d)
    return _as_key(w1, w2)


def split(key: Tensor) -> Tuple[Tensor, Tensor]:
    """``jax.random.split(key)`` (two keys), the partitionable form: counts
    ``(0, i)`` for ``i = 0, 1``, new key ``i`` is ``(bits1[i], bits2[i])``."""
    k1, k2 = _words(key)
    lo = torch.arange(2, dtype=torch.int64, device=key.device)
    b1, b2 = _hash(k1, k2, torch.zeros_like(lo), lo)
    return _as_key(b1[0], b2[0]), _as_key(b1[1], b2[1])


def _bits(key: Tensor, n: int) -> Tensor:
    """``n`` 32-bit random words of ``key`` (``bits1 ^ bits2`` of counts ``(0, i)``), int64."""
    k1, k2 = _words(key)
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = _hash(k1, k2, torch.zeros_like(lo), lo)
    return b1 ^ b2


def randint(key: Tensor, n: int, minval: int, maxval: int) -> Tensor:
    """``jax.random.randint(key, (n,), minval, maxval)`` as int32 (int32 bounds):
    two words a value from the two halves of ``split(key)``, the high word's
    remainder scaled by ``2**32 % span`` plus the low word's, modulo ``span``."""
    k1, k2 = split(key)
    higher, lower = _bits(k1, n), _bits(k2, n)
    span = (maxval - minval) & _MASK32 if maxval > minval else 1
    multiplier = ((2**16 % span) ** 2 & _MASK32) % span  # uint32 products wrap, as in JAX
    offset = (((higher % span) * multiplier) & _MASK32) + (lower % span)
    return (minval + (offset & _MASK32) % span).to(torch.int32)


def uniform(key: Tensor, n: int) -> Tensor:
    """``jax.random.uniform(key, (n,), float32)`` in ``[0, 1)``: 32 random bits
    per value (``bits1 ^ bits2`` of counts ``(0, i)``), the top 23 as the
    mantissa of a float in ``[1, 2)``, minus 1."""
    float_bits = (_bits(key, n) >> 9) | 0x3F800000
    floats = float_bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(floats, min=0.0)
