# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""bfloat16 leaves on the host, with or without ``ml_dtypes``.

numpy has no bfloat16. The JAX package writes a bfloat16 state as an
``ml_dtypes.bfloat16`` ndarray, and reads one back the same way. The port
does the same wherever ``ml_dtypes`` imports, so its checkpoints, stores and
``/v1/state`` exports read in the JAX package and JAX's read in the port.

Where ``ml_dtypes`` is missing, a bfloat16 leaf is a :class:`Bfloat16Array`:
the raw 16-bit patterns in a ``uint16`` ndarray, behind the three attributes
the wire encoder reads (``dtype`` whose name is ``"bfloat16"``, ``shape``,
``tolist()`` giving the exact values as floats). It pickles with the port's
checkpoints and restores bit for bit, and its wire marker is the one JAX
writes, ``{"__nd__": "bfloat16", ...}``. ``ml_dtypes`` is imported at each
call, never cached, so a process that lacks it (or hides it) takes the
fallback.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

__all__ = ["BFLOAT16", "Bfloat16Array", "bfloat16_array", "bfloat16_tensor", "host_bfloat16", "is_bfloat16"]

#: the dtype name both packages write for a bfloat16 leaf
BFLOAT16 = "bfloat16"


def _ml_dtypes() -> Optional[Any]:
    try:
        import ml_dtypes
    except ImportError:
        return None
    return ml_dtypes


class _Bfloat16Dtype:
    """The ``dtype`` of a :class:`Bfloat16Array`: its name is ``"bfloat16"``."""

    name = BFLOAT16

    def __str__(self) -> str:
        return BFLOAT16

    def __repr__(self) -> str:
        return f"dtype({BFLOAT16!r})"


class Bfloat16Array:
    """A bfloat16 array held as its ``uint16`` bit patterns (no ``ml_dtypes``)."""

    dtype = _Bfloat16Dtype()

    def __init__(self, bits: np.ndarray) -> None:
        bits = np.asarray(bits, dtype=np.uint16)
        self.bits = bits if bits.flags.c_contiguous else bits.copy()  # 0-d stays 0-d

    @property
    def shape(self) -> tuple:
        return self.bits.shape

    def astype_float32(self) -> np.ndarray:
        """The values, widened exactly to float32."""
        return (self.bits.astype(np.uint32) << 16).view(np.float32)

    def tolist(self) -> Any:
        return self.astype_float32().tolist()

    def __repr__(self) -> str:
        return f"Bfloat16Array({self.astype_float32()!r})"


def is_bfloat16(value: Any) -> bool:
    """True for a host bfloat16 leaf: an ``ml_dtypes`` ndarray or a :class:`Bfloat16Array`."""
    if isinstance(value, Bfloat16Array):
        return True
    return isinstance(value, (np.ndarray, np.generic)) and value.dtype.name == BFLOAT16


def _bits(value: Any) -> np.ndarray:
    if isinstance(value, Bfloat16Array):
        return value.bits
    return np.asarray(value).view(np.uint16)


def host_bfloat16(tensor: torch.Tensor) -> Any:
    """A bfloat16 tensor as a host leaf of its own: an ``ml_dtypes`` ndarray
    where ``ml_dtypes`` imports, a :class:`Bfloat16Array` otherwise."""
    bits = tensor.detach().cpu().contiguous().view(torch.int16).numpy().view(np.uint16).copy()
    ml_dtypes = _ml_dtypes()
    if ml_dtypes is not None:
        return bits.view(ml_dtypes.bfloat16)
    return Bfloat16Array(bits)


def bfloat16_tensor(value: Any, device: Any) -> torch.Tensor:
    """A host bfloat16 leaf as a bfloat16 tensor of its own on ``device``."""
    bits = np.array(_bits(value), dtype=np.uint16, copy=True).view(np.int16)
    return torch.from_numpy(bits).view(torch.bfloat16).to(device)


def bfloat16_array(data: Any, shape: Sequence[int]) -> Any:
    """Values (nested lists of floats, as the wire carries them) as a host
    bfloat16 leaf of ``shape``: exactly ``np.asarray(data, ml_dtypes.bfloat16)``
    where ``ml_dtypes`` imports, the same bit patterns otherwise."""
    ml_dtypes = _ml_dtypes()
    if ml_dtypes is not None:
        return np.asarray(data, dtype=ml_dtypes.bfloat16).reshape(tuple(shape))
    values = torch.tensor(np.asarray(data, dtype=np.float64).reshape(tuple(shape))).to(torch.bfloat16)
    return Bfloat16Array(values.view(torch.int16).numpy().view(np.uint16))
