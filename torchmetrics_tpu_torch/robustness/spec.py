# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""State-registry specs and restore-time validation (counterpart of
``torchmetrics_tpu/robustness/spec.py``).

The fingerprint is the same SHA-256 over the same canonical JSON as the JAX
package's, with dtypes written as numpy names (``"int32"``, never
``"torch.int32"``), so a state tree written by one package validates in the
other. Mergeable sketch states (``dist_reduce_fx="merge"``) are not ported
yet and are refused.
"""
from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.utilities.exceptions import StateRestoreError

#: reductions that preserve the accumulator shape; their states must match
#: the default shape exactly. "cat"/None/custom states grow along a leading
#: axis, so only trailing dims are pinned.
_ELEMENTWISE_REDUCTIONS = ("sum", "mean", "min", "max")


class StateSpec(NamedTuple):
    """Declared contract of one metric state."""

    kind: str  # "array" | "list"
    dtype: Optional[str]  # numpy dtype name; None for list states
    shape: Optional[Tuple]  # None for list states
    reduction: str  # reduction name, "none", or the callable's qualname


def _dtype_name(dtype: Any) -> str:
    """A torch or numpy dtype by its numpy name (``torch.int32`` -> ``"int32"``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _reduction_token(reduction: Any) -> str:
    if isinstance(reduction, str):
        return reduction
    if reduction is None:
        return "none"
    return getattr(reduction, "__qualname__", getattr(reduction, "__name__", "callable"))


def build_state_specs(metric: Any) -> Dict[str, StateSpec]:
    """Per-state :class:`StateSpec` for every registered state of ``metric``."""
    specs: Dict[str, StateSpec] = {}
    for name, default in metric._defaults.items():
        token = _reduction_token(metric._reductions.get(name))
        if token == "merge":
            raise NotImplementedError(
                f"state {name!r}: mergeable sketch states are not ported yet (ROADMAP A9)"
            )
        if isinstance(default, list):
            specs[name] = StateSpec("list", None, None, token)
        else:
            specs[name] = StateSpec("array", _dtype_name(default.dtype), tuple(int(d) for d in default.shape), token)
    return specs


def spec_fingerprint(metric: Any) -> str:
    """Stable digest of the metric's class name + full state registry.

    Two metrics share a fingerprint iff a state tree of one is schema-valid
    for the other, whichever of the two packages each comes from.
    """
    specs = build_state_specs(metric)
    canon = [type(metric).__name__] + [
        [name, spec.kind, spec.dtype, list(spec.shape) if spec.shape is not None else None, spec.reduction]
        for name, spec in sorted(specs.items())
    ]
    return hashlib.sha256(json.dumps(canon, separators=(",", ":")).encode()).hexdigest()[:16]


def _shape_compatible(got: Tuple[int, ...], want: Tuple[int, ...], elementwise: bool) -> bool:
    """Default dims of size 0 are wildcards; non-elementwise states grow along
    leading axes, so only the trailing ``len(want)`` dims are pinned."""
    if elementwise:
        return len(got) == len(want) and all(w in (g, 0) for g, w in zip(got, want))
    if len(got) < len(want):
        return False
    tail = got[len(got) - len(want) :]
    return all(w in (g, 0) for g, w in zip(tail, want))


def _dtype_safe_widening(got: str, want: str) -> bool:
    try:
        return bool(np.can_cast(got, want, casting="safe"))
    except TypeError:  # bfloat16 and other names outside numpy's lattice
        return False


def validate_state_tree(metric: Any, tree: Dict[str, Any], strict: bool = True) -> Dict[str, Any]:
    """Validate ``tree`` (tensors or numpy arrays) against ``metric``'s registry.

    Returns the tree to install, every array leaf a tensor on the metric's
    device that owns its memory (a copy, never a view of the input). Never
    mutates the metric. Strict mode demands the exact key set and exact
    dtypes; non-strict mode drops unknown keys, allows missing ones and
    coerces only safe dtype widenings.
    """
    cls = type(metric).__name__
    defaults = metric._defaults
    unknown = sorted(k for k in tree if k not in defaults)
    if unknown and strict:
        raise StateRestoreError(f"Unknown metric state(s) {unknown} for {cls}: the registry declares {sorted(defaults)}")
    if strict:
        missing = sorted(k for k in defaults if k not in tree)
        if missing:
            raise StateRestoreError(
                f"Missing metric state(s) {missing} for {cls}: a strict restore must cover every registered state"
            )

    out: Dict[str, Any] = {}
    for name, value in tree.items():
        if name not in defaults:
            continue
        default = defaults[name]
        token = _reduction_token(metric._reductions.get(name))
        if isinstance(value, dict):
            # the JAX package writes a sketch state as {"__sketch__": class, "leaves": {...}}
            raise StateRestoreError(
                f"state {name!r} of {cls}: got a {'sketch payload' if '__sketch__' in value else 'dict'};"
                " mergeable sketch states are not ported yet (ROADMAP A9)"
            )
        if isinstance(default, list):
            if not isinstance(value, (list, tuple)):
                raise StateRestoreError(
                    f"state {name!r} of {cls}: expected a list ('{token}') state, got {type(value).__name__}"
                )
            out[name] = [_owned_tensor(_numeric(v, name, cls), metric.device) for v in value]
            continue
        if isinstance(value, (list, tuple)):
            raise StateRestoreError(
                f"state {name!r} of {cls}: expected an array (shape {tuple(default.shape)},"
                f" dtype {_dtype_name(default.dtype)}), got a {type(value).__name__} of {len(value)} element(s)"
            )
        value = _numeric(value, name, cls)
        got_shape = tuple(int(d) for d in value.shape)
        want_shape = tuple(int(d) for d in default.shape)
        if not _shape_compatible(got_shape, want_shape, token in _ELEMENTWISE_REDUCTIONS):
            raise StateRestoreError(
                f"state {name!r} of {cls}: expected shape {want_shape} (reduction {token!r}),"
                f" got shape {got_shape} — was this state written by a differently-configured metric?"
            )
        got_dtype, want_dtype = _dtype_name(value.dtype), _dtype_name(default.dtype)
        tensor = _owned_tensor(value, default.device)
        if got_dtype != want_dtype:
            if strict:
                raise StateRestoreError(
                    f"state {name!r} of {cls}: expected dtype {want_dtype}, got {got_dtype}"
                    " (strict restore; pass strict=False to allow safe widenings)"
                )
            if not _dtype_safe_widening(got_dtype, want_dtype):
                raise StateRestoreError(
                    f"state {name!r} of {cls}: cannot coerce dtype {got_dtype} to {want_dtype} —"
                    " only safe widenings are allowed in non-strict restore"
                )
            tensor = tensor.to(default.dtype)
        out[name] = tensor
    return out


def _numeric(value: Any, name: str, cls: str) -> Any:
    """``value`` as a tensor or a numeric numpy array; anything else (an
    object array, a string) is a corrupted leaf."""
    if isinstance(value, torch.Tensor):
        return value
    value = value if isinstance(value, np.ndarray) else np.asarray(value)
    if value.dtype.kind not in "biufc":
        raise StateRestoreError(f"state {name!r} of {cls}: expected a numeric array, got dtype {value.dtype}")
    return value


def _owned_tensor(value: Any, device: torch.device) -> torch.Tensor:
    """``value`` as a tensor on ``device`` in memory of its own.

    ``torch.as_tensor``/``torch.from_numpy`` would share the caller's numpy
    buffer, and a later write through either would change the other.
    """
    if isinstance(value, torch.Tensor):
        return value.detach().to(device, copy=True)
    return torch.tensor(np.array(value, copy=True), device=device)
