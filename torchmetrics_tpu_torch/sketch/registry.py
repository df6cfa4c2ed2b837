# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Registry of mergeable sketch-state types (counterpart of
``torchmetrics_tpu/sketch/registry.py``).

A *sketch state* is a fixed-shape ``NamedTuple`` of tensors, which
``torch.utils._pytree`` walks natively, together with a pure,
shape-preserving binary ``merge``. Registering the pair here is what makes a
type usable as a ``dist_reduce_fx="merge"`` metric state: the runtime
(``Metric._sync_dist``, ``Metric._reduce_states``, ``parallel.sharded``)
finds the merge through this registry, and checkpoint and spec validation
find the class back by name when deserializing.

The registry is the whole protocol: sketches never import the metric
runtime, so a new sketch type drops in with one
:func:`register_sketch_state` call.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Sequence, Tuple, Type

from torchmetrics_tpu_torch.obs import counters as _obs_counters
from torchmetrics_tpu_torch.obs import trace as _obs_trace

_MERGE_FNS: Dict[Type, Callable[[Any, Any], Any]] = {}
_BY_NAME: Dict[str, Type] = {}


def register_sketch_state(cls: Type, merge_fn: Callable[[Any, Any], Any]) -> Type:
    """Register ``cls`` (a NamedTuple of tensors) with its pairwise
    ``merge_fn``. Returns ``cls`` so it can be used as a decorator helper."""
    if not (isinstance(cls, type) and hasattr(cls, "_fields")):
        raise TypeError(f"sketch state class must be a NamedTuple type, got {cls!r}")
    _MERGE_FNS[cls] = merge_fn
    _BY_NAME[cls.__name__] = cls
    return cls


def is_sketch_state(value: Any) -> bool:
    """True when ``value`` is an instance of a registered sketch-state type."""
    return type(value) in _MERGE_FNS


def sketch_state_class(name: str) -> Type:
    """Resolve a registered sketch class by name (checkpoint deserialization)."""
    try:
        return _BY_NAME[name]
    except KeyError:
        raise KeyError(f"unknown sketch state class {name!r}; registered: {sorted(_BY_NAME)}") from None


def registered_sketch_classes() -> Tuple[Type, ...]:
    return tuple(_MERGE_FNS)


def _is_traced(state: Any) -> bool:
    """True inside a CUDA graph capture or a ``torch.func`` transform, where
    a merge runs once for many replays (the counterpart of a jax tracer):
    the host counters count only merges that run."""
    from torchmetrics_tpu_torch.utilities.checks import _is_concrete

    return not all(_is_concrete(leaf) for leaf in state)


def merge_states(a: Any, b: Any) -> Any:
    """Pairwise-merge two sketch states of the same registered type
    (shape-preserving; capturable in a CUDA graph). Counts ``sketch.merge``
    and ``sketch.merge.<Class>`` under tracing."""
    if type(a) is not type(b):
        raise TypeError(f"cannot merge sketch states of different types: {type(a).__name__} vs {type(b).__name__}")
    merge_fn = _MERGE_FNS.get(type(a))
    if merge_fn is None:
        raise TypeError(f"{type(a).__name__} is not a registered sketch state type")
    if _obs_trace.ENABLED and not _is_traced(a):
        _obs_counters.inc("sketch.merge")
        _obs_counters.inc(f"sketch.merge.{type(a).__name__}")
    return merge_fn(a, b)


def reduce_merge_states(states: Sequence[Any]) -> Any:
    """Reduce a sequence of sketch states (one per rank) by a pairwise left
    fold in order: the ``"merge"`` reduction."""
    states = list(states)
    if not states:
        raise ValueError("reduce_merge_states: empty state sequence")
    if len(states) == 1:
        return states[0]
    if _obs_trace.ENABLED and not _is_traced(states[0]):
        with _obs_trace.span("sketch.merge_reduce", kind=type(states[0]).__name__, parts=len(states)):
            return functools.reduce(merge_states, states)
    return functools.reduce(merge_states, states)


def map_leaves(fn: Callable[[Any], Any], state: Any) -> Any:
    """``state`` with ``fn`` applied to every leaf (the class is kept)."""
    return type(state)(*[fn(leaf) for leaf in state])
