# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Tensor manipulation helpers (counterpart of ``torchmetrics_tpu/utilities/data.py``).

The JAX package counts with ``jnp.bincount``; :func:`_bincount` here keeps
exactly its semantics (see there), which differ from ``torch.bincount``,
and unlike ``torch.bincount`` it can be captured in a CUDA graph.
"""
from __future__ import annotations

from collections import OrderedDict, defaultdict
from typing import Any, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch


def dim_zero_cat(x: Union[torch.Tensor, List[torch.Tensor], Tuple[torch.Tensor, ...]]) -> torch.Tensor:
    """Concatenate a (list of) tensor(s) along dim 0."""
    if isinstance(x, torch.Tensor):
        return x
    x = [torch.atleast_1d(t) for t in x]
    if not x:
        raise ValueError("No samples to concatenate")
    return torch.cat(x, dim=0)


def dim_zero_sum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dim=0, dtype=x.dtype)


def dim_zero_mean(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x, dim=0)


def dim_zero_max(x: torch.Tensor) -> torch.Tensor:
    return torch.max(x, dim=0).values


def dim_zero_min(x: torch.Tensor) -> torch.Tensor:
    return torch.min(x, dim=0).values


def _flatten(x: Sequence) -> list:
    """Flatten list of lists into one list."""
    return [item for sublist in x for item in sublist]


def _flatten_dict(x: Dict) -> Tuple[Dict, bool]:
    """Flatten dict of dicts into one level; report duplicate keys."""
    new_dict = {}
    duplicates = False
    for key, value in x.items():
        if isinstance(value, dict):
            for k, v in value.items():
                if k in new_dict:
                    duplicates = True
                new_dict[k] = v
        else:
            if key in new_dict:
                duplicates = True
            new_dict[key] = value
    return new_dict, duplicates


def to_onehot(label_tensor: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Integer labels ``(N, ...)`` to an int32 one-hot ``(N, C, ...)``, class dim at 1.

    ``jax.nn.one_hot``'s semantics: a label that is negative or ``>= C``
    gives a row of zeros (``torch.nn.functional.one_hot`` raises on those).
    The JAX package keeps 64-bit types off, so its one-hot is int32 whatever
    the labels' dtype.
    """
    classes = torch.arange(num_classes, device=label_tensor.device)
    onehot = (label_tensor.unsqueeze(-1) == classes).to(torch.int32)
    return torch.movedim(onehot, -1, 1)


def select_topk(prob_tensor: torch.Tensor, topk: int = 1, dim: int = 1) -> torch.Tensor:
    """Int32 mask of the top-k entries along ``dim``.

    Ties go to the lowest index, as ``jnp.argmax`` and ``jax.lax.top_k`` do:
    ``torch.argmax`` keeps the first maximum, and for ``topk > 1`` a stable
    descending sort keeps tied entries in index order.
    """
    if topk == 1:
        idx = torch.argmax(prob_tensor, dim=dim, keepdim=True)
    else:
        idx = torch.sort(prob_tensor, dim=dim, descending=True, stable=True).indices.narrow(dim, 0, topk)
    mask = torch.zeros_like(prob_tensor, dtype=torch.int32)
    return mask.scatter(dim, idx, 1)


def to_categorical(x: torch.Tensor, argmax_dim: int = 1) -> torch.Tensor:
    """Probabilities to class indices by argmax along ``argmax_dim``."""
    return torch.argmax(x, dim=argmax_dim)


def _sorted_keys(data: Dict[Any, Any]) -> List[Any]:
    try:
        return sorted(data)
    except TypeError:  # keys that do not compare keep their order
        return list(data)


def _squeeze_if_scalar(data: Any) -> Any:
    """Squeeze every one-element tensor in a (nested) result to 0-d.

    The result is rebuilt as ``jax.tree_util.tree_map`` rebuilds the JAX
    package's: a plain ``dict`` (and a ``defaultdict``) comes back with its
    keys sorted, an ``OrderedDict`` keeps its order, and so do lists, tuples
    and NamedTuples."""
    if isinstance(data, torch.Tensor):
        return data.squeeze() if data.numel() == 1 else data
    if isinstance(data, OrderedDict):
        return type(data)((k, _squeeze_if_scalar(v)) for k, v in data.items())
    if isinstance(data, defaultdict):
        return defaultdict(data.default_factory, ((k, _squeeze_if_scalar(data[k])) for k in _sorted_keys(data)))
    if isinstance(data, dict):
        return {k: _squeeze_if_scalar(data[k]) for k in _sorted_keys(data)}
    if isinstance(data, tuple) and hasattr(data, "_fields"):  # a NamedTuple (DriftScores)
        return type(data)(*[_squeeze_if_scalar(v) for v in data])
    if isinstance(data, (list, tuple)):
        return type(data)(_squeeze_if_scalar(v) for v in data)
    return data


def _device_values(values: Sequence[float], dtype: torch.dtype, device: Union[str, torch.device]) -> torch.Tensor:
    """A 1-D tensor of Python numbers made on ``device`` by fill kernels.

    ``torch.tensor(values, device=...)`` copies from pageable host memory,
    which a CUDA graph cannot capture; a fill takes its value as a kernel
    argument. The values round to ``dtype`` as ``torch.tensor`` rounds them.
    """
    return torch.stack([torch.full((), v, dtype=dtype, device=device) for v in values])


def _bincount(x: torch.Tensor, minlength: int) -> torch.Tensor:
    """``jnp.bincount(x, length=minlength)`` as int32.

    ``jnp.bincount`` is ``zeros(length).at[clip(x, 0)].add(1, mode="drop")``:
    a negative value counts in bin 0 and a value ``>= minlength`` is dropped.
    Here values are clipped to ``[0, minlength]`` and int32 ones are added
    into ``minlength + 1`` bins, the last of which takes the dropped values
    and is sliced away. The output's size is fixed by ``minlength`` alone, so
    nothing is read back to the host and a CUDA graph can capture the count
    (``torch.bincount`` on CUDA reads its input's max on the host to size its
    output). Integer adds commute, so the counts do not depend on the order
    in which the device adds them. Under ``torch.func.vmap`` (the sliced
    plan's per-row update) the add is an out-of-place ``scatter_add``, which
    ``vmap`` batches; its ``index_add`` rule would loop over the rows.
    """
    x = x.reshape(-1).clamp(min=0, max=minlength)
    counts = torch.zeros(minlength + 1, dtype=torch.int32, device=x.device)
    ones = torch.ones((), dtype=torch.int32, device=x.device).expand(x.numel())
    if torch._C._functorch.maybe_current_level() is None:
        counts.index_add_(0, x, ones)
    else:
        counts = counts.scatter_add(0, x.to(torch.int64), ones)
    return counts[:minlength]


def allclose(tensor1: torch.Tensor, tensor2: torch.Tensor, rtol: float = 1e-5, atol: float = 1e-8) -> bool:
    """Shape- and dtype-robust allclose."""
    if tuple(tensor1.shape) != tuple(tensor2.shape):
        return False
    return bool(torch.allclose(tensor1.to(torch.float32), tensor2.to(tensor1.device, torch.float32), rtol=rtol, atol=atol))


_NARROWED = {torch.float64: torch.float32, torch.int64: torch.int32}


def _jnp_dtype(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the dtype ``jnp.asarray`` gives it: float64 as float32, int64 as int32."""
    narrowed = _NARROWED.get(x.dtype)
    return x if narrowed is None else x.to(narrowed)


def _jnp_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b`` in the dtype ``jnp`` gives it, by the dtype lattice alone.

    Torch lets a 0-d operand lose to a dimensioned one of the same kind, so a
    ``(1,)`` bfloat16 state plus a 0-d float32 batch sum stays bfloat16;
    ``jnp`` widens it to float32 (a state narrowed by ``set_dtype``).
    """
    common = torch.promote_types(a.dtype, b.dtype)
    return a.to(common) + b.to(common)


def _float32_inputs(preds: torch.Tensor) -> torch.Tensor:
    """float64 predictions become float32, as ``jnp.asarray`` makes them with 64-bit types off."""
    return preds.to(torch.float32) if preds.dtype == torch.float64 else preds


def resolve_device(
    device: Union[str, torch.device], owner: str, hint: str = "Pass device='cpu' to run it on the CPU."
) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist.

    Raises rather than falling back to the CPU: a metric asked to run on the
    card that silently ran on the host would report numbers of another
    machine. ``hint`` ends the error's message: how the caller asks for the CPU.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{owner} was asked to run on {device}, but no CUDA device is available. {hint}")
    return device


def _to_tensors(preds: Any, target: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """``preds`` as a tensor (see :func:`_to_tensor`), and ``target`` as a tensor beside it."""
    preds = _to_tensor(preds)
    return preds, _to_tensor(target, preds.device)


def _to_tensor(x: Any, device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """An input as a tensor on ``device``.

    With ``device=None`` a tensor stays where it lies, and anything else
    (numpy arrays, lists, scalars) goes to the card, as a module metric's
    inputs do: without a card that raises, it never drops to the CPU. A
    caller who wants the CPU passes CPU tensors.
    """
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    if device is None:
        device = resolve_device("cuda", f"a {type(x).__name__} input", "Pass CPU tensors to run on the CPU.")
    return torch.as_tensor(np.asarray(x), device=device)
