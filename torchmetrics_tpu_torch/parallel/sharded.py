# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Sharded metric updates over a ``torch.distributed`` device mesh
(counterpart of ``torchmetrics_tpu/parallel/sharded.py``).

In JAX, ``sharded_update(metric, mesh, *global_batch, axis_name="data")``
runs in ONE process over a ``jax.sharding.Mesh``: it splits the batch over
the devices of the axis and merges the per-device partial states with
``psum``/``pmax``/``all_gather``. PyTorch's idiom is one process per device,
so here:

- ``mesh`` is a :class:`torch.distributed.device_mesh.DeviceMesh` and
  ``axis_name`` names one of its dims (``init_device_mesh(device_type,
  (world,), mesh_dim_names=("data",))``);
- every rank calls with its LOCAL shard of the batch;
- each rank runs the metric's ``update`` on its shard from a fresh state,
  and :func:`mesh_reduce_tree` merges the partial states over the group of
  that mesh dim, with the collective matching each state's reduction:

==============  ===============================================
dist_reduce_fx  collective over the mesh dim's group
==============  ===============================================
``"sum"``       ``all_reduce(SUM)``
``"mean"``      ``all_reduce(SUM)``, then divide by the ranks
``"max"``       ``all_reduce(MAX)``
``"min"``       ``all_reduce(MIN)``
``"merge"``     gather of every sketch leaf, then a left fold of
                the ranks' states in rank order (pairwise merge)
``"cat"``       rank-ordered gather + flatten
``None``        rank-ordered gather, stacked (list states: flattened)
custom fn       fn on the stacked gather
==============  ===============================================

- the merged state is the same on every rank, and folds into the metric
  with :func:`tree_merge`'s count-weighted rule; the first event loads it.
  The metric's states then cover every rank's shard, so its ``compute()``
  does not sync them again until ``reset()`` (the JAX regime needs no
  ``sync()`` either: its mesh lives in one process). Where sync would run
  (more than one rank), mixing plain local updates with sharded ones is
  refused in either order until ``reset()``: ``TorchMetricsUserError``.

The gathers go through
:func:`~torchmetrics_tpu_torch.utilities.distributed.gather_all_tensors`,
so ranks whose shards differ in length still merge in rank order.

Wrapper metrics (``MinMaxMetric``, ``ClasswiseWrapper``,
``MultioutputWrapper(remove_nans=False)``, ``Running``, ...) shard too, as in
the JAX package: the scratch update walks every metric reachable from the
one given (``_walk_metrics``), the merged tree carries the children's states
under ``path:name`` keys (the root's keep their plain names), and each
metric of the walk folds its part (``Running`` rotates one window slot; its
base, scratch by design, is not folded). Metrics whose update cannot run
this way (``BootStrapper``'s per-update host resampling,
``MultioutputWrapper(remove_nans=True)``) declare
``_sharded_update_unsupported`` and are refused with the JAX package's reason.

:func:`make_jit_update` builds the one-metric step ``step(state, *batch)``
over a state dict, captured once as a CUDA graph on the card and run eagerly
on the CPU; :func:`fold_jit_state` loads its final state back.

Not ported yet (ROADMAP): the compiled-step cache (``plan_cache_lookup``)
and the step's device telemetry (A12).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from torchmetrics_tpu_torch.parallel.cat_buffer import (
    CatBuffer,
    cat_buffer_init,
    cat_buffer_merge,
    cat_buffer_values,
    infer_cat_layout,
)
from torchmetrics_tpu_torch.sketch.registry import merge_states, reduce_merge_states
from torchmetrics_tpu_torch.utilities.distributed import all_reduce_, gather_all_tensors, world_size

__all__ = [
    "ShardedMetric",
    "deep_reductions",
    "deep_state_tree",
    "fold_jit_state",
    "make_jit_update",
    "make_sharded_update",
    "mesh_reduce_tree",
    "metric_merge",
    "sharded_update",
    "tree_merge",
]


# ------------------------------------------------------------------ pure merge


def metric_merge(
    reduction: Optional[str | Callable], a: Any, b: Any, weight_a: Any = 1.0, weight_b: Any = 1.0
) -> Any:
    """Pairwise-merge two state values under a declared reduction.

    ``weight_a``/``weight_b`` are the update counts behind each part, used
    to merge ``"mean"`` states as a correctly weighted average; with the
    defaults a pair of equal-weight parts averages to ``(a + b) / 2``.
    """
    if reduction == "sum":
        return a + b
    if reduction == "mean":
        return (weight_a * a + weight_b * b) / (weight_a + weight_b)
    if reduction == "max":
        return torch.maximum(a, b)
    if reduction == "min":
        return torch.minimum(a, b)
    if reduction == "merge":
        # sketch states carry their own exact pairwise merge; the weights do
        # not apply (the sketch tracks its own counts)
        return merge_states(a, b)
    if reduction == "cat":
        if isinstance(a, CatBuffer):
            return cat_buffer_merge(a, b)
        if isinstance(a, list):
            return list(a) + list(b)
        return torch.cat([torch.atleast_1d(a), torch.atleast_1d(b)])
    if reduction is None:
        if isinstance(a, list):
            return list(a) + list(b)
        return torch.stack([a, b])
    if callable(reduction):
        return reduction(torch.stack([a, b]))
    raise ValueError(f"Unknown reduction {reduction!r}")


def tree_merge(
    reductions: Dict[str, Any],
    state_a: Dict[str, Any],
    state_b: Dict[str, Any],
    weight_a: Any = 1.0,
    weight_b: Any = 1.0,
) -> Dict[str, Any]:
    """Merge two state trees keyed by per-state reductions (weights affect ``"mean"`` only)."""
    return {k: metric_merge(reductions[k], state_a[k], state_b[k], weight_a, weight_b) for k in state_a}


def _axis_group(mesh: Optional[Any], axis_name: str) -> Optional[Any]:
    """The process group of ``mesh``'s dim ``axis_name`` (the default group without a mesh)."""
    return None if mesh is None else mesh.get_group(axis_name)


_ELEMENTWISE_OPS = {"sum": "SUM", "mean": "SUM", "max": "MAX", "min": "MIN"}


def mesh_reduce_tree(
    reductions: Dict[str, Any], state: Dict[str, Any], axis_name: str = "data", *, mesh: Optional[Any] = None
) -> Dict[str, Any]:
    """Reduce every rank's partial-state tree over ``mesh``'s dim ``axis_name``.

    Every rank of that dim's group calls it with its own partial state (the
    JAX function runs inside ``shard_map`` with the axis bound; here the
    ranks are processes). Returns new tensors, the same on every rank; the
    input tree is not written. ``mesh=None`` reduces over the default group.
    Elementwise states of one collective and dtype travel together, as one
    flat ``all_reduce``: the sums are the same element by element.
    """
    group = _axis_group(mesh, axis_name)
    n = world_size(group)

    def gather(v: torch.Tensor) -> list:
        return gather_all_tensors(v, group=group)

    out: Dict[str, Any] = {}
    buckets: Dict[Tuple[str, torch.dtype], list] = {}
    for key, value in state.items():
        reduction = reductions[key]
        if isinstance(value, list) and reduction in ("cat", None):
            # rank-extend: each appended tensor gathers in rank order and flattens
            out[key] = [torch.cat([torch.atleast_1d(g) for g in gather(v)]) for v in value]
        elif reduction in _ELEMENTWISE_OPS:
            buckets.setdefault((_ELEMENTWISE_OPS[reduction], value.dtype), []).append(key)
        elif reduction == "merge":
            # every leaf gathers in rank order; the ranks' states fold left
            per_leaf = [gather(leaf) for leaf in value]
            out[key] = reduce_merge_states([type(value)(*leaves) for leaves in zip(*per_leaf)])
        elif reduction == "cat":
            out[key] = torch.cat([torch.atleast_1d(g) for g in gather(value)])
        elif reduction is None:
            out[key] = torch.stack(gather(value))
        elif callable(reduction):
            out[key] = reduction(torch.stack(gather(value)))
        else:
            raise ValueError(f"Unknown reduction {reduction!r} for state {key!r}")
    for (op, _), keys in buckets.items():
        flat = all_reduce_(torch.cat([state[k].reshape(-1) for k in keys]), getattr(dist.ReduceOp, op), group)
        for key, part in zip(keys, flat.split([state[k].numel() for k in keys])):
            part = part.view(state[key].shape)
            out[key] = part / n if reductions[key] == "mean" else part
    return {key: out[key] for key in state}


# --------------------------------------------------------------- the jit step


def make_jit_update(
    metric: Any,
    cat_capacity: Optional[int] = None,
    example_batch: Optional[Tuple[Any, ...]] = None,
    donate: bool = False,
) -> Tuple[Callable[..., Dict[str, Any]], Dict[str, Any]]:
    """Build ``(step, init_state)``: ``step(state, *batch) -> state`` folds one
    batch into a state dict (see :class:`~torchmetrics_tpu_torch.parallel.fused.JitUpdateStep`).

    The state dict holds the metric's states (sketch states as they are)
    and the update count under the reserved key ``"_update_count"``, so
    ``"mean"`` states merge as a correctly weighted running average. On the
    card the step is captured once per input signature as a CUDA graph and
    replayed (its first call runs eagerly); on the CPU it runs eagerly.

    List ("cat") states need a fixed capacity: pass ``cat_capacity`` (max
    TOTAL rows) and an ``example_batch`` (one update on it, from a reset
    state that is restored after, gives each state's row shape) and they
    become :class:`~torchmetrics_tpu_torch.parallel.cat_buffer.CatBuffer`
    states. Fold the final state back with :func:`fold_jit_state`, which
    raises if a buffer overflowed.

    ``donate=True``: the step updates the carry it returned in place, so the
    caller's old dict aliases the new state afterwards (XLA would invalidate
    the donated buffers instead); the default returns a new dict per call
    and leaves the one passed in unchanged. Device telemetry in the step
    (``"_telemetry"``) waits for ROADMAP A12.
    """
    from torchmetrics_tpu_torch.parallel.fused import JitUpdateStep

    walk = _walk_metrics(metric)
    for path, m in walk:
        reason = m._sharded_update_unsupported
        if reason:
            where = f" (at {path!r})" if path else ""
            raise ValueError(f"{type(m).__name__} does not support a traced update step{where}: {reason}")
    if len(walk) > 1:
        raise ValueError(
            f"{type(metric).__name__} wraps child metrics; make_jit_update's state pytree covers only the"
            " root registry, so the children would mistrace. Use sharded_update/make_sharded_update"
            " (deep state walk) for wrapper metrics."
        )
    list_state_keys = [k for k, v in metric._defaults.items() if isinstance(v, list)]
    if list_state_keys and cat_capacity is None:
        raise ValueError(
            f"Metric {type(metric).__name__} has list ('cat') states {list_state_keys}; jitted"
            " accumulation needs a fixed capacity — pass cat_capacity (max total rows) and an"
            " example_batch."
        )
    init_state: Dict[str, Any] = {k: v for k, v in metric._defaults.items() if k not in list_state_keys}
    if list_state_keys:
        if example_batch is None:
            raise ValueError("cat_capacity requires example_batch to infer per-state row shapes")
        layout = infer_cat_layout(metric, tuple(example_batch))
        for k in list_state_keys:
            elem, dtype = layout[k]
            init_state[k] = cat_buffer_init(cat_capacity, elem, dtype, metric.device)
    init_state["_update_count"] = torch.zeros((), dtype=torch.int32, device=metric.device)
    return JitUpdateStep(metric, list_state_keys, donate), init_state


def fold_jit_state(metric: Any, state: Dict[str, Any]) -> None:
    """Load a :func:`make_jit_update` state back into the metric: CatBuffers
    become the metric's list states (raising if one overflowed), and the
    update count is restored. The metric gets copies of the state's tensors."""
    if "_telemetry" in state:
        raise NotImplementedError("make_jit_update's device telemetry ('_telemetry') waits for ROADMAP A12")
    tree = {k: [cat_buffer_values(v)] if isinstance(v, CatBuffer) else v for k, v in state.items()}
    tree["_update_count"] = int(tree["_update_count"])
    metric.load_state_tree(tree)
    metric._computed = None


# ------------------------------------------------------------- sharded update


def _walk_metrics(metric: Any) -> List[Tuple[str, Any]]:
    """Depth-first ``[(path, metric), ...]`` over ``metric`` and every Metric
    reachable through its attributes, held directly or inside nested
    list/tuple/dict values (the JAX function without its set check: fusion
    and the sharded update only ask whether a metric has children)."""
    from torchmetrics_tpu_torch.metric import Metric

    def find(seg: str, val: Any, found: list, visiting: set) -> None:
        if isinstance(val, Metric):
            found.append((seg, val))
        elif isinstance(val, (list, tuple, dict)):
            if id(val) in visiting:  # self-referential container
                return
            visiting.add(id(val))
            items = val.items() if isinstance(val, dict) else enumerate(val)
            for k, v in items:
                find(f"{seg}[{k}]", v, found, visiting)

    seen = {id(metric)}
    out = [("", metric)]
    stack = [("", metric)]
    while stack:
        path, m = stack.pop()
        for attr, val in vars(m).items():
            found: list = []
            find(attr, val, found, set())
            for seg, child in found:
                if id(child) in seen:
                    continue
                seen.add(id(child))
                child_path = f"{path}/{seg}" if path else seg
                out.append((child_path, child))
                stack.append((child_path, child))
    return out


def _fold_targets(metric: Any) -> List[Tuple[str, Any]]:
    """The ``_walk_metrics`` entries whose states the sharded fold merges: all
    but the descendants of a wrapper with ``_sharded_fold_children = False``
    (``Running``, whose child is scratch that its update resets)."""
    walk = _walk_metrics(metric)
    no_fold = [f"{path}/" if path else "" for path, m in walk if not m._sharded_fold_children]

    def skipped(path: str) -> bool:
        return any(path != prefix.rstrip("/") and path.startswith(prefix) for prefix in no_fold)

    return [(path, m) for path, m in walk if not skipped(path)]


def _deep_key(path: str, name: str) -> str:
    """Flat key of a state: ``name`` on the root, ``path:name`` on a child."""
    return f"{path}:{name}" if path else name


def deep_reductions(metric: Any) -> Dict[str, Any]:
    """``dist_reduce_fx`` of every state of the metric and of its children."""
    return {_deep_key(p, n): r for p, m in _walk_metrics(metric) for n, r in m._reductions.items()}


def deep_state_tree(metric: Any) -> Dict[str, Any]:
    """``state_tree`` of the metric and of its children, under flat keys."""
    return {_deep_key(p, n): v for p, m in _walk_metrics(metric) for n, v in m.state_tree().items()}


def _deep_snapshot(metric: Any) -> list:
    return [
        (m, m._copy_state_dict(), m._update_count, m._computed, m._mesh_replicated,
         {a: getattr(m, a) for a in m._host_counters})
        for _, m in _walk_metrics(metric)
    ]


def _deep_restore(snapshot: list) -> None:
    for m, state, count, computed, replicated, counters in snapshot:
        m._install_state_tree(state)  # self-snapshot: trusted
        m._update_count, m._computed, m._mesh_replicated = count, computed, replicated
        for attr, val in counters.items():
            setattr(m, attr, val)


def _deep_batch_update_state(metric: Any, args: Tuple, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Run ``metric.update`` from a fresh state of the metric and of every
    child, and return the deep state tree; every metric of the walk (states,
    counts, cached values, flags and host counters) is restored after. The
    scratch update is not refused as a rank-local one."""
    snapshot = _deep_snapshot(metric)
    try:
        for _, m in _walk_metrics(metric):  # a wrapper's reset may not reach every child
            m.reset()
        metric.update(*args, **kwargs)
        return deep_state_tree(metric)
    finally:
        _deep_restore(snapshot)


def make_sharded_update(metric: Any, mesh: Any, axis_name: str = "data") -> Callable[..., Dict[str, Any]]:
    """Build ``(local_batch...) -> merged state tree``.

    The returned function runs ``metric``'s update on this rank's shard from
    a fresh state (of the metric and of every child it wraps) and reduces the
    partial states over ``mesh``'s dim ``axis_name`` (:func:`mesh_reduce_tree`):
    the result, the same on every rank, is the state one update over the
    whole batch would produce, under :func:`_deep_key` keys (a metric without
    children: its plain state names), ready for :meth:`Metric.load_state_tree`
    or :func:`tree_merge`.
    """
    for path, m in _walk_metrics(metric):
        reason = m._sharded_update_unsupported
        if reason:
            where = f" (at {path!r})" if path else ""
            raise ValueError(f"{type(m).__name__} does not support sharded_update{where}: {reason}")
    reductions = deep_reductions(metric)

    def sharded(*args: Any) -> Dict[str, Any]:
        partial = _deep_batch_update_state(metric, args, {})
        return mesh_reduce_tree(reductions, partial, axis_name, mesh=mesh)

    return sharded


def sharded_update(metric: Any, mesh: Any, *args: Any, axis_name: str = "data") -> None:
    """Execute one sharded update step and fold the result into ``metric``.

    Every rank of ``mesh``'s dim ``axis_name`` calls it with its local shard::

        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("data",))
        sharded_update(acc, mesh, local_preds, local_target)

    Afterwards every rank's metric (and every child it wraps) holds the state
    of an update over the whole batch (the JAX call takes the whole batch in
    one process and splits it over the mesh's devices).
    """
    merged = make_sharded_update(metric, mesh, axis_name=axis_name)(*args)
    targets = _fold_targets(metric)
    for _, m in targets:  # every refusal before any state moves
        m._refuse_sharded_fold(m._update_count)
    for path, m in targets:
        m._fold_sharded_state({n: merged[_deep_key(path, n)] for n in m._defaults}, m._update_count)
        m._computed = None
        m._update_count += 1


class ShardedMetric:
    """Wrap a metric so ``update``/``forward`` run sharded over a mesh dim.

    Drop-in shell: all other attribute access proxies to the wrapped metric.
    """

    def __init__(self, metric: Any, mesh: Any, axis_name: str = "data") -> None:
        object.__setattr__(self, "_metric", metric)
        object.__setattr__(self, "_mesh", mesh)
        object.__setattr__(self, "_axis_name", axis_name)

    def update(self, *args: Any) -> None:
        sharded_update(self._metric, self._mesh, *args, axis_name=self._axis_name)

    def forward(self, *args: Any) -> Any:
        """Sharded accumulate + the batch's value over every rank's shard."""
        prev_count = self._metric._update_count
        self.update(*args)
        metric = self._metric
        if prev_count > 0:
            # the batch value needs a fresh state: run the sharded step once
            # more on a reset metric (and reset children), compute, then restore
            snapshot = _deep_snapshot(metric)
            for _, m in _walk_metrics(metric):
                m.reset()
            sharded_update(metric, self._mesh, *args, axis_name=self._axis_name)
            batch_val = metric.compute()
            _deep_restore(snapshot)
            metric._computed = None
            return batch_val
        val = metric.compute()
        metric._computed = None
        return val

    def __call__(self, *args: Any) -> Any:
        return self.forward(*args)

    def compute(self) -> Any:
        return self._metric.compute()

    def reset(self) -> None:
        self._metric.reset()

    def __getattr__(self, name: str) -> Any:
        return getattr(object.__getattribute__(self, "_metric"), name)
